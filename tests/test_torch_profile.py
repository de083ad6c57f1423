"""The interval profiler (icar_tpu_torch/profile_interval.py) runs end to
end on the CPU at a small size: one JSON line, no device time."""

import json

import pytest

from icar_tpu_torch import profile_interval


@pytest.mark.parametrize("adv", ["upwind", "mpdata"])
def test_profile_interval_on_cpu(adv, capsys):
    times = profile_interval.main(["--adv", adv, "--nx", "24", "--ny", "8",
                                   "--nz", "20", "--interval", "300",
                                   "--device", "cpu"])
    assert times == {}
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["adv"] == adv and out["device"] == "cpu"
    assert out["substeps"] > 0 and out["wall_ms"] > 0
    assert out["device_ms"] == 0 and out["device_idle_share"] is None


def test_profile_interval_thompson_on_cpu(capsys):
    times = profile_interval.main(["--adv", "mpdata", "--mp", "thompson",
                                   "--nx", "24", "--ny", "8", "--nz", "12",
                                   "--interval", "300", "--device", "cpu"])
    assert times == {}
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["mp"] == "thompson" and out["substeps"] > 0
