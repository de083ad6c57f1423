"""The interval profiler (icar_tpu_torch/profile_interval.py) runs end to
end on the CPU at a small size: one JSON line, no device time."""

import json

import pytest
import torch

from icar_tpu_torch import profile_interval

torch.set_num_threads(1)


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


def test_profile_interval_linear_path_on_cpu(capsys, monkeypatch):
    """The linear path (bench.py's table) profiles a wind update with its
    interval: the update runs before each of the two intervals."""
    from icar_tpu_torch.models.icar import ICARModel
    calls = []
    update = ICARModel.update_winds
    monkeypatch.setattr(ICARModel, "update_winds",
                        lambda self, timer=None: calls.append(1) or
                        update(self, timer))
    times = profile_interval.main(["--path", "linear", "--nx", "24", "--ny",
                                   "8", "--nz", "20", "--interval", "300",
                                   "--device", "cpu"])
    assert times == {} and len(calls) == 2
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["path"] == "linear" and out["substeps"] > 0


def test_profile_interval_on_a_cpu_mesh(capsys):
    """--mesh 2x2 profiles a sharded interval (one interval of every
    block's work) on the CPU at a small size: one JSON line naming the
    mesh, no device time."""
    times = profile_interval.main(["--path", "upwind", "--mesh", "2x2",
                                   "--nx", "24", "--ny", "8", "--nz", "12",
                                   "--interval", "60", "--device", "cpu"])
    assert times == {}
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["mesh"] == "2x2" and out["substeps"] > 0
    assert out["device_idle_share"] is None
