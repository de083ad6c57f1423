"""Kain-Fritsch (conv=3) through the port's column-physics loop against
the JAX package's model, on the CPU (tests/test_torch_cu_models.py's
comparison, ``check_interval``).

The case is chip_smoke.py's CU_SMALL_KF: the small full-physics case
with its water strip, 20 levels deep, over one 1200 s interval.
FULLPHYS_SMALL itself (10 levels, its top at 3.2 km) lies below the 3 km
of cloud that KF's trigger asks above the LCL, so KF convects nowhere
there, in both packages; at 20 levels it convects within the first
substeps, and within 1200 s the NCA countdown of its first columns runs
out, so that the frozen tendencies are released and the columns checked
anew. The port's tendencies and countdown are held with the rest of the
state.
"""

import numpy as np
import pytest

from icar_tpu import constants as JC
from test_torch_cu_models import chip_smoke, check_interval, jax_reference

SECONDS = chip_smoke.FULLPHYS_SMALL_INTERVAL * chip_smoke.CU_SMALL_KF_INTERVALS


@pytest.fixture(scope="module")
def reference():
    return jax_reference(JC.CU_KF, chip_smoke.CU_SMALL_KF, SECONDS)


def test_interval_matches_the_jax_model(reference):
    """``check_interval`` on CU_SMALL_KF over 1200 s; in both packages
    the countdown is running in some columns at the end, after columns
    have triggered more than once (their rain rate re-set)."""
    got = check_interval("fullphys_kf", JC.CU_KF, chip_smoke.CU_SMALL_KF,
                         SECONDS, reference)
    for m in (got, reference[1]):
        nca = np.asarray(m["kf_nca"])
        assert (nca > 0).any() and (nca <= 0).any()
        assert float(np.asarray(m["kf_prate"]).max()) > 0
        assert float(np.abs(np.asarray(m["tend_th_cu"])).max()) > 0
