"""Morrison (mp=3) on the JAX package's ridge with upwind advection and
with MPDATA, through the port's model against the JAX package's model on
the CPU, as tests/test_torch_mp_models.py holds WSM3 and WSM6
(``jax_reference``, ``check_interval``): a file of its own, so that the
two JAX op-by-op runs take another test worker.
"""

import pytest
import torch

from tests.test_torch_mp_models import check_interval, jax_reference

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=("morrison", "morrison_mpdata"))
def jax_case(request):
    return request.param, jax_reference(request.param)


def test_interval_matches_the_jax_model(jax_case):
    """Morrison with upwind advection and with MPDATA (K4's plain
    version on its 11 species): ``check_interval``."""
    check_interval(*jax_case)
