"""icar_tpu_torch — the PyTorch/CUDA port of icar_tpu for NVIDIA Hopper.

The JAX package ``icar_tpu`` stays the reference; this package runs the
same model on torch tensors and replaces each Pallas TPU kernel with a
CUDA C++ kernel written for ``sm_90a`` (``icar_tpu_torch/csrc``). Ported so
far: the ideal ridge (wind=0) with SB04 microphysics and upwind or MPDATA
advection, or Thompson microphysics and MPDATA advection, on one device or
sharded over a device mesh (``parallel/``). Everything else raises
``NotImplementedError`` naming its ROADMAP slice.

Importing the package imports torch and numpy only: no jax, no
``icar_tpu``, and no kernel build (kernels build at their first launch).
"""

__version__ = "0.1.0"

from . import constants  # noqa: E402,F401
