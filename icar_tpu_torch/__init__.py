"""icar_tpu_torch — the PyTorch/CUDA port of icar_tpu for NVIDIA Hopper.

The JAX package ``icar_tpu`` stays the reference; this package runs the
same model on torch tensors and replaces each Pallas TPU kernel with a
CUDA C++ kernel written for ``sm_90a`` (``icar_tpu_torch/csrc``). Ported so
far: the ideal-ridge main path (SB04 microphysics + donor-cell upwind
advection, wind=0). Everything else raises ``NotImplementedError`` naming
its ROADMAP slice.

Importing the package imports torch and numpy only: no jax, no
``icar_tpu``, and no kernel build (kernels build at their first launch).
"""

__version__ = "0.1.0"

from . import constants  # noqa: E402,F401
