"""icar_tpu_torch — the PyTorch/CUDA port of icar_tpu for NVIDIA Hopper.

The JAX package ``icar_tpu`` stays the reference; this package runs the
same model on torch tensors and replaces each Pallas TPU kernel with a
CUDA C++ kernel written for ``sm_90a`` (``icar_tpu_torch/csrc``). Ported so
far: the ideal ridge with SB04 or Thompson microphysics and upwind or
MPDATA advection, the full-physics column (with Thompson and upwind) and
every wind solver, on one device, and the ridges sharded over a device
mesh (``parallel/``); and the file-driven run, ``python -m icar_tpu_torch
options.nml`` (``core/driver.py``: forcing ingest and regridding on the
device, NetCDF output and restarts, ``io/``), on one device. Everything
else raises ``NotImplementedError`` naming its ROADMAP slice.

Importing the package imports torch and numpy only: no jax, no
``icar_tpu``, and no kernel build (kernels build at their first launch).
"""

__version__ = "0.1.0"

from . import constants  # noqa: E402,F401
