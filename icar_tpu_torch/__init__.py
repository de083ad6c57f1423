"""icar_tpu_torch — the PyTorch/CUDA port of icar_tpu for NVIDIA Hopper.

The JAX package ``icar_tpu`` stays the reference; this package runs the
same model on torch tensors and replaces each Pallas TPU kernel with a
CUDA C++ kernel written for ``sm_90a`` (``icar_tpu_torch/csrc``). It runs
everything the JAX package runs: the ideal ridge with every scheme option
and wind solver (``models/``), the file-driven run, ``python -m
icar_tpu_torch options.nml`` (``core/driver.py``: forcing ingest and
regridding on the device, NetCDF output and restarts, ``io/``), and each
of them sharded over a device mesh (``parallel/``; a mesh may put several
shards on one card), with output and restarts per shard as the JAX
package writes them.

Importing the package imports torch and numpy only: no jax, no
``icar_tpu``, and no kernel build (kernels build at their first launch).
"""

__version__ = "0.1.0"

from . import constants  # noqa: E402,F401
