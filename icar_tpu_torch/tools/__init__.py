"""User tooling of the port: the counterparts of the JAX package's
pre- and post-processing tools under ``tools/``, with their file names,
arguments and outputs, each run as ``python -m icar_tpu_torch.tools.<name>``.

They import numpy, scipy, the standard library and the port's own modules
(matplotlib for ``plot_icar``), never jax or the JAX package, so they run
where the port runs. Every file is read through ``io/netcdf.NCFile``, in
the format its first bytes name, and written through it: NetCDF-4 where
h5py imports, CDF-2 where it does not.
"""
