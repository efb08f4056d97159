"""pypmc_tpu_torch -- the PyTorch + CUDA port of pypmc_tpu.

The module tree mirrors :mod:`pypmc_tpu`, and each ported public name
keeps its name, arguments and return layout, with torch tensors for jax
arrays and an int seed or a ``torch.Generator`` for a PRNG key.  Ported so
far: the PMC main path -- ``density.core``, the functional core of
``mix_adapt.pmc`` and ``parallel.sampler.pmc_run_sharded`` for one process
on one device -- and variational Bayes -- ``mix_adapt.variational`` with
the host density classes of ``density`` -- with their seven CUDA kernels in
``ops.kernels``.  The package imports no JAX and builds its kernels only
when a CUDA tensor first reaches one.
"""

from . import density, mix_adapt, ops, parallel

__version__ = "0.1.0"
