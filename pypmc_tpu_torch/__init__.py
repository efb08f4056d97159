"""pypmc_tpu_torch -- the PyTorch + CUDA port of pypmc_tpu.

The module tree mirrors :mod:`pypmc_tpu`, and each ported public name
keeps its name, arguments and return layout, with torch tensors for jax
arrays and an int seed or a ``torch.Generator`` for a PRNG key.  Every
module is ported: the one-call evidence pipeline ``pipeline.integrate``
with everything it runs -- the adaptive-MCMC chain pool and the importance
sampler (``sampler``), Gelman-Rubin grouping, PMC, variational Bayes and
the hierarchical reduction (``mix_adapt``), the host density classes and
the stacked-parameter core (``density``), ``tools`` (plotting included)
and ``checkpoint`` -- the parallel layer (``parallel``: a particle mesh of
``torch.distributed`` ranks, ``ParallelSampler``, ``pmc_run_sharded``)
and ``profiling``, with their thirteen CUDA kernels in ``ops.kernels``,
the K-blocked ones for mixtures of hundreds of components among them.

Entry points run on the CUDA device unless the CPU is asked for
(:func:`set_default_device`, :func:`using_device` or ``device="cpu"``;
see :mod:`pypmc_tpu_torch._device`).  The package imports no JAX and
builds its kernels only when a CUDA tensor first reaches one.
"""

from ._device import default_device, set_default_device, using_device, working_dtype
from . import (checkpoint, density, mix_adapt, ops, parallel, pipeline, profiling, sampler,
               tools)

__version__ = "0.1.0"
