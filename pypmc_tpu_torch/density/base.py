"""Abstract base probability-density classes.

Counterpart of :mod:`pypmc_tpu.density.base` (the reference's
``pypmc/density/base.py:7-108``): the same class names and method
contracts.  All densities work on the log scale; ``evaluate`` returns
``log q(x)``.  These classes hold numpy parameters on the host; the batched
compute path of mixtures lives in :mod:`pypmc_tpu_torch.density.core`.
"""

import numpy as _np

__all__ = ["ProbabilityDensity", "LocalDensity"]


class ProbabilityDensity(object):
    """Abstract base class of a probability density; usable as a proposal
    for the importance sampler.  (Reference: ``density/base.py:7-66``.)
    """

    dim = 0

    def __init__(self):
        raise NotImplementedError(
            "abstract density class; instantiate a concrete subclass"
        )

    def evaluate(self, x):
        """Evaluate log of the density to propose ``x``, namely ``log(q(x))``."""
        raise NotImplementedError()

    def multi_evaluate(self, x, out=None):
        """Evaluate ``log(q(x))`` for each row in ``x``; write into ``out``
        if provided."""
        if out is None:
            out = _np.empty(len(x))
        else:
            assert len(out) == len(x)
        for i, point in enumerate(x):
            out[i] = self.evaluate(point)
        return out

    def propose(self, N=1, rng=None):
        """Propose ``N`` points using the numpy generator, seed or
        ``torch.Generator`` ``rng``."""
        raise NotImplementedError()


class LocalDensity(object):
    """Abstract base class for a conditional (local) probability density;
    usable as a proposal for the Markov-chain sampler.
    (Reference: ``density/base.py:68-108``.)
    """

    dim = 0
    symmetric = False

    def __init__(self):
        raise NotImplementedError(
            "abstract density class; instantiate a concrete subclass"
        )

    def evaluate(self, x, y):
        """Evaluate log of the density to propose ``x`` given ``y``:
        ``log(q(x|y))``."""
        raise NotImplementedError()

    def propose(self, y, rng=None):
        """Propose a new point given ``y``."""
        raise NotImplementedError()
