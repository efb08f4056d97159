"""Sample-quality diagnostics: normalized perplexity and effective sample
size.

Counterpart of :mod:`pypmc_tpu.tools.convergence` (the reference's
``pypmc/tools/convergence.py``).  A tensor is reduced on its own device;
any other array on the host, as a float64 tensor viewing it.
"""

import numpy as _np
import torch

__all__ = ["perp", "ess"]


def _normalized(weights):
    """The weights over their sum, divided by their largest first: the
    ratio form is scale-free, so weights past float32's range (e.g.
    ``exp`` of a large log weight) give no inf/NaN."""
    w = weights if isinstance(weights, torch.Tensor) else torch.from_numpy(
        _np.asarray(weights, dtype=float))
    w = w / torch.max(w)
    return w / torch.sum(w)


def perp(weights):
    r"""Normalized perplexity :math:`\mathcal{P} = \exp(H)/N` of
    (unnormalized) importance ``weights``; 0 is terrible, 1 is perfect.
    (Reference: ``convergence.py:6-39``.)  A 0-d tensor."""
    w = _normalized(weights)
    # w log w is exactly 0 where w == 0
    entr = -torch.sum(torch.special.xlogy(w, w))
    return torch.exp(entr) / len(w)


def ess(weights):
    r"""Normalized effective sample size :math:`1/(1+C^2)` [LC95] of
    (unnormalized) importance ``weights``; 0 is terrible, 1 is perfect.
    (Reference: ``convergence.py:42-72``.)  A 0-d tensor."""
    w = _normalized(weights)
    coeff_var = torch.sum((len(w) * w - 1.0) ** 2) / len(w)
    return 1.0 / (1.0 + coeff_var)
