"""Weighted log-sum-exp and regularization.

Counterpart of :mod:`pypmc_tpu.ops.lse` (the reference's
``pypmc/tools/_regularize.pyx``) on torch tensors.
"""

import torch

__all__ = ["regularize", "logsumexp", "logsumexp2D", "tiny"]


def tiny(dtype) -> float:
    """Smallest positive normal float of ``dtype``."""
    return float(torch.finfo(dtype).tiny)


def regularize(x):
    """Replace exact zeros by the smallest positive float; does NOT mutate
    its input."""
    return torch.where(x == 0, torch.full_like(x, tiny(x.dtype)), x)


def logsumexp(a, weights, axis=-1):
    r"""Weighted log-sum-exp :math:`\log \sum_i w_i e^{a_i}` over ``axis``.

    Max-shifted for stability.  Entries with ``a = -inf`` contribute zero;
    if *all* entries along ``axis`` are ``-inf`` the result is ``-inf``.
    """
    max_val = torch.amax(a, dim=axis, keepdim=True)
    safe_max = torch.where(torch.isfinite(max_val), max_val,
                           torch.zeros_like(max_val))
    s = torch.sum(weights * torch.exp(a - safe_max), dim=axis)
    return torch.log(s) + safe_max.squeeze(axis)


def logsumexp2D(a, weights):
    """Row-wise weighted log-sum-exp of an ``(N, K)`` matrix."""
    return logsumexp(a, weights, axis=-1)
