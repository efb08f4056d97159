"""Exact chi-square sampling in log space.

Counterpart of :mod:`pypmc_tpu.ops.random` and the plain version of the
chi-square that the propose kernels draw in-kernel
(``csrc/common.cuh``, ``log_chi2``): Marsaglia-Tsang with the shape boost
``Gamma(a) = Gamma(a+1) * U^(1/a)`` applied unconditionally and in log
space, so tiny degrees of freedom neither under- nor overflow.  Rejected
elements are redrawn until every element has accepted (each round accepts
at least 95%).
"""

import math

import torch

from .._rng import device_generator, seed_words

__all__ = ["chi2_log", "chisquare", "student_t_scale"]

# A round accepts with probability >= 0.951 for every shape the boost
# produces, so 100 rounds are exhausted with probability <= 0.049^100; the
# cap only stops a non-finite ``df`` from looping forever.
_MAX_ROUNDS = 100


def _uniform_open0(shape, gen, dtype, device):
    """Uniform draws in (0, 1] (safe for log)."""
    return 1.0 - torch.rand(shape, generator=gen, dtype=dtype, device=device)


def _generator_on(rng, device):
    if isinstance(rng, torch.Generator) and rng.device == torch.device(device):
        return rng
    return device_generator(seed_words(rng), device)


def chi2_log(key, df, shape):
    """``log`` of exact chi-square draws with (per-element) degrees of
    freedom ``df`` (broadcast to ``shape``).  ``key`` is a generator on
    ``df``'s device, or anything :func:`pypmc_tpu_torch._rng.as_generator`
    takes."""
    df = torch.as_tensor(df)
    if not df.is_floating_point():
        df = df.to(torch.get_default_dtype())
    dtype, device = df.dtype, df.device
    gen = _generator_on(key, device)
    df = torch.broadcast_to(df, shape).reshape(-1)
    a = 0.5 * df
    d = a + 1.0 - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)

    log_g = torch.log(d)      # near-mode value, kept only past the cap
    pending = torch.arange(df.numel(), device=device)
    for _ in range(_MAX_ROUNDS):
        if pending.numel() == 0:
            break
        dp, cp = d[pending], c[pending]
        z = torch.randn(pending.shape, generator=gen, dtype=dtype, device=device)
        u = _uniform_open0(pending.shape, gen, dtype, device)
        one_plus_cz = 1.0 + cp * z
        ok_v = one_plus_cz > 0
        log_v = 3.0 * torch.log(torch.where(ok_v, one_plus_cz,
                                            torch.ones_like(one_plus_cz)))
        # margin d*(1 - v + log v) written as d*(log_v - expm1(log_v)):
        # the naive d - d*v + d*log_v cancels catastrophically for large d
        accept = ok_v & (torch.log(u) < 0.5 * z * z + dp * (log_v - torch.expm1(log_v)))
        log_g[pending[accept]] = (torch.log(dp) + log_v)[accept]
        pending = pending[~accept]

    u = _uniform_open0(df.shape, gen, dtype, device)
    return (math.log(2.0) + log_g + torch.log(u) / a).reshape(shape)


def chisquare(key, df, shape):
    """Exact chi-square draws (linear scale); see :func:`chi2_log`."""
    return torch.exp(chi2_log(key, df, shape))


def student_t_scale(key, dof, shape):
    """Per-particle Student-t proposal scale ``sqrt(dof / chi2(dof))``
    computed in log space (stable for dof down to ~1e-5)."""
    log_chi2 = chi2_log(key, dof, shape)
    dof = torch.broadcast_to(torch.as_tensor(dof, dtype=log_chi2.dtype,
                                             device=log_chi2.device), shape)
    return torch.exp(0.5 * (torch.log(dof) - log_chi2))
