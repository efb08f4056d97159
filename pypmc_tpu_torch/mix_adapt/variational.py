"""Variational-Bayes Gaussian-mixture inference ([Bis06] ch. 10.2).

Counterpart of :mod:`pypmc_tpu.mix_adapt.variational` (the reference's
``pypmc/mix_adapt/variational.pyx``), with the same names and return
layouts.  The E-step over the data runs in one pass through kernel
``fused_vb_estep`` (CUDA float32; its plain version on the CPU) wherever
the mixture fits the kernel (:func:`~pypmc_tpu_torch.ops.kernels.fits`)
and there are at least 1024 points, as in the JAX package, through
``fused_vb_estep_blocked`` where the JAX package elects its K-blocked
E-step, and as tensor code over the ``(N, K)`` responsibilities
otherwise; the
responsibilities themselves (:attr:`GaussianInference.r`) are formed only
when asked for.  The M-step and the bound are tensor code over the K
components.

The data stays in its dtype on its device, kept once, transposed ``(D,
N)``; the weights in the same dtype.  The hyperparameters are float64
tensors on the data's device: the kernel takes float32 copies of its
operands and returns float64 statistics, so the small K-sized algebra and
the bound are float64 whatever the data.  A float32 fit keeps the kernel's
operands from one E-step to the next while they move by less than one
float32 spacing (:func:`_held_operands`), so that its iteration reaches a
fixed point and ``run`` stops.

:class:`VBMerge` implements the [BGP10] mixture-compression variant, where
the "samples" are the L input components with virtual sample counts
``N * omega_l``.
"""

import logging
import math
from typing import NamedTuple, Optional

import numpy as _np
import torch
from scipy.special import digamma as _digamma_host
from scipy.special import gammaln as _gammaln_host

from .. import _device
from ..density import core as _core
from ..density.gauss import Gauss, chol_inv_det_host
from ..density.mixture import MixtureDensity
from ..density.mixture import recover_gaussian_mixture as _unroll
from ..ops import kernels as _k
from ..ops.linalg import chol_inv_det, symmetrize
from ..ops.lse import regularize, tiny

logger = logging.getLogger(__name__)

__all__ = [
    "GaussianInference",
    "VBMerge",
    "Wishart_log_B",
    "Wishart_expect_log_lambda",
    "Wishart_H",
    "Dirichlet_log_C",
]

_LOG_2PI = math.log(2.0 * math.pi)


def _host(v):
    """A float64 numpy copy of a tensor (on any device) or array-like."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float64).numpy()
    return _np.asarray(v, dtype=float)


# --------------------------------------------------------------------- #
# Wishart / Dirichlet helpers (vectorized over K; host-scalar API too)  #
# --------------------------------------------------------------------- #

def _wishart_log_B(D, nu, log_det):
    """(B.79) of [Bis06] on the log scale; ``nu``/``log_det`` tensors."""
    i = torch.arange(1, D + 1, dtype=nu.dtype, device=nu.device)
    gamma_terms = torch.special.gammaln(0.5 * (nu[..., None] + 1.0 - i)).sum(-1)
    return (-0.5 * nu * log_det - 0.5 * nu * D * math.log(2.0)
            - 0.25 * D * (D - 1) * math.log(math.pi) - gamma_terms)


def _wishart_expect_log_lambda(D, nu, log_det):
    """(B.81) of [Bis06]: ``E[log |Lambda|]``; vectorized."""
    i = torch.arange(1, D + 1, dtype=nu.dtype, device=nu.device)
    return (torch.special.digamma(0.5 * (nu[..., None] + 1.0 - i)).sum(-1)
            + D * math.log(2.0) + log_det)


def _wishart_H(D, nu, log_det):
    """(B.82) of [Bis06]: Wishart entropy; vectorized."""
    log_B = _wishart_log_B(D, nu, log_det)
    expect = _wishart_expect_log_lambda(D, nu, log_det)
    return -log_B - 0.5 * (nu - D - 1) * expect + 0.5 * nu * D


def _dirichlet_log_C(alpha):
    """(B.23) of [Bis06]: Dirichlet normalization on the log scale."""
    return torch.special.gammaln(alpha.sum()) - torch.special.gammaln(alpha).sum()


def Wishart_log_B(D, nu, log_det):
    """First part of a Wishart normalization, (B.79) of [Bis06], log scale.
    (Reference: ``variational.pyx:1220-1247``.)"""
    assert D > 0, "dimension must be positive, got %s" % D
    assert nu > D - 1, "Wishart dof must exceed D-1, got %s" % nu
    assert _np.isfinite(log_det), "log-determinant is not finite: %s" % log_det
    log_B = -0.5 * nu * log_det - 0.5 * nu * D * _np.log(2) - 0.25 * D * (D - 1) * _np.log(_np.pi)
    for i in range(1, D + 1):
        log_B -= _gammaln_host(0.5 * (nu + 1 - i))
    return log_B


def Wishart_expect_log_lambda(D, nu, log_det):
    r""":math:`E[\log |\Lambda|]`, (B.81) of [Bis06].
    (Reference: ``variational.pyx:1249-1258``.)"""
    assert D > 0, "dimension must be positive, got %s" % D
    assert nu > D - 1, "Wishart dof must exceed D-1, got %s" % nu
    assert _np.isfinite(log_det), "log-determinant is not finite: %s" % log_det
    result = 0.0
    for i in range(1, D + 1):
        result += _digamma_host(0.5 * (nu + 1 - i))
    return result + D * _np.log(2.0) + log_det


def Wishart_H(D, nu, log_det):
    """Entropy of the Wishart distribution, (B.82) of [Bis06].
    (Reference: ``variational.pyx:1260-1267``.)"""
    log_B = Wishart_log_B(D, nu, log_det)
    expect = Wishart_expect_log_lambda(D, nu, log_det)
    return -log_B - 0.5 * (nu - D - 1) * expect + 0.5 * nu * D


def Dirichlet_log_C(alpha):
    """Normalization constant of a Dirichlet distribution, log scale,
    (B.23) of [Bis06].  (Reference: ``variational.pyx:1269-1280``.)"""
    log_C = _gammaln_host(_np.sum(alpha))
    for alpha_k in alpha:
        log_C -= _gammaln_host(alpha_k)
    return log_C


# --------------------------------------------------------------------- #
# E-step / M-step / bound                                               #
# --------------------------------------------------------------------- #

def _identity(x):
    return x


def _bilinear_with_W(x, m, W):
    """``(N, K)`` bilinear forms ``(x_n - m_k)^T W_k (x_n - m_k)`` in
    ``x``'s dtype, as ``|C_k^T (x_n - m_k)|^2`` with ``W_k = C_k C_k^T``:
    kernel ``fused_maha`` with the upper-triangular ``C_k^T`` as its general
    matrix, or one ``(D, N)`` product per component where the size gate
    refuses the mixture."""
    chol_W = torch.linalg.cholesky(W)
    return _core._projected_sq_norms_T(x.T, chol_W.transpose(1, 2), m).T


def _weighted_S(data, wr, x_mean, inv_N_comp, reduce=_identity):
    """``(K, D, D)`` scaled scatter matrices
    ``S_k = inv_N_k * sum_n wr_nk (x_n - xbar_k)(x_n - xbar_k)^T``
    (10.53), the sums over particles through ``reduce``; one component at a
    time, so no (N, K, D) intermediate."""
    sums = torch.stack([torch.einsum("n,ni,nj->ij", wr_k, data - mean_k, data - mean_k)
                        for wr_k, mean_k in zip(wr.T, x_mean)])
    return reduce(sums) * inv_N_comp[:, None, None]


class _EStepOut(NamedTuple):
    expectation_det_ln_lambda: torch.Tensor  # (K,)
    expectation_gauss_exponent: Optional[torch.Tensor]  # (N, K); None on the fused path
    expectation_ln_pi: torch.Tensor  # (K,)
    log_rho: Optional[torch.Tensor]  # (N, K) normalized log responsibilities; fused: None
    r: Optional[torch.Tensor]  # (N, K); None on the fused path
    N_comp: torch.Tensor  # (K,)
    inv_N_comp: torch.Tensor  # (K,)
    x_mean_comp: torch.Tensor  # (K, D)
    S: torch.Tensor  # (K, D, D)
    log_q_Z: Optional[torch.Tensor] = None  # scalar (10.75); set only by the fused path
    operands: Optional[tuple] = None  # (A, m, const) the one-pass kernel took; fused path only


def _normalize_log_rho(log_rho, dtype):
    """Max-shifted softmax of the responsibility logits (Bishop 10.49):
    returns ``(r, normalized log_rho)`` with exact zeros of ``r`` clamped
    to the dtype's tiny (the reference's regularization,
    ``variational.pyx:752-755``).  Shared by the GaussianInference and
    VBMerge E-steps."""
    shifted = log_rho - torch.amax(log_rho, dim=1, keepdim=True)
    r = torch.exp(shifted)
    norm = torch.sum(r, dim=1, keepdim=True)
    r = r / norm
    log_rho = shifted - torch.log(norm)
    r = torch.where(r == 0.0, torch.full_like(r, tiny(dtype)), r)
    return r, log_rho


def _vb_e_step(data, weights, alpha, beta, nu, m, W, log_det_W, reduce=None):
    """Standard VB-GMM E-step (10.64-10.66, 10.46/10.49, 10.51-10.53) over
    row-major ``data (N, D)``, in the hyperparameters' dtype.

    With ``reduce`` (the sum over a particle mesh's ranks; ``data`` is this
    rank's shard) the statistics and the bound's term (10.75) are summed
    over the ranks, and the shard's (N, K) fields are left out (None), as
    on the one-pass path."""
    N, D = data.shape
    dtype = alpha.dtype

    e_lnlam = _wishart_expect_log_lambda(D, nu, log_det_W)
    e_gauss = D / beta[None, :] + nu[None, :] * _bilinear_with_W(data, m, W).to(dtype)
    e_lnpi = torch.special.digamma(alpha) - torch.special.digamma(alpha.sum())

    # (10.46)
    log_rho = e_lnpi[None, :] + 0.5 * (e_lnlam[None, :] - D * _LOG_2PI - e_gauss)
    # (10.49): max-shifted softmax; store normalized log_rho, clamp r zeros
    r, log_rho = _normalize_log_rho(log_rho, dtype)

    data = data.to(dtype)
    wr = weights.to(dtype)[:, None] * r
    red = _identity if reduce is None else reduce
    N_comp = red(wr.sum(0))  # (10.51)
    inv_N_comp = 1.0 / regularize(N_comp)
    x_mean = red(wr.T @ data) * inv_N_comp[:, None]  # (10.52)
    S = _weighted_S(data, wr, x_mean, inv_N_comp, red)  # (10.53)

    if reduce is None:
        return _EStepOut(e_lnlam, e_gauss, e_lnpi, log_rho, r, N_comp, inv_N_comp, x_mean, S)
    log_q_Z = reduce(torch.einsum("n,nk,nk->", weights.to(dtype), r, log_rho))
    return _EStepOut(e_lnlam, None, e_lnpi, None, None, N_comp, inv_N_comp, x_mean, S,
                     log_q_Z)


def _vb_whitening(D, alpha, beta, nu, m, W, log_det_W):
    """The operands of the one-pass E-step: ``(E[ln |Lambda|] (K,),
    E[ln pi] (K,), A (K, D, D), const (K,))`` with the upper-triangular
    ``A_k = sqrt(nu_k) chol(W_k)^T``, so that ``|A_k (x - m_k)|^2`` is the
    Gauss-exponent quadratic ``nu_k (x - m_k)^T W_k (x - m_k)`` of (10.64),
    and ``const_k`` the rest of the softmax argument (10.46)."""
    e_lnlam = _wishart_expect_log_lambda(D, nu, log_det_W)
    e_lnpi = torch.special.digamma(alpha) - torch.special.digamma(alpha.sum())
    A = torch.sqrt(nu)[:, None, None] * torch.linalg.cholesky(W).transpose(1, 2)
    const = e_lnpi + 0.5 * (e_lnlam - D * _LOG_2PI) - 0.5 * D / beta
    return e_lnlam, e_lnpi, A, const


def _spacing(v, dtype):
    """The spacing of ``dtype``'s numbers at ``|v|``, in ``v``'s dtype."""
    a = v.abs().to(dtype)
    return (torch.nextafter(a, torch.full_like(a, math.inf)) - a).to(v.dtype)


def _held_operands(operands, scales, held, dtype):
    """The one-pass E-step's ``operands`` ``(A, m, const)`` rounded to the
    data's ``dtype``, except that each component keeps its ``held``
    operands (those of the previous E-step) while every new value of it is
    within one ``dtype`` spacing of its ``scales`` of that operand.

    The kernel forms the statistics around its operands in ``dtype``, so
    their rounding follows the operands' last bits.  Rounded afresh every
    iteration, an operand whose value sits near a rounding boundary can
    flip its last bit back and forth, and the iteration cycles with a bound
    that moves by ~1e-7 relative and never meets ``run``'s ``rel_tol``;
    held, the iteration reaches an exact fixed point, as the direct sums
    do.  The statistics stay exact for the operands the kernel took (the
    caller un-whitens with them), which are at most one spacing of the
    component's scale from the float64 values."""
    fresh = tuple(v.to(dtype) for v in operands)
    if held is None or any(h.shape != f.shape for h, f in zip(held, fresh)):
        return fresh
    keep = None
    for v, h, scale in zip(operands, held, scales):
        near = (v - h.to(v.dtype)).abs() <= _spacing(scale, dtype).reshape(
            scale.shape + (1,) * (v.dim() - 1))
        near = near.flatten(1).all(1) if v.dim() > 1 else near
        keep = near if keep is None else keep & near
    return tuple(torch.where(keep.reshape((-1,) + (1,) * (f.dim() - 1)), h, f)
                 for h, f in zip(held, fresh))


def _vb_unwhiten(A, m, stats, e_lnlam, e_lnpi):
    """The reduced :class:`_EStepOut` from the one-pass statistics
    ``(N_comp, sd, g, log_q_Z)`` taken with operands ``A``, ``m``: exact
    linear algebra, ``x - m = A^{-1} diff``, by triangular solves."""
    N_comp, sd, g, log_q_Z = (v.to(A.dtype) for v in stats)
    inv_N_comp = 1.0 / regularize(N_comp)
    d = torch.linalg.solve_triangular(A, (sd * inv_N_comp[:, None])[:, :, None],
                                      upper=True)[:, :, 0]
    x_mean = m + d
    Y = torch.linalg.solve_triangular(A, g, upper=True)                     # A^{-1} G
    G_raw = torch.linalg.solve_triangular(A, Y.transpose(1, 2), upper=True)  # A^{-1} G A^{-T}
    S = symmetrize((G_raw - N_comp[:, None, None] * d[:, None, :] * d[:, :, None])
                   * inv_N_comp[:, None, None])
    return _EStepOut(e_lnlam, None, e_lnpi, None, None, N_comp, inv_N_comp, x_mean, S,
                     log_q_Z)


def _vb_e_step_fused(dataT, weights, alpha, beta, nu, m, W, log_det_W, blocked=False,
                     reduce=None, held=None):
    """VB-GMM E-step with every sufficient statistic from one pass over the
    TRANSPOSED data ``(D, N)`` (kernel ``fused_vb_estep``, or
    ``fused_vb_estep_blocked`` with ``blocked``): no (N, K) matrix is
    formed, and the bound's per-sample term (10.75) comes back as the
    scalar ``log_q_Z``.  The reduced :class:`_EStepOut` carries None for the
    (N, K) fields; ``GaussianInference.r`` forms them on demand.  With
    ``reduce`` the statistics are summed over a particle mesh's ranks.
    Data narrower than the hyperparameters (float32) gives the kernel
    operands held from the previous E-step's ``held`` operands where they
    have not moved (:func:`_held_operands`)."""
    D, dt = dataT.shape[0], dataT.dtype
    e_lnlam, e_lnpi, A, const = _vb_whitening(D, alpha, beta, nu, m, W, log_det_W)
    operands = (A, m, const)
    if dt == A.dtype:
        ops = operands
    else:
        width = 1.0 / torch.diagonal(A, dim1=1, dim2=2).abs().amin(dim=1)
        scales = (A.abs().amax(dim=(1, 2)), torch.maximum(m.abs().amax(dim=1), width),
                  e_lnpi.abs() + 0.5 * (e_lnlam.abs() + D * _LOG_2PI + D / beta))
        ops = _held_operands(operands, scales, held, dt)
    kernel = _k.fused_vb_estep_blocked if blocked else _k.fused_vb_estep
    stats = kernel(dataT, weights.to(dt), *ops)
    if reduce is not None:
        stats = tuple(reduce(v) for v in stats)
    # un-whiten with the operands the kernel saw
    e = _vb_unwhiten(ops[0].to(A.dtype), ops[1].to(m.dtype), stats, e_lnlam, e_lnpi)
    return e._replace(operands=ops)


def _vb_merge_e_step(mu, sigma, Nomega, alpha, beta, nu, m, W, log_det_W):
    """[BGP10] E-step over L input components (eqs. (40)-(44))."""
    L, D = mu.shape
    dtype = alpha.dtype

    e_lnlam = _wishart_expect_log_lambda(D, nu, log_det_W)
    e_gauss = D / beta[None, :] + nu[None, :] * _bilinear_with_W(mu, m, W).to(dtype)
    e_lnpi = torch.special.digamma(alpha) - torch.special.digamma(alpha.sum())

    # (40): log rho_lk = 0.5 * Nomega_l * (2 E[ln pi] + E[ln Lam] - D ln 2pi
    #                                      - E[gauss exponent]_lk)
    tmp_k = 2.0 * e_lnpi + e_lnlam - D * _LOG_2PI
    log_rho = 0.5 * (Nomega[:, None] * tmp_k[None, :] - Nomega[:, None] * e_gauss)

    r, log_rho = _normalize_log_rho(log_rho, dtype)

    # (41): N_comp itself is regularized in the reference (``:1171-1175``)
    N_comp = regularize(Nomega @ r)
    inv_N_comp = 1.0 / N_comp
    mu, sigma = mu.to(dtype), sigma.to(dtype)
    wr = Nomega[:, None] * r
    # (42)
    x_mean = (wr.T @ mu) * inv_N_comp[:, None]
    # (43)+(44) combined: S_k += Nomega_l r_lk ((mu_l - xbar_k)(..)^T + sigma_l)
    S = torch.stack([
        inv_k * (torch.einsum("l,li,lj->ij", wr_k, mu - mean_k, mu - mean_k)
                 + torch.einsum("l,lij->ij", wr_k, sigma))
        for wr_k, mean_k, inv_k in zip(wr.T, x_mean, inv_N_comp)])

    return _EStepOut(e_lnlam, e_gauss, e_lnpi, log_rho, r, N_comp, inv_N_comp, x_mean, S)


def _vb_m_step(N_comp, x_mean, S, alpha0, beta0, nu0, m0, inv_W0):
    """VB-GMM M-step (10.58, 10.60-10.63)."""
    nu = nu0 + N_comp
    alpha = alpha0 + N_comp
    beta = beta0 + N_comp
    m = (beta0[:, None] * m0 + N_comp[:, None] * x_mean) / beta[:, None]  # (10.61)
    # (10.62): W_k^{-1} = W0^{-1} + N_k S_k
    #          + (beta0 N_k / (beta0 + N_k)) (xbar - m0)(xbar - m0)^T
    diff = x_mean - m0
    factor = beta0 * N_comp / (beta0 + N_comp)
    cov = (inv_W0 + N_comp[:, None, None] * S
           + factor[:, None, None] * diff[:, :, None] * diff[:, None, :])
    res = chol_inv_det(symmetrize(cov))
    return alpha, beta, nu, m, res.inv, -res.log_det


def _vb_bound(weights, e: _EStepOut, alpha, beta, nu, m, W, log_det_W,
              alpha0, beta0, nu0, m0, inv_W0, log_det_W0):
    """Likelihood lower bound, the seven terms (10.71)-(10.77)."""
    K, D = m.shape
    N_comp, x_mean, S = e.N_comp, e.x_mean_comp, e.S
    e_lnlam, e_lnpi = e.expectation_det_ln_lambda, e.expectation_ln_pi

    # (10.71)
    diff = x_mean - m
    quad = torch.einsum("ki,kij,kj->k", diff, W, diff)
    tr_SW = torch.einsum("kij,kji->k", S, W)
    log_p_X = 0.5 * torch.sum(
        N_comp * (e_lnlam - D / beta - nu * (tr_SW + quad) - D * _LOG_2PI))
    # (10.72)
    log_p_Z = torch.dot(N_comp, e_lnpi)
    # (10.73)
    log_p_pi = _dirichlet_log_C(alpha0) + torch.dot(alpha0 - 1, e_lnpi)
    # (10.74)
    diff0 = m - m0
    quad0 = torch.einsum("ki,kij,kj->k", diff0, W, diff0)
    tr_invW0_W = torch.einsum("kij,kji->k", inv_W0, W)
    log_p_mu_lambda = 0.5 * torch.sum(
        D * torch.log(beta0 / (2.0 * math.pi))
        + e_lnlam
        - D * beta0 / beta
        - beta0 * nu * quad0
        + 2.0 * _wishart_log_B(D, nu0, log_det_W0)
        + (nu0 - D - 1) * e_lnlam
        - nu * tr_invW0_W)
    # (10.75) (weighted); the fused E-step reduces this term in the kernel
    if e.log_q_Z is not None:
        log_q_Z = e.log_q_Z
    else:
        log_q_Z = torch.einsum("n,nk,nk->", weights.to(e.r.dtype), e.r, e.log_rho)
    # (10.76)
    log_q_pi = torch.dot(alpha - 1, e_lnpi) + _dirichlet_log_C(alpha)
    # (10.77)
    log_q_mu_lambda = (
        -0.5 * K * D
        + torch.sum(0.5 * (e_lnlam + D * torch.log(beta / (2 * math.pi))))
        - torch.sum(_wishart_H(D, nu, log_det_W)))
    return (log_p_X + log_p_Z + log_p_pi + log_p_mu_lambda
            - log_q_Z - log_q_pi - log_q_mu_lambda)


def _vb_update_bound(data, weights, N_comp, x_mean, S,
                     alpha0, beta0, nu0, m0, inv_W0, log_det_W0, *, fused, reduce=None,
                     held=None):
    """One full VB iteration -- M-step, E-step, likelihood bound,
    finiteness flag -- with one host synchronization: the bound and the
    flag come back as one ``(2,)`` tensor.

    ``data`` is ``(N, D)``, or ``(D, N)`` when ``fused`` (``"dense"`` or
    ``"blocked"``: the one-pass E-step takes the transposed layout).  With
    ``reduce`` they are a particle mesh rank's shard (see :func:`_vb_e_step`);
    ``held``: the previous one-pass E-step's operands (:func:`_vb_e_step_fused`).
    """
    hyper = _vb_m_step(N_comp, x_mean, S, alpha0, beta0, nu0, m0, inv_W0)
    if fused:
        e = _vb_e_step_fused(data, weights, *hyper, blocked=fused == "blocked",
                             reduce=reduce, held=held)
    else:
        e = _vb_e_step(data, weights, *hyper, reduce=reduce)
    bound = _vb_bound(weights, e, *hyper, alpha0, beta0, nu0, m0, inv_W0, log_det_W0)
    r_check = e.r if e.r is not None else e.N_comp
    finite = torch.isfinite(r_check).all() & torch.isfinite(e.S).all()
    return hyper, e, torch.stack([bound, finite.to(bound.dtype)])


# --------------------------------------------------------------------- #
# user-facing classes                                                   #
# --------------------------------------------------------------------- #

class GaussianInference(object):
    r"""Approximate a probability density by a Gaussian mixture with
    variational Bayes ([Bis06] ch. 10.2).
    (Reference: ``mix_adapt/variational.pyx:27-1033``.)

    Typical usage: call :meth:`run` until convergence, then either inspect
    the responsibility matrix ``self.r`` (clustering) or extract the mixture
    density at the mode of the variational posterior with
    :meth:`make_mixture`.

    :param data: ``(N, D)`` matrix-like array of samples; a torch tensor
        keeps its device and dtype (float32 on CUDA runs the kernels), any
        other array goes to ``device`` (default:
        :func:`pypmc_tpu_torch.default_device`) in the working dtype there
        (float32 on the card, float64 on the CPU).
    :param components: Integer K (detected from ``initial_guess`` if that is
        a mixture).
    :param weights: optional ``(N,)`` nonnegative finite sample weights
        (normalized to sum N internally).
    :param initial_guess: "first" | "random" | a Gaussian
        :class:`~pypmc_tpu_torch.density.mixture.MixtureDensity` whose
        parameters seed ``m``, ``W`` and ``alpha``.
    :param mesh: a particle mesh
        (:func:`pypmc_tpu_torch.parallel.particle_mesh`): every rank passes
        the same global ``data`` and ``weights``, keeps its contiguous
        ``1/size`` slice of them (the slices padded to equal length with
        zero-weight copies of a data point, which add nothing to any sum),
        and the E-step's statistics and the bound's sums over the data are
        summed over the ranks, so every rank holds the same posterior.
        ``r`` and the other (N, K) fields are the global ones, formed on
        demand from the whole data.

    All further keyword arguments are processed by
    :meth:`set_variational_parameters`.
    """

    # VBMerge's E-step runs over its input components, never over a mesh
    _mesh = None

    def __init__(self, data, components=0, weights=None, initial_guess="first",
                 mesh=None, device=None, **kwargs):
        from ..parallel.mesh import checked

        mesh = checked(mesh)
        if not isinstance(data, torch.Tensor):
            data = _device.as_tensor(_np.asarray(data, dtype=float), device)
        if data.ndim == 1:
            data = data[:, None]
        self._data_T = data.T.contiguous()   # the one copy of the data, (D, N)
        self.dim, self.N = (int(n) for n in self._data_T.shape)
        self.device = self._data_T.device
        dtype = self._data_T.dtype
        if weights is not None:
            weights = torch.as_tensor(weights, dtype=dtype, device=self.device)
            if tuple(weights.shape) != (self.N,):
                raise ValueError("got %s samples but weights of shape %s"
                                 % (self.N, tuple(weights.shape)))
            if not bool(torch.isfinite(weights).all()):
                raise ValueError("sample weights contain inf/nan:\n" + str(weights))
            sum_w = float(weights.sum())
            if not sum_w > 0:
                raise ValueError("total sample weight must be positive, got %g" % sum_w)
            # normalize weights to N (not one); weighted update formulae
            # reduce to the unweighted ones when weights are all 1
            self.weights = weights * (self.N / sum_w)
        else:
            self.weights = torch.ones((self.N,), dtype=dtype, device=self.device)
        self._mesh = mesh
        if mesh is not None:
            n_local = -(-self.N // mesh.size)
            pad = n_local * mesh.size - self.N
            data_T, w = self._data_T, self.weights
            if pad:
                data_T = torch.cat([data_T, data_T[:, :1].expand(self.dim, pad)], dim=1)
                w = torch.cat([w, torch.zeros((pad,), dtype=dtype, device=self.device)])
            lo = mesh.rank * n_local
            self._shard_T = data_T[:, lo:lo + n_local].contiguous()
            self._shard_w = w[lo:lo + n_local].contiguous()

        self._initialize_K(initial_guess, components, kwargs)
        self.set_variational_parameters(initial_guess=initial_guess, **kwargs)
        if not isinstance(initial_guess, str):
            self._parse_initial_guess(initial_guess)

        # valid bound computable right after construction
        self.E_step()

    @property
    def data(self):
        """The ``(N, D)`` data: a view of the kept ``(D, N)`` copy."""
        return self._data_T.T

    # ---------------- initialization helpers ---------------- #

    def _check_initial_guess(self, initial_guess, other_args):
        for name in ("m", "W", "alpha", "beta", "nu"):
            if name in other_args:
                raise ValueError("Specify EITHER ``%s`` OR ``initial_guess``" % name)

    def _initialize_K(self, initial_guess, components, kwargs):
        if not isinstance(initial_guess, str):
            self.K = len(initial_guess)
            self._check_initial_guess(initial_guess, kwargs)
        elif components > 0:
            self.K = int(components)
        else:
            raise ValueError(
                "Specify either `components` or a mixture density as "
                "`initial_guess` to set the initial values"
            )

    def _check_K_vector(self, name, min=0.0):
        v = getattr(self, name)
        if len(v.shape) != 1:
            raise ValueError("hyperparameter %s must be 1-D, got shape %s" % (name, v.shape))
        if len(v) != self.K:
            raise ValueError("hyperparameter %s has length %d, expected K=%d" % (name, len(v), self.K))
        if not (v > min).all():
            raise ValueError(
                "every element of %s must be > %g, got %s=%s" % (name, min, name, v)
            )

    def _initial_points(self):
        """The points ``m`` is initialized from, ``(N, D)``."""
        return self.data

    def _initialize_m(self, initial_guess):
        points = self._initial_points()
        if self.K > len(points):
            raise ValueError(
                "Can't auto-initialize ``m`` with more output components than"
                " samples. Specify ``m`` explicitly."
            )
        if initial_guess == "first":
            return _host(points[: self.K])
        elif initial_guess == "random":
            index = _np.random.choice(len(points), size=self.K, replace=False)
            return _host(points[torch.as_tensor(index, device=points.device)])
        else:
            raise ValueError("unrecognized initial_guess %r (want a MixtureDensity or one of the named schemes)" % (initial_guess,))

    def set_variational_parameters(self, *args, **kwargs):
        r"""Reset prior (subscript 0) and initial posterior hyperparameters
        of the Gauss-Wishart/Dirichlet variational distributions:
        ``alpha0/alpha`` (Dirichlet), ``beta0/beta``, ``nu0/nu`` (Wishart
        dof, must exceed D-1), ``m0/m`` (K x D means), ``W0/W`` (K x D x D
        Wishart scale matrices).  Scalars are promoted to K-vectors; see the
        reference (``variational.pyx:361-569``) for the full semantics.
        Takes the dict that ``prior_posterior()`` returns, of this package
        or of the JAX package (its ``components`` must equal K).
        """
        if args:
            raise TypeError("positional arguments are not accepted here; use keyword=value")

        K, dim = self.K, self.dim
        components = kwargs.pop("components", K)
        if components != K:
            raise ValueError("components=%s, but this object has K=%d" % (components, K))

        def promote_K(value):
            value = _host(value)
            if value.ndim == 0:
                value = value * _np.ones(K)
            return value

        self.alpha0 = promote_K(kwargs.pop("alpha0", 1e-5))
        self._check_K_vector("alpha0")
        self.alpha = promote_K(kwargs.pop("alpha", _np.ones(K) * self.alpha0))
        self._check_K_vector("alpha")

        # in the limit beta --> 0: uniform prior
        self.beta0 = promote_K(kwargs.pop("beta0", 1e-5))
        self._check_K_vector("beta0")
        self.beta = promote_K(kwargs.pop("beta", _np.ones(K) * self.beta0))
        self._check_K_vector("beta")

        # allowed values: nu > dim - 1
        nu_min = dim - 1.0
        self.nu0 = promote_K(kwargs.pop("nu0", nu_min + 1e-5))
        self._check_K_vector("nu0", min=nu_min)
        self.nu = promote_K(kwargs.pop("nu", self.nu0 * _np.ones(K)))
        self._check_K_vector("nu", min=nu_min)

        self.m0 = _np.array(_host(kwargs.pop("m0", _np.zeros(dim))))
        if self.m0.shape == (dim,):
            self.m0 = _np.vstack([self.m0] * K)

        initial_guess = kwargs.pop("initial_guess", "first")

        self.m = kwargs.pop("m", None)
        if self.m is None:
            if isinstance(initial_guess, str):
                self.m = self._initialize_m(initial_guess)
            else:
                # placeholder; overwritten by _parse_initial_guess
                self.m = _np.linspace(-1.0, 1.0, K * dim).reshape((K, dim))
        else:
            self.m = _np.array(_host(self.m))
        for name in ("m0", "m"):
            if getattr(self, name).shape != (K, dim):
                raise ValueError(
                    "%s has shape %s, expected (K, d) = %s"
                    % (name, getattr(self, name).shape, (K, dim))
                )

        W0 = kwargs.pop("W0", None)
        if W0 is None:
            self.W0 = _np.array([_np.eye(dim)] * K)
            self.inv_W0 = self.W0.copy()
            self.log_det_W0 = _np.zeros(K)
        else:
            W0 = _host(W0)
            if W0.shape == (dim, dim):
                _, inv_W0, log_det = chol_inv_det_host(W0)
                self.W0 = _np.array([W0] * K)
                self.inv_W0 = _np.array([inv_W0] * K)
                self.log_det_W0 = _np.array([log_det] * K)
            elif W0.shape == (K, dim, dim):
                self.W0 = W0.copy()
                self.inv_W0 = _np.empty_like(self.W0)
                self.log_det_W0 = _np.empty(K)
                for k in range(K):
                    _, self.inv_W0[k], self.log_det_W0[k] = chol_inv_det_host(W0[k])
            else:
                raise ValueError(
                    "W0 must be None, a %s matrix, or a stacked %s array"
                    % ((dim, dim), (K, dim, dim))
                )
        self.W = _host(kwargs.pop("W", self.W0.copy()))
        if self.W.shape != (K, dim, dim):
            raise ValueError(
                "W has shape %s, expected (K, d, d) = %s"
                % (self.W.shape, (K, dim, dim))
            )
        # check W is a valid covariance and compute the determinant
        self.log_det_W = _np.array([chol_inv_det_host(W)[2] for W in self.W])

        if kwargs:
            raise TypeError("unknown keyword argument(s): " + str(kwargs.keys()))
        self._to_device()

    def _parse_initial_guess(self, initial_guess):
        """Seed the posterior hyperparameters from a Gaussian mixture
        (``variational.pyx:646-673``)."""
        means, covs, component_weights = _unroll(initial_guess)
        N, K = self.N, self.K
        alpha0, beta0, nu0 = _host(self.alpha0), _host(self.beta0), _host(self.nu0)

        # solve Dirichlet mode as function of alpha
        c_alpha = _np.sum(alpha0) + N
        alpha = component_weights * (c_alpha - K) + 1
        beta = beta0 + N * component_weights
        nu = nu0 + N * component_weights
        if not ((alpha > 0.0).all() and (beta > 0.0).all() and (nu > self.dim - 1).all()):
            raise ValueError("the initial guess gives invalid hyperparameters: "
                             "alpha=%s beta=%s nu=%s" % (alpha, beta, nu))

        W = _np.empty_like(covs)
        log_det_W = _np.empty(K)
        for k in range(K):
            _, W[k], log_det = chol_inv_det_host(covs[k] * (nu[k] - self.dim))
            log_det_W[k] = -log_det  # det(W) = det(Cov^-1)
        self.alpha, self.beta, self.nu = alpha, beta, nu
        self.m, self.W, self.log_det_W = means, W, log_det_W
        self._to_device()

    _vmembers = ("alpha0", "alpha", "beta0", "beta", "nu0", "nu", "m0", "m",
                 "W0", "inv_W0", "W", "log_det_W", "log_det_W0")

    def _to_device(self):
        """Every hyperparameter as a float64 tensor on the data's device."""
        for name in self._vmembers:
            setattr(self, name, torch.as_tensor(_host(getattr(self, name)),
                                                dtype=torch.float64, device=self.device))

    def _posterior(self):
        return self.alpha, self.beta, self.nu, self.m, self.W, self.log_det_W

    def _prior(self):
        return (self.alpha0, self.beta0, self.nu0, self.m0, self.inv_W0,
                self.log_det_W0)

    # ---------------- E / M / bound ---------------- #

    def _fused_eligible(self):
        """The E-step's route, as the JAX package's
        (:func:`~pypmc_tpu_torch.ops.kernels.route`): ``"dense"`` where the
        one-pass kernel takes this mixture (``K*D <= 128``) and N >= 1024
        (and float32 data, on the card), ``"blocked"``
        where the JAX package elects its K-blocked E-step (the unfused (N,
        K) matrices would crowd 12 GiB), None for the unfused tensor
        path."""
        return _k.route("fused_vb_estep", self.K, self.dim, self.N, like=self._data_T)

    def _shard(self):
        """``(data_T (D, n), weights (n,), reduce)`` of the E-step: this
        rank's shard and the mesh's sum over ranks, or the whole data and
        None without a mesh."""
        if self._mesh is None:
            return self._data_T, self.weights, None
        return self._shard_T, self._shard_w, self._mesh.reduce

    def _e_step_kernel(self):
        fused = self._fused_eligible()
        data_T, w, reduce = self._shard()
        if fused:
            return _vb_e_step_fused(data_T, w, *self._posterior(),
                                    blocked=fused == "blocked", reduce=reduce,
                                    held=self._held())
        return _vb_e_step(data_T.T, w, *self._posterior(), reduce=reduce)

    def _held(self):
        """The operands of the last one-pass E-step, None before one."""
        e = getattr(self, "_e", None)
        return None if e is None else e.operands

    def E_step(self):
        """Compute expectation values and summary statistics (reference
        order ``variational.pyx:116-127``)."""
        out = self._e_step_kernel()
        r_check = out.r if out.r is not None else out.N_comp
        if not bool(torch.isfinite(r_check).all()):
            raise _np.linalg.LinAlgError(
                "responsibility update produced inf/nan:\n" + str(r_check)
            )
        if not bool(torch.isfinite(out.S).all()):
            raise _np.linalg.LinAlgError(
                "sample-covariance update produced inf/nan:\n" + str(out.S)
            )
        self._set_e(out)

    def _set_e(self, e):
        self._e = e
        self.expectation_det_ln_lambda = e.expectation_det_ln_lambda
        self.expectation_ln_pi = e.expectation_ln_pi
        self.N_comp = e.N_comp
        self.inv_N_comp = e.inv_N_comp
        self.x_mean_comp = e.x_mean_comp
        self.S = e.S

    def _require_full_e(self):
        """Form the (N, K) E-step fields (responsibilities etc.) if the
        one-pass E-step was used; one extra pass over the data."""
        if self._e.r is None:
            self._e = _vb_e_step(self.data, self.weights, *self._posterior())._replace(
                operands=self._e.operands)

    @property
    def r(self):
        """(N, K) responsibility matrix (10.49); computed on demand when the
        one-pass E-step was used."""
        self._require_full_e()
        return self._e.r

    @property
    def log_rho(self):
        self._require_full_e()
        return self._e.log_rho

    @property
    def expectation_gauss_exponent(self):
        self._require_full_e()
        return self._e.expectation_gauss_exponent

    def M_step(self):
        """Update the Gauss-Wishart/Dirichlet parameters."""
        (self.alpha, self.beta, self.nu, self.m, self.W,
         self.log_det_W) = _vb_m_step(self.N_comp, self.x_mean_comp, self.S,
                                      *self._prior()[:5])

    def update(self):
        """One M-step followed by one E-step."""
        self.M_step()
        self.E_step()

    def _update_with_bound(self):
        """One iteration of :meth:`run`: M-step, E-step, and likelihood
        bound with one host synchronization (see :func:`_vb_update_bound`);
        returns the bound as a float.  Semantics identical to
        ``update(); likelihood_bound()``."""
        fused = self._fused_eligible()
        data_T, w, reduce = self._shard()
        hyper, e, bound_finite = _vb_update_bound(
            data_T if fused else data_T.T, w, self.N_comp,
            self.x_mean_comp, self.S, *self._prior(), fused=fused, reduce=reduce,
            held=self._held())
        bound, finite = bound_finite.tolist()   # the one host sync of the iteration
        if not finite:
            raise _np.linalg.LinAlgError(
                "Encountered inf or nan in update of responsibilities or"
                " sample covariance"
            )
        self.alpha, self.beta, self.nu, self.m, self.W, self.log_det_W = hyper
        self._set_e(e)
        return bound

    def likelihood_bound(self):
        """Lower bound on the true log marginal likelihood given the current
        parameter estimates ((10.71)-(10.77))."""
        return float(_vb_bound(self.weights, self._e, *self._posterior(),
                               *self._prior()))

    # ---------------- posterior export / warm restart ---------------- #

    def make_mixture(self):
        """Return the Gaussian mixture at the mode of the variational
        posterior, skipping components with undefined Dirichlet or
        Gauss-Wishart modes (``variational.pyx:138-192``)."""
        components = []
        weights = []
        skipped = []
        alpha, nu, m, W_arr = (_host(v) for v in (self.alpha, self.nu, self.m, self.W))
        for k in range(self.K):
            pi = alpha[k] - 1.0
            if pi <= 0:
                logger.warning("component %i has zero weight; leaving it out of the mixture" % k)
                skipped.append(k)
                continue
            if nu[k] <= self.dim:
                logger.warning("component %i: Gauss-Wishart mode undefined (nu <= D); leaving it out" % k)
                skipped.append(k)
                continue
            try:
                lam = (nu[k] - self.dim) * W_arr[k]  # mode of the Wishart
                cov = chol_inv_det_host(lam)[1]
                components.append(Gauss(m[k], cov))
            except (ValueError, _np.linalg.LinAlgError) as error:
                logger.error(
                    "component %i could not be built (%s); leaving it out" % (k, repr(error))
                )
                skipped.append(k)
                continue
            weights.append(pi)

        if skipped:
            logger.warning("The following components have been skipped: %s" % skipped)

        return MixtureDensity(components, weights)

    def posterior2prior(self):
        """Return the posterior hyperparameters as a kwargs dict usable to
        construct a new instance with this posterior as prior."""
        return dict(
            alpha0=_host(self.alpha), beta0=_host(self.beta), nu0=_host(self.nu),
            m0=_host(self.m), W0=_host(self.W), components=self.K,
        )

    def prior_posterior(self):
        """Return prior and posterior values of all variational parameters
        as a dict."""
        return dict(
            alpha0=_host(self.alpha0), beta0=_host(self.beta0), m0=_host(self.m0),
            nu0=_host(self.nu0), W0=_host(self.W0), alpha=_host(self.alpha),
            beta=_host(self.beta), m=_host(self.m), nu=_host(self.nu),
            W=_host(self.W), components=self.K,
        )

    # ---------------- prune / run ---------------- #

    def prune(self, threshold=1.0):
        r"""Delete components with effective sample count ``N_k`` below the
        ``threshold`` (0 disables); reindex all hyperparameters and recompute
        the expectation values (``variational.pyx:233-281``)."""
        if not threshold:
            return

        survivors = torch.nonzero(self.N_comp >= threshold).squeeze(1)
        K = int(survivors.numel())
        if K == 0:
            raise ValueError(
                "prune threshold %g would kill every component" % threshold
            )
        if K == self.K:
            return
        self.K = K
        for name in self._vmembers:
            setattr(self, name, getattr(self, name)[survivors])
        self.E_step()

    def run(self, iterations=1000, prune=1.0, rel_tol=1e-10, abs_tol=1e-5):
        r"""Run VB updates until convergence of the likelihood bound
        (reference protocol, ``variational.pyx:283-359``: converge only when
        the bound increased and the number of components is unchanged;
        ``prune`` removes components with ``N_k`` below that threshold after
        every update).

        Return the number of iterations at convergence, or None.
        """
        old_K = None
        bound = None
        for i in range(1, iterations + 1):
            if self.K == old_K:
                old_bound = bound
            else:
                old_bound = self.likelihood_bound()
                logger.info(
                    "K changed to %d; fresh likelihood bound %g (N_k=%s)",
                    self.K, old_bound, self.N_comp,
                )

            bound = self._update_with_bound()

            logger.info(
                "VB iteration %d: bound %.15g with K=%d, N_k=%s",
                i, bound, self.K, self.N_comp,
            )

            if bound < old_bound:
                logger.warning(
                    "likelihood bound dropped this iteration (%g -> %g)",
                    old_bound, bound,
                )

            if bound == old_bound:
                return i
            diff = bound - old_bound
            if diff > 0:
                if abs(bound) < abs_tol:
                    if abs(diff) < abs_tol:
                        return i
                else:
                    if abs(diff / bound) < rel_tol:
                        return i

            old_K = self.K
            self.prune(prune)
        return None


class VBMerge(GaussianInference):
    """Parsimonious reduction of a Gaussian mixture with variational Bayes
    [BGP10]: compress an ``L``-component ``input_mixture`` (fitted to ``N``
    virtual samples) into at most ``components`` output components without
    the original samples.  (Reference: ``variational.pyx:1035-1218``.)

    :param input_mixture: Gaussian
        :class:`~pypmc_tpu_torch.density.mixture.MixtureDensity` to be
        compressed.
    :param N: number of (virtual) input samples the mixture is based on.
    :param components: maximum number of output components (ignored when
        ``initial_guess`` is a mixture).
    :param initial_guess: "first" | "random" | a Gaussian mixture seeding
        the output.
    :param device, dtype: where and in what dtype the input components are
        held (float32 on CUDA runs the kernels); by default
        :func:`pypmc_tpu_torch.default_device` and the working dtype there.

    All other keyword arguments as in
    :meth:`GaussianInference.set_variational_parameters`.
    """

    def __init__(self, input_mixture, N, components=0, initial_guess="first",
                 device=None, dtype=None, **kwargs):
        self.input = input_mixture
        self.L = len(input_mixture.components)
        means, covs, input_weights = _unroll(input_mixture)
        self.device = _device.default_device(device)
        dtype = dtype or _device.working_dtype(self.device)
        self.mu = torch.as_tensor(means, dtype=dtype, device=self.device)
        self.sigma = torch.as_tensor(covs, dtype=dtype, device=self.device)

        self._initialize_K(initial_guess, components, kwargs)
        self.dim = int(means.shape[1])
        self.N = N
        # effective number of samples per input component (N * omega)
        self.Nomega = torch.as_tensor(N * input_weights, dtype=torch.float64,
                                      device=self.device)
        # the bound's log_q_Z term runs over L pseudo-points with unit weight
        self.weights = torch.ones((self.L,), dtype=torch.float64, device=self.device)

        self.set_variational_parameters(initial_guess=initial_guess, **kwargs)
        if not isinstance(initial_guess, str):
            self._parse_initial_guess(initial_guess)

        self.E_step()

    def _initial_points(self):
        return self.mu

    def _update_with_bound(self):
        self.update()
        return self.likelihood_bound()

    def _e_step_kernel(self):
        return _vb_merge_e_step(self.mu, self.sigma, self.Nomega, *self._posterior())
