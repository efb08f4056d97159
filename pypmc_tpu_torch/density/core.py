"""Functional density core: stacked-parameter mixtures of torch tensors.

Counterpart of :mod:`pypmc_tpu.density.core`.  A mixture is ONE dataclass of
stacked tensors

    means (K, D), cov/chol/inv_chol/inv_sigma (K, D, D), log_det (K,),
    weights (K,), [dof (K,) for Student-t]

and every operation is a batched computation over it.  Component death is
``weights == 0`` with the old (still valid) parameters kept in place.

Particles are carried transposed, ``(D, N)``, as in the JAX package.  The
mixture log-density (:func:`mixture_logpdf_T`), the fused
propose-and-evaluate step (:func:`propose_logq_T`) and the Mahalanobis
distances (:func:`mahalanobis_all_T`) run through the kernels of
:mod:`pypmc_tpu_torch.ops.kernels` (CUDA float32) or their plain versions
(CPU) when the mixture fits the kernel (:func:`~pypmc_tpu_torch.ops.kernels.fits`),
and through their unfused tensor path when it does not; everything else
here is tensor code on any device.
"""

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from .. import _device, _rng
from ..ops import kernels as _k
from ..ops.linalg import chol_inv_det, symmetrize
from ..ops.lse import logsumexp

__all__ = [
    "MixtureParams",
    "make_mixture",
    "gauss_log_norm",
    "student_t_log_norm",
    "log_normalization",
    "mahalanobis",
    "mahalanobis_all",
    "mahalanobis_all_T",
    "component_logpdfs",
    "mixture_logpdf",
    "mixture_logpdf_T",
    "propose",
    "propose_T",
    "propose_logq_T",
    "update_masked",
    "params_from_numpy",
    "params_to_numpy",
]

_FIELDS = ("means", "cov", "chol", "inv_chol", "inv_sigma", "log_det",
           "weights", "dof")


@dataclasses.dataclass(frozen=True)
class MixtureParams:
    """Stacked parameters of a Gaussian or Student-t mixture.

    ``dof is None`` selects the Gaussian family; a ``(K,)`` tensor of
    degrees of freedom selects Student-t.  ``weights`` are normalized; a
    weight of exactly 0 marks a dead component (kept with its last valid
    parameters).
    """

    means: torch.Tensor       # (K, D)
    cov: torch.Tensor         # (K, D, D)
    chol: torch.Tensor        # (K, D, D) lower Cholesky of cov
    inv_chol: torch.Tensor    # (K, D, D) U = L^{-1}
    inv_sigma: torch.Tensor   # (K, D, D)
    log_det: torch.Tensor     # (K,)
    weights: torch.Tensor     # (K,)
    dof: Optional[torch.Tensor] = None  # (K,) or None

    @property
    def K(self) -> int:
        return self.means.shape[0]

    @property
    def dim(self) -> int:
        return self.means.shape[1]

    @property
    def is_student_t(self) -> bool:
        return self.dof is not None

    @property
    def device(self) -> torch.device:
        return self.means.device

    def to(self, *args, **kwargs) -> "MixtureParams":
        """Every field through ``Tensor.to``."""
        return MixtureParams(**{
            f: None if getattr(self, f) is None else getattr(self, f).to(*args, **kwargs)
            for f in _FIELDS})


def params_from_numpy(p, device=None, dtype=None) -> MixtureParams:
    """:class:`MixtureParams` from the eight fields of ``p``, taken as numpy
    arrays: ``p`` is a mapping or any object with those attributes (for
    instance a :class:`pypmc_tpu.density.core.MixtureParams`).  ``p`` may
    also be a mixture density of either package (an object with
    ``components`` and ``weights``, its components Gaussian or Student-t
    with ``mu``, ``sigma`` and ``dof``): its parameters are stacked and
    factorized by :func:`make_mixture`.  The tensors go to ``device``
    (default: :func:`pypmc_tpu_torch.default_device`); ``dtype`` None keeps
    the arrays' own dtype (float64 for a mixture density)."""
    device = _device.default_device(device)
    if hasattr(p, "components"):
        comps = p.components
        stack = lambda name: torch.as_tensor(
            np.array([getattr(c, name) for c in comps], dtype=float),
            dtype=dtype, device=device)
        dofs = stack("dof") if all(hasattr(c, "dof") for c in comps) else None
        params, valid = make_mixture(stack("mu"), stack("sigma"),
                                     torch.as_tensor(np.array(p.weights, dtype=float),
                                                     dtype=dtype, device=device), dofs)
        if not bool(valid.all()):
            raise ValueError("a component's covariance is not positive definite")
        return params

    def get(f):
        v = p[f] if isinstance(p, dict) else getattr(p, f)
        return None if v is None else torch.as_tensor(
            np.array(v), dtype=dtype, device=device)

    return MixtureParams(**{f: get(f) for f in _FIELDS})


def params_to_numpy(params: MixtureParams) -> dict:
    """The eight fields of ``params`` as numpy arrays (``dof`` may be
    None)."""
    return {f: None if getattr(params, f) is None
            else getattr(params, f).detach().cpu().numpy() for f in _FIELDS}


def make_mixture(means, covs, weights=None, dofs=None, device=None):
    """Build :class:`MixtureParams` from raw means/covariances(/dofs).

    Returns ``(params, valid)`` where ``valid`` is a ``(K,)`` bool mask that
    is False for components whose covariance is not symmetric
    positive-definite.  Weights are normalized.  Tensor means keep their
    device and dtype; host means go to ``device`` (default:
    :func:`pypmc_tpu_torch.default_device`) in the working dtype there.
    """
    means = _device.as_tensor(means, device)
    covs = torch.as_tensor(covs, dtype=means.dtype, device=means.device)
    K = means.shape[0]
    if weights is None:
        weights = torch.ones((K,), dtype=means.dtype, device=means.device)
    weights = torch.as_tensor(weights, dtype=means.dtype, device=means.device)
    weights = weights / torch.sum(weights)
    res = chol_inv_det(covs)
    dof = None if dofs is None else torch.as_tensor(
        dofs, dtype=means.dtype, device=means.device)
    params = MixtureParams(means=means, cov=covs, chol=res.chol,
                           inv_chol=res.inv_chol, inv_sigma=res.inv,
                           log_det=res.log_det, weights=weights, dof=dof)
    return params, res.valid


def gauss_log_norm(log_det, dim):
    """Gaussian log-normalization (``density/gauss.pyx:54-56``)."""
    return -0.5 * dim * math.log(2 * math.pi) - 0.5 * log_det


def student_t_log_norm(log_det, dof, dim):
    """Student-t log-normalization (``density/student_t.pyx:32-34``)."""
    return (torch.lgamma(0.5 * (dof + dim)) - torch.lgamma(0.5 * dof)
            - 0.5 * dim * torch.log(dof * math.pi) - 0.5 * log_det)


def log_normalization(params: MixtureParams):
    """Per-component log-normalization constants, shape ``(K,)``."""
    if params.is_student_t:
        return student_t_log_norm(params.log_det, params.dof, params.dim)
    return gauss_log_norm(params.log_det, params.dim)


def _kernel_operands(params: MixtureParams) -> _k.MixtureOperands:
    """Pack a mixture into the kernels' flat operand buffer (layout in
    :class:`pypmc_tpu_torch.ops.kernels.MixtureOperands`)."""
    K, D = params.K, params.dim
    if params.is_student_t:
        dof = params.dof
        psi = torch.special.digamma(0.5 * (D + dof))
    else:
        dof = torch.ones_like(params.weights)
        psi = torch.zeros_like(params.weights)
    packed = torch.cat([
        params.means.reshape(-1), params.inv_chol.reshape(-1),
        log_normalization(params).reshape(-1), params.weights, dof, psi,
        params.chol.reshape(-1), _cumulative_weights(params.weights)])
    return _k.MixtureOperands(packed.contiguous(), K, D, params.is_student_t)


def mahalanobis(x, means, inv_chol):
    """Squared Mahalanobis distances ``(N, K)`` of points ``x (N, D)`` to
    all components, as ``|| U_k x_n - U_k mu_k ||^2``."""
    proj = torch.einsum("nd,kid->nki", x, inv_chol)
    b = torch.einsum("kd,kid->ki", means, inv_chol)
    diff = proj - b[None, :, :]
    return torch.sum(diff * diff, dim=-1)


def _projected_sq_norms_T(xT, a, m):
    """``(K, N)`` squared norms ``|a_k (x_n - m_k)|^2`` of transposed
    particles ``xT (D, N)`` for general matrices ``a (K, D, D)`` and
    centers ``m (K, D)``, in the particles' dtype: kernel ``fused_maha``
    where the size gate takes the mixture, otherwise one ``(D, N)`` product
    per component."""
    K, D = m.shape
    a, m = a.to(xT.dtype), m.to(xT.dtype)
    if _k.gate("fused_maha", K, D, like=xT):
        return _k.fused_maha(xT.contiguous(), a.contiguous(), m.contiguous())
    return torch.stack([torch.sum(torch.square(a_k @ (xT - m_k[:, None])), dim=0)
                        for a_k, m_k in zip(a, m)])


def mahalanobis_all_T(params: MixtureParams, xT):
    """``(K, N)`` squared Mahalanobis distances for transposed particles
    ``xT (D, N)`` (through :func:`_projected_sq_norms_T` with the inverse
    Cholesky factors)."""
    return _projected_sq_norms_T(xT, params.inv_chol, params.means)


def mahalanobis_all(params: MixtureParams, x):
    """``(N, K)`` squared Mahalanobis distances of row-major ``x (N, D)``."""
    return mahalanobis_all_T(params, x.T).T


def component_logpdfs(params: MixtureParams, x):
    """Per-component log-densities, shape ``(N, K)``, of ``x (N, D)``."""
    maha = mahalanobis(x, params.means, params.inv_chol)
    log_norm = log_normalization(params)
    if params.is_student_t:
        return log_norm[None, :] - 0.5 * (params.dof + params.dim)[None, :] * torch.log1p(
            maha / params.dof[None, :])
    return log_norm[None, :] - 0.5 * maha


def mixture_logpdf_T(params: MixtureParams, xT):
    """Mixture log-density ``log q(x_n)``, shape ``(N,)``, for transposed
    particles ``xT (D, N)``: kernel ``fused_logq`` on CUDA float32, its plain
    version on the CPU; where the gate refuses the mixture or the particles
    (as the JAX package takes XLA: past the size rule, or not float32 on the
    card), the per-component log-densities and a weighted log-sum-exp."""
    if _k.gate("fused_logq", params.K, params.dim, like=xT):
        return _k.fused_logq(xT, _kernel_operands(params))
    return logsumexp(component_logpdfs(params, xT.T), params.weights, axis=-1)


def mixture_logpdf(params: MixtureParams, x):
    """Mixture log-density for row-major ``x (N, D)``."""
    return mixture_logpdf_T(params, x.T.contiguous())


def _cumulative_weights(weights):
    """Inverse-CDF thresholds from the TAIL sums,
    ``cumw[k] = 1 - sum_{j>k} w_j``: a dead component's interval is empty
    bit-exactly and the last threshold is exactly 1 (a forward cumsum can
    round the total below 1 and hand ``u`` in [total, 1) to a dead trailing
    component)."""
    tail = torch.flip(torch.cumsum(torch.flip(weights, (0,)), 0), (0,))
    tail_excl = torch.cat([tail[1:], torch.zeros_like(tail[:1])])
    return 1.0 - tail_excl


def propose_T(params: MixtureParams, key, n: int):
    """Draw ``n`` samples from the mixture in the transposed layout; return
    ``(samples_T (D, n), latent (n,) int32)``.

    The component is one uniform per particle against the tail-sum
    thresholds (a dead component is never drawn).  On the card the
    components, and the normals and Student-t scales a transform below
    takes, come from kernel ``draw_proposal_inputs`` (in the mixture's
    dtype), keyed by the seed words: a tensor of them (a row of a run's
    seed table) is read on the card, never copied to the host, so a CUDA
    graph replaying the step draws anew.  On the CPU they come from its
    plain version, a generator seeded with the words.  The transform takes
    the JAX package's routes (``pypmc_tpu/density/core.py:308-314``,
    ``ops.kernels.proposal_route``): kernel ``fused_transform_rng``
    (normals and Student-t scale drawn in the kernel, its stream keyed by
    the words with bit 0 of the second flipped) where a float32 mixture
    fits its rule at 1024 particles a tile and n >= 1024; else kernel
    ``fused_transform`` on the drawn normals and scales (the chi-square
    clamped to ``tiny``) where it fits at 128 particles; else the transform
    as tensor code accumulated one Cholesky column at a time (float64 on
    the card too).  Up to D = 64, where those transforms are record
    kernels, the draw and the transform are one launch,
    ``fused_draw_transform_rng`` or ``fused_draw_transform``: the same
    draws bit for bit, with no normals in device memory.  ``key`` is an int
    seed, a ``torch.Generator`` (advanced by two seed words) or two seed
    words (a tuple, or a 2-word int64 tensor on the mixture's device)."""
    K, D = params.K, params.dim
    seed = _rng.seed_words(key)
    route = _k.proposal_route(K, D, n, like=params.means)
    if route in ("fused_draw_transform", "fused_draw_transform_rng"):
        return getattr(_k, route)(seed, _kernel_operands(params), n)
    dof = None if params.dof is None else params.dof.contiguous()
    latent, zT, scale = _k.draw_proposal_inputs(
        seed, _cumulative_weights(params.weights).contiguous(), dof, n, D,
        normals=route != "fused_transform_rng")
    if route == "fused_transform_rng":
        return _k.fused_transform_rng(_rng.flip_bit(seed, 0), latent,
                                      _kernel_operands(params)), latent
    if route == "fused_transform":
        return _k.fused_transform(zT, latent, scale, _kernel_operands(params)), latent
    # the tensor path: gather one (D, n) Cholesky column panel at a time
    # rather than an (n, D, D) table
    lat = latent.long()
    acc = torch.zeros_like(zT)
    for j in range(D):
        acc += params.chol[:, :, j].T[:, lat] * zT[j][None, :]
    return params.means.T[:, lat] + acc * scale[None, :], latent


def propose(params: MixtureParams, key, n: int):
    """Row-major variant of :func:`propose_T`: ``(samples (n, D), latent)``."""
    samples_T, latent = propose_T(params, key, n)
    return samples_T.T, latent


def propose_logq_T(params: MixtureParams, key, n: int, target_params=None):
    """Draw ``n`` mixture samples and evaluate the proposal log-density (and
    optionally a target mixture's) on them: kernel ``fused_propose_logq`` on
    CUDA float32, its plain version on the CPU.

    Where the gate refuses the mixtures (past its size rule, or not float32
    on the card), the draw is :func:`propose_T` and each log-density
    :func:`mixture_logpdf_T`.

    Returns ``(samples_T (D, n), latent (n,), log_q (n,))``, plus
    ``log_p (n,)`` when ``target_params`` is given.  ``key`` provides the
    two seed words (and is advanced when it is a generator).
    """
    Kt = 0 if target_params is None else target_params.K
    if not _k.gate("fused_propose_logq", params.K, params.dim, Kt, like=params.means):
        samples_T, latent = propose_T(params, key, n)
        out = (samples_T, latent, mixture_logpdf_T(params, samples_T))
        if target_params is None:
            return out
        return out + (mixture_logpdf_T(target_params, samples_T),)
    target = None if target_params is None else _kernel_operands(target_params)
    return _k.fused_propose_logq(_rng.seed_words(key), _kernel_operands(params),
                                 n, target)


def update_masked(params: MixtureParams, new_means, new_covs, new_weights,
                  new_dofs=None, update_mask=None):
    """Batched masked parameter update with PSD-validity fallback.

    For every component where ``update_mask`` is True, attempt the update;
    where the new covariance is not symmetric positive-definite, keep ALL old
    parameters and set the component weight to zero, then renormalize.  If
    every component died, all weights stay exactly 0 (no 0/0 NaN mixture).

    Returns ``(new_params, ok_mask)``.
    """
    K = params.K
    if update_mask is None:
        update_mask = torch.ones((K,), dtype=torch.bool, device=params.device)
    new_covs = symmetrize(new_covs)
    res = chol_inv_det(new_covs)
    ok = update_mask & res.valid
    sel_m = ok[:, None]
    sel_c = ok[:, None, None]
    weights = torch.where(update_mask & ~res.valid,
                          torch.zeros_like(new_weights), new_weights)
    total = torch.sum(weights)
    weights = torch.where(total > 0,
                          weights / torch.where(total > 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    dof = params.dof
    if dof is not None and new_dofs is not None:
        dof = torch.where(ok, new_dofs, dof)
    return (
        MixtureParams(
            means=torch.where(sel_m, new_means, params.means),
            cov=torch.where(sel_c, new_covs, params.cov),
            chol=torch.where(sel_c, res.chol, params.chol),
            inv_chol=torch.where(sel_c, res.inv_chol, params.inv_chol),
            inv_sigma=torch.where(sel_c, res.inv, params.inv_sigma),
            log_det=torch.where(ok, res.log_det, params.log_det),
            weights=weights,
            dof=dof,
        ),
        ok,
    )
