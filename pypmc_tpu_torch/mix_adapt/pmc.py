"""Population Monte Carlo (PMC) mixture updates, functional core.

Counterpart of the functional core of :mod:`pypmc_tpu.mix_adapt.pmc` (the
reference's ``pypmc/mix_adapt/pmc.pyx``): the Rao-Blackwellized
responsibilities, the [Cap+08] eq. (14) sufficient statistics, the Student-t
gamma pass and the [HOD12] eq. (16) degree-of-freedom update over stacked
mixture parameters.  Component death is a validity mask; the dof root-solve
is a fixed-iteration bisection over all components at once.

Every reduction over the particle axis passes through a ``reduce`` hook,
the counterpart of the JAX package's ``psum``: the identity in one process,
the particle mesh's ``all_reduce`` over its ranks
(:meth:`pypmc_tpu_torch.parallel.mesh.ParticleMesh.reduce`).
The reference's host API -- :class:`PMC`, :func:`gaussian_pmc`,
:func:`student_t_pmc` -- runs these updates on the device for the host
density classes.
"""

import logging
from copy import deepcopy as _cp
from typing import Callable, NamedTuple, Optional

import numpy as _np
import torch

from .. import _device, _rng
from ..density import core as _core
from ..density.mixture import MixtureDensity
from ..ops import _build
from ..ops import kernels as _k
from ..ops.lse import logsumexp, regularize

logger = logging.getLogger(__name__)

__all__ = ["calculate_rho_rb", "calculate_rho_rb_T", "pmc_update", "PMCResult",
           "pmc_step_mixture_target", "pmc_log_likelihood", "PMC", "gaussian_pmc",
           "student_t_pmc"]


def _identity(x):
    return x


def calculate_rho_rb_T(params: _core.MixtureParams, samples_T):
    """Rao-Blackwellized responsibilities ``rho (K, N)`` for transposed
    particles ``samples_T (D, N)``: ``rho[k,n] = w_k q_k(x_n) / q(x_n)``,
    computed in log space; exactly zero for dead components.  Kernel
    ``fused_rho`` where the gate takes the mixture and the particles,
    otherwise tensor code."""
    if _k.gate("fused_rho", params.K, params.dim, like=samples_T):
        return _k.fused_rho(samples_T.contiguous(), _core._kernel_operands(params))[0]
    logpdfs = _core.component_logpdfs(params, samples_T.T)  # (N, K)
    log_denom = logsumexp(logpdfs, params.weights, axis=-1)
    rho = torch.exp(logpdfs - log_denom[:, None]) * params.weights[None, :]
    return torch.where(params.weights[None, :] > 0, rho, torch.zeros_like(rho)).T


def calculate_rho_rb(params: _core.MixtureParams, samples):
    """Row-major variant of :func:`calculate_rho_rb_T`: ``rho (N, K)``."""
    return calculate_rho_rb_T(params, samples.T).T


def _rho_non_rb_T(params: _core.MixtureParams, latent, n_components: int):
    """One-hot responsibilities (K, N) from latent variables
    (``pmc.pyx:45-51``), zeroed for dead components."""
    ks = torch.arange(n_components, device=latent.device)[:, None]
    onehot = (latent[None, :] == ks).to(params.weights.dtype)
    return torch.where(params.weights[:, None] > 0, onehot, torch.zeros_like(onehot))


def _cov_sums_T(samples_T, c_T, mu):
    """``(K, D, D)`` centered second-moment sums
    ``S_k = sum_n c_kn (x_n - mu_k)(x_n - mu_k)^T``, one component at a
    time so that only a ``(D, N)`` intermediate exists."""
    return torch.stack([
        torch.einsum("n,in,jn->ij", c_k, samples_T - mu_k[:, None],
                     samples_T - mu_k[:, None])
        for c_k, mu_k in zip(c_T, mu)])


_FUSED_MODES = ("auto", "dense", "blocked", "off")


def _check_fused_arg(fused):
    """Reject a mistyped ``fused=`` value instead of treating it as
    ``"auto"``."""
    if fused not in _FUSED_MODES:
        raise ValueError("fused must be one of %s, got %r" % (_FUSED_MODES, fused))


def _fused_mode(fused, kernel, K, D, N, like, Kt=0, rb=True):
    """``"dense"`` where the single-pass ``kernel`` runs, ``"blocked"``
    where its K-blocked variant does, None for the unfused path, for ``N``
    particles and operands ``like`` (a tensor).  ``"auto"`` routes as the
    JAX package does (:func:`~pypmc_tpu_torch.ops.kernels.route`): the
    dense kernel where its rule takes the mixture, the K-blocked one where
    the JAX package elects it, the unfused path otherwise (float64 on the
    card included).  A forced ``"dense"`` or
    ``"blocked"`` that cannot run raises with the rule or limit named
    instead of rerouting."""
    _check_fused_arg(fused)
    if fused == "off" or (fused == "auto" and not rb):
        return None
    if fused == "auto":
        return _k.route(kernel, K, D, N, Kt, like)
    name = kernel if fused == "dense" else kernel + "_blocked"
    reason = ("it requires rb=True" if not rb else
              _k.refusal(name, K, D, Kt, like=like) or _build.limit_reason(name, K, D, Kt))
    if reason is not None:
        raise ValueError("fused=%r was forced but is infeasible for these "
                         "operands: %s" % (fused, reason))
    return fused


class PMCResult(NamedTuple):
    """Result of one :func:`pmc_update`.

    ``rho`` holds the ``(K, N)`` responsibilities, or None when the update
    ran on the fused single-pass path (they are reduced per tile and never
    formed); :func:`calculate_rho_rb_T` on the PRE-update parameters
    recomputes them."""

    params: _core.MixtureParams
    rho: Optional[torch.Tensor]
    updated_ok: torch.Tensor     # (K,) bool; updated components that stayed valid
    live: torch.Tensor           # (K,) bool; live components before the update


def pmc_update(
    params: _core.MixtureParams,
    samples,
    weights=None,
    latent=None,
    rb: bool = True,
    mincount: int = 0,
    dof_solver_steps: int = 100,
    mindof: float = 1e-5,
    maxdof: float = 1e3,
    reduce: Optional[Callable] = None,
    transposed: bool = False,
    fused: str = "auto",
) -> PMCResult:
    """One (M-)PMC update of a Gaussian or Student-t mixture ([Cap+08] eq.
    14, [HOD12] for the dof).

    :param params: stacked mixture parameters (Gaussian iff ``params.dof``
        is None).
    :param samples: ``(N, D)`` samples drawn from the current mixture, or
        ``(D, N)`` with ``transposed=True``.
    :param weights: ``(N,)`` unnormalized importance weights, or None for
        equal weights.
    :param latent: ``(N,)`` int indices of the generating components, or
        None (requires ``rb=True``).
    :param rb: Rao-Blackwellized responsibilities (True) or one-hot from
        ``latent`` (False).
    :param mincount: kill components that generated fewer than this many
        samples (requires ``latent``).
    :param dof_solver_steps: bisection iterations for the Student-t dof
        update; 0 disables the dof update.
    :param mindof, maxdof: search interval for the dof root-solve.
    :param reduce: sum of a statistic over all particle shards (the JAX
        package's ``psum``; a particle mesh's ``reduce``); None is the
        identity of one process.
    :param transposed: whether ``samples`` is ``(D, N)``.
    :param fused: ``"dense"`` runs every statistic in one pass (kernel
        ``fused_pmc_stats`` on CUDA float32, its plain version on the CPU;
        ``rb=True`` only, ``K*D <= 128``), ``"blocked"`` the same past it
        (kernel ``fused_pmc_stats_blocked``, up to the JAX package's VMEM
        fit), ``"off"`` the unfused tensor path; a forced kernel that cannot
        run raises ``ValueError``.  ``"auto"`` routes as the JAX package
        does: dense where it fits, K-blocked where the unfused path's (K, N)
        matrices would crowd 12 GiB, unfused otherwise.
    """
    reduce = _identity if reduce is None else reduce
    samples_T = samples if transposed else samples.T
    samples_T = samples_T.contiguous()
    dim, N = samples_T.shape
    K = params.K
    dtype = samples_T.dtype

    if weights is None:
        w = torch.ones((N,), dtype=dtype, device=samples_T.device)
        weight_normalization = reduce(torch.tensor(float(N), dtype=dtype,
                                                   device=samples_T.device))
    else:
        w = weights.to(dtype).contiguous()
        weight_normalization = reduce(torch.sum(w))

    live = params.weights > 0
    if latent is not None and mincount > 0:
        count = reduce(torch.bincount(latent.long(), minlength=K))
        live = live & (count >= mincount)

    dof_stats = params.is_student_t and bool(dof_solver_steps)
    fused_mode = _fused_mode(fused, "fused_pmc_stats", K, dim, N, samples_T, rb=rb)

    if fused_mode:
        # one pass: responsibilities, gamma and every statistic per tile;
        # second moments arrive in whitened coordinates
        kernel = _k.fused_pmc_stats if fused_mode == "dense" else _k.fused_pmc_stats_blocked
        stats = kernel(samples_T, w, _core._kernel_operands(params), dof_stats)
        alpha, mu, cov, const = _moments_from_whitened_stats(
            params, stats, weight_normalization, reduce, dof_stats)
        rho = None
    else:
        if rb:
            rho = calculate_rho_rb_T(params, samples_T)
        else:
            rho = _rho_non_rb_T(params, latent, K)

        wrho = w[None, :] * rho
        alpha_unnorm = reduce(torch.sum(wrho, dim=1))
        inv_unnorm_alpha = 1.0 / regularize(alpha_unnorm)
        alpha = alpha_unnorm / weight_normalization

        if params.is_student_t:
            # gamma pass with the OLD parameters (``pmc.pyx:601-610``)
            maha_old = _core.mahalanobis_all_T(params, samples_T)
            nu = params.dof[:, None]
            gamma = (nu + dim) / (nu + maha_old)
            c_mu = wrho * gamma
            mu_norm = 1.0 / regularize(reduce(torch.sum(c_mu, dim=1)))
            mu = reduce(c_mu @ samples_T.T) * mu_norm[:, None]
            cov = reduce(_cov_sums_T(samples_T, c_mu, mu)) * inv_unnorm_alpha[:, None, None]
        else:
            mu = reduce(wrho @ samples_T.T) * inv_unnorm_alpha[:, None]
            cov = reduce(_cov_sums_T(samples_T, wrho, mu)) * inv_unnorm_alpha[:, None, None]

        const = None
        if dof_stats:
            nu_old = params.dof[:, None]
            b = maha_old
            xi = rho * (torch.log(0.5 * (b + nu_old))
                        - torch.special.digamma(0.5 * (dim + nu_old))) \
                + (1.0 - rho) * (torch.log(0.5 * nu_old)
                                 - torch.special.digamma(0.5 * nu_old))
            delta = rho * (dim + nu_old) / (b + nu_old) + (1.0 - rho)
            const = 1.0 - reduce((xi + delta) @ w) / weight_normalization

    new_params, ok = _masked_update(params, alpha, mu, cov, const, live,
                                    dof_solver_steps, mindof, maxdof)
    return PMCResult(params=new_params, rho=rho, updated_ok=ok, live=live)


def _masked_update(params, alpha, mu, cov, const, live, dof_solver_steps,
                   mindof, maxdof):
    """Solve the dofs (when the dof-condition constant ``const`` is given;
    kernel ``solve_dofs``, the bisection the JAX package runs inside its
    jitted step),
    zero the weights of components that are not ``live``, and apply the
    update with the PSD-validity fallback of
    :func:`~pypmc_tpu_torch.density.core.update_masked`."""
    new_dofs = params.dof
    if const is not None:
        new_dofs = _k.solve_dofs(const, params.dof, dof_solver_steps, mindof, maxdof)
    new_weights = torch.where(live, alpha, torch.zeros_like(alpha))
    return _core.update_masked(params, mu, cov, new_weights, new_dofs=new_dofs,
                               update_mask=live)


def _moments_from_whitened_stats(params, stats, weight_normalization, reduce,
                                 dof_stats):
    """Map the fused statistics (whitened coordinates) to the [Cap+08] eq.
    (14) moment updates and the [HOD12] dof-condition constant through the
    known Cholesky factors -- exact linear algebra, no extra particle pass."""
    dtype = params.means.dtype
    alpha_unnorm = reduce(stats["s0"].to(dtype))
    s0c = reduce(stats["s0c"].to(dtype))
    sd = reduce(stats["sd"].to(dtype))
    g = reduce(stats["g"].to(dtype))
    inv_unnorm_alpha = 1.0 / regularize(alpha_unnorm)
    alpha = alpha_unnorm / weight_normalization
    d_shift = (params.chol @ sd[:, :, None])[:, :, 0] / regularize(s0c)[:, None]
    mu = params.means + d_shift
    sxx = params.chol @ g @ params.chol.transpose(1, 2)
    cov = (sxx - s0c[:, None, None] * d_shift[:, None, :] * d_shift[:, :, None]) \
        * inv_unnorm_alpha[:, None, None]
    const = None
    if dof_stats:
        nu_old = params.dof
        c2 = torch.log(0.5 * nu_old) - torch.special.digamma(0.5 * nu_old) + 1.0
        sxd = reduce(stats["t1"].to(dtype)) + c2 * (weight_normalization - alpha_unnorm)
        const = 1.0 - sxd / weight_normalization
    return alpha, mu, cov, const


def pmc_step_mixture_target(
    params: _core.MixtureParams,
    target_params: _core.MixtureParams,
    key,
    n: int,
    dof_solver_steps: int = 100,
    mindof: float = 1e-5,
    maxdof: float = 1e3,
    reduce: Optional[Callable] = None,
    fused: str = "auto",
):
    """One complete (M-)PMC step against a MIXTURE target -- propose,
    evaluate proposal and target, weight, Rao-Blackwellized
    responsibilities, gamma pass and every sufficient statistic -- in one
    call: kernel ``fused_is_pmc_step`` (``fused_is_pmc_step_blocked`` past
    its one tile) on CUDA float32, its plain version on the CPU.
    ``fused="off"``, and ``"auto"`` where the JAX package takes XLA,
    compose :func:`~pypmc_tpu_torch.density.core.propose_logq_T` with
    :func:`pmc_update` (same math, two passes); ``fused`` is otherwise as
    in :func:`pmc_update`, with the K-blocked rule counting the target's
    components too.

    ``key`` is an int seed or a ``torch.Generator`` (advanced by two seed
    words).

    :returns: ``(result, samples_T (D, n), weights (n,), latent (n,),
        sw (3,))`` with ``sw`` the global ``[sum w, sum w^2, sum w log w]``.
    """
    reduce = _identity if reduce is None else reduce
    dof_stats = params.is_student_t and bool(dof_solver_steps)
    fused_mode = _fused_mode(fused, "fused_is_pmc_step", params.K, params.dim, n,
                             params.means, target_params.K)

    if not fused_mode:
        samples_T, latent, log_q, log_p = _core.propose_logq_T(
            params, key, n, target_params)
        w = torch.exp(log_p - log_q)
        result = pmc_update(
            params, samples_T, w, rb=True,
            dof_solver_steps=dof_solver_steps if params.is_student_t else 0,
            mindof=mindof, maxdof=maxdof, reduce=reduce, transposed=True)
        sw = reduce(torch.stack([w.sum(), (w * w).sum(),
                                 torch.special.xlogy(w, w).sum()]))
        return result, samples_T, w, latent, sw

    kernel = _k.fused_is_pmc_step if fused_mode == "dense" else _k.fused_is_pmc_step_blocked
    samples_T, latent, w, stats = kernel(
        _rng.seed_words(key), _core._kernel_operands(params),
        _core._kernel_operands(target_params), n, dof_stats)
    sw = reduce(stats["sw"].to(params.means.dtype))
    live = params.weights > 0
    alpha, mu, cov, const = _moments_from_whitened_stats(
        params, stats, sw[0], reduce, dof_stats)
    new_params, ok = _masked_update(params, alpha, mu, cov, const, live,
                                    dof_solver_steps, mindof, maxdof)
    result = PMCResult(params=new_params, rho=None, updated_ok=ok, live=live)
    return result, samples_T, w, latent, sw


def pmc_log_likelihood(params: _core.MixtureParams, samples,
                       normalized_weights=None, reduce: Optional[Callable] = None,
                       transposed: bool = False):
    """Log likelihood according to eq. (5) in [Cap+08] (``pmc.pyx:371-391``):
    the weighted mean of ``log q(x_n)``."""
    reduce = _identity if reduce is None else reduce
    if transposed:
        log_q = _core.mixture_logpdf_T(params, samples)
    else:
        log_q = _core.mixture_logpdf(params, samples)
    if normalized_weights is None:
        return reduce(torch.sum(log_q)) / reduce(torch.tensor(
            float(log_q.shape[0]), dtype=log_q.dtype, device=log_q.device))
    return reduce(torch.sum(log_q * normalized_weights))


# --------------------------------------------------------------------- #
# the reference's host API                                              #
# --------------------------------------------------------------------- #

def _check_pmc_args(samples, weights, latent, mincount, rb):
    if weights is not None:
        weights = weights.cpu().numpy() if isinstance(weights, torch.Tensor) \
            else _np.asarray(weights)
        assert len(weights.shape) == 1, "expected a 1-D weight vector"
        assert len(weights) == len(samples), (
            "weight count %s != sample count %s" % (len(weights), len(samples)))
    if latent is None:
        if mincount > 0:
            raise ValueError("mincount requires latent component indices; pass latent= "
                             "or set mincount=0")
        if not rb:
            raise ValueError("non-Rao-Blackwellized updates need latent component "
                             "indices; pass latent= or keep rb=True")
    return weights


def _check_mixture(density):
    if not (isinstance(density, MixtureDensity) and density.kind in ("gauss", "student_t")):
        raise TypeError(
            "``density`` must be a ``pypmc_tpu_torch.density.mixture.MixtureDensity`` "
            "with ``pypmc_tpu_torch.density.gauss.Gauss`` or "
            "``pypmc_tpu_torch.density.student_t.StudentT`` components")


def _log_failed(result):
    failed = (result.live & ~result.updated_ok).cpu().numpy()
    for k in _np.flatnonzero(failed):
        logger.warning("covariance update failed for component %i; zeroing its weight", k)


class _Particles(object):
    """Samples, weights and latent indices of one PMC update on the device,
    the samples transposed: tensors keep their device, host arrays go to
    ``device`` (default: :func:`pypmc_tpu_torch.default_device`) in the
    working dtype there."""

    def __init__(self, samples, weights, latent, device):
        samples = _device.as_tensor(samples, device)
        self.samples_T = samples.T.contiguous()
        self.device, self.dtype = samples.device, samples.dtype
        self.weights = None if weights is None else _device.as_tensor(
            weights, self.device, self.dtype)
        self.latent = None if latent is None else torch.as_tensor(
            _np.asarray(latent.cpu() if isinstance(latent, torch.Tensor) else latent),
            device=self.device)

    def params(self, density):
        return density.stacked_params(dtype=self.dtype, device=self.device)


def _apply_pmc(density, samples, weights, latent, rb, mincount, copy, device, **kwargs):
    _check_pmc_args(samples, weights, latent, mincount, rb)
    if copy:
        density = _cp(density)
    part = _Particles(samples, weights, latent, device)
    result = pmc_update(part.params(density), part.samples_T, part.weights, part.latent,
                        rb=rb, mincount=int(mincount), transposed=True, **kwargs)
    _log_failed(result)
    density.set_params(result.params)
    return density


def gaussian_pmc(samples, density, weights=None, latent=None, rb=True,
                 mincount=0, copy=True, device=None):
    """Adapt a Gaussian mixture ``density`` with one (M-)PMC update
    ([Cap+08], [Kil+09]) and return the updated density.
    (Reference: ``mix_adapt/pmc.pyx:120-246``.)

    :param samples: ``(N, D)`` samples proposed by ``density``; host arrays
        go to ``device`` (default: :func:`pypmc_tpu_torch.default_device`).
    :param density: :class:`~pypmc_tpu_torch.density.mixture.MixtureDensity`
        with :class:`~pypmc_tpu_torch.density.gauss.Gauss` components.
    :param weights: optional ``(N,)`` unnormalized importance weights.
    :param latent: optional ``(N,)`` generating-component indices.
    :param rb: Rao-Blackwellize over components (True) or use ``latent``
        one-hot (False; requires ``latent``).
    :param mincount: kill components with fewer than this many samples
        (requires ``latent``).
    :param copy: if True (default) leave ``density`` untouched and return an
        updated copy; else update in place.
    """
    return _apply_pmc(density, samples, weights, latent, rb, mincount, copy, device,
                      dof_solver_steps=0)


def student_t_pmc(samples, density, weights=None, latent=None, rb=True,
                  dof_solver_steps=100, mindof=1e-5, maxdof=1e3,
                  mincount=0, copy=True, device=None):
    """Adapt a Student-t mixture ``density`` with one (M-)PMC update
    ([Cap+08], [Kil+09], [HOD12]) and return the updated density.
    (Reference: ``mix_adapt/pmc.pyx:499-739``.)

    :param dof_solver_steps: bisection iterations for the per-component
        degree-of-freedom first-order condition; 0 keeps the dof fixed.
    :param mindof, maxdof: dof search interval; the root is clamped into it.

    Other parameters as in :func:`gaussian_pmc`.
    """
    return _apply_pmc(density, samples, weights, latent, rb, mincount, copy, device,
                      dof_solver_steps=int(dof_solver_steps),
                      mindof=float(mindof), maxdof=float(maxdof))


class PMC(object):
    """Adapt a Gaussian or Student-t mixture with repeated (M-)PMC updates
    on the same samples, monitoring the [Cap+08] eq. (5) log-likelihood for
    convergence.  (Reference: ``mix_adapt/pmc.pyx:248-476``.)

    :param samples: ``(N, D)`` array of samples, kept once on the device,
        transposed (host arrays go to ``device``, default
        :func:`pypmc_tpu_torch.default_device`, in the working dtype there).
    :param density: :class:`~pypmc_tpu_torch.density.mixture.MixtureDensity`
        with Gauss or StudentT components (always copied).
    :param weights, latent, rb, mincount: see :func:`gaussian_pmc`.

    Additional keyword arguments are passed to the underlying PMC update
    (e.g. ``dof_solver_steps`` for Student-t).
    """

    def __init__(self, samples, density, weights=None, latent=None, rb=True,
                 mincount=0, device=None, **kwargs):
        self.weights = _check_pmc_args(samples, weights, latent, mincount, rb)
        _check_mixture(density)
        self.density = _cp(density)
        self.samples = samples
        self.latent = latent
        self.rb = rb
        self.mincount = mincount
        self.additional_args = kwargs
        self._part = _Particles(samples, weights, latent, device)
        self.normalized_weights = (None if self.weights is None
                                   else self.weights / self.weights.sum())
        self._normalized_weights_dev = (None if self._part.weights is None else
                                        self._part.weights / torch.sum(self._part.weights))

    def log_likelihood(self):
        """Log likelihood of the current density, eq. (5) in [Cap+08]."""
        return float(pmc_log_likelihood(self._part.params(self.density),
                                        self._part.samples_T,
                                        self._normalized_weights_dev, transposed=True))

    def _update_once(self):
        """One PMC update on the kept particles; mutates ``self.density``."""
        kwargs = dict(self.additional_args)
        if self.density.kind != "student_t":
            kwargs.setdefault("dof_solver_steps", 0)
        result = pmc_update(self._part.params(self.density), self._part.samples_T,
                            self._part.weights, self._part.latent, rb=self.rb,
                            mincount=int(self.mincount), transposed=True, **kwargs)
        _log_failed(result)
        self.density.set_params(result.params)

    def run(self, iterations=1000, prune=0.0, rel_tol=1e-10, abs_tol=1e-5):
        r"""Run PMC updates until convergence of the log-likelihood
        (reference protocol, ``pmc.pyx:393-476``: converge only if the bound
        increased, never on an iteration that changed the number of live
        components; ``prune`` removes components below that weight threshold
        after every update).

        Return the number of iterations at convergence, or None.
        """
        old_K = None
        bound = None
        for i in range(1, iterations + 1):
            if old_K == len(self.density):
                old_bound = bound
            else:
                old_bound = self.log_likelihood()
                logger.info("K changed to %i; fresh log-likelihood %g",
                            len(self.density), old_bound)

            self._update_once()
            bound = self.log_likelihood()
            logger.info("PMC iteration %d: log-likelihood %.15g with %i live "
                        "component(s), weights %s",
                        i, bound, len(self.density), self.density.weights)
            if bound < old_bound:
                logger.warning("log-likelihood dropped this iteration (%g -> %g)",
                               old_bound, bound)
            if bound == old_bound:
                return i
            diff = bound - old_bound
            if diff > 0:
                if abs(bound) < abs_tol:
                    if abs(diff) < abs_tol:
                        return i
                elif abs(diff / bound) < rel_tol:
                    return i

            old_K = len(self.density)
            self.density.prune(prune)
            self.density.normalize()
        return None
