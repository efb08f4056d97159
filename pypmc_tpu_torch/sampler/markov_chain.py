"""Markov-chain (adaptive Metropolis) sampling.

Counterpart of :mod:`pypmc_tpu.sampler.markov_chain` (the reference's
``pypmc/sampler/markov_chain.py``).  :class:`MarkovChain` runs one chain:
with a numpy generator on the host, step by step as the reference does;
otherwise as tensor steps on its device with all randomness drawn before
the loop (the JAX package's ``lax.scan``).  :func:`sample_adaptive_chains`
runs C chains at once, adapting each chain's proposal covariance between
cycles with the [HST01] rule as batched tensor code.  Against a mixture
target in float32 a cycle is one launch of kernel ``fused_mcmc_pool``
(``ops.kernels``), where the JAX package runs its Pallas pool; otherwise
the tensor pool steps all chains together.  The single chain's steps and
the tensor pool's run as a :class:`~pypmc_tpu_torch.sampler._scan.Scan`:
CUDA graphs of up to ``_scan.CHUNK`` steps replayed on the card, the JAX
package's compiled ``lax.scan``.

Targets take a tensor point ``x (D,)`` on the chain's device (or a batch,
when marked with :func:`~pypmc_tpu_torch.sampler.batched_target`).
"""

import functools
import logging
from copy import deepcopy as _cp

import numpy as _np
import torch

from .. import _device, _rng
from ..density import core as _core
from ..density.gauss import LocalGauss
from ..density.student_t import LocalStudentT
from ..ops import kernels as _k
from ..ops import random as _random
from ..tools import History as _History
from ..tools.indicator import merge_function_with_indicator as _indmerge
from . import _scan
from ._target import batched_target, evaluate_target, is_batched, is_transposed

logger = logging.getLogger(__name__)

__all__ = ["MarkovChain", "AdaptiveMarkovChain", "sample_adaptive_chains"]

_NAN_MESSAGE = "target returned NaN (pass continue_on_NaN=True to reject such proposals)"


def _point_target(target):
    """A per-point callable from any target form."""
    if not is_batched(target):
        return target
    if is_transposed(target):
        return lambda x: target(x[:, None])[0]
    return lambda x: target(x[None, :])[0]


def _chain_steps(target, xs, ys, carry, consts, strict):
    """``len(log_u)`` Metropolis steps of one chain from the proposal
    steps ``delta`` (the JAX package's ``step``, ``markov_chain.py:49-64``),
    in place on ``carry = (current, current_eval, accepts, nans)``; the
    visited points and their log-densities into ``ys``."""
    delta, log_u = xs
    points, evals = ys
    current, current_eval, accepts, nans = carry
    cur, cur_eval = current, current_eval
    for i in range(log_u.shape[0]):
        proposed = cur + delta[i]
        value = target(proposed)
        if strict:
            _scan.check_capturable(value, cur)
        proposed_eval = torch.as_tensor(value, dtype=cur.dtype, device=cur.device)
        log_rho = proposed_eval - cur_eval
        is_nan = torch.isnan(log_rho)
        # accept on log_rho >= 0 or log_rho > log u (STRICT, so a
        # zero-probability proposal is never accepted when u draws 0)
        accept = ~is_nan & ((log_rho >= 0) | (log_rho > log_u[i]))
        cur = torch.where(accept, proposed, cur)
        cur_eval = torch.where(accept, proposed_eval, cur_eval)
        points[i] = cur
        evals[i] = cur_eval
        accepts += accept
        nans |= is_nan
    current.copy_(cur)
    current_eval.copy_(cur_eval)


class MarkovChain(object):
    r"""A Markov chain to generate samples from the target density.
    (Reference: ``markov_chain.py:12-175``.)

    :param target: The log target density: a callable ``x -> log P(x)`` on
        a tensor point.
    :param proposal: The local proposal density ``q``; a
        :class:`~pypmc_tpu_torch.density.gauss.LocalGauss` or
        :class:`~pypmc_tpu_torch.density.student_t.LocalStudentT` runs as
        tensor steps on the device; any other
        :class:`~pypmc_tpu_torch.density.base.LocalDensity` (including
        asymmetric ones, with the Metropolis-Hastings ratio) on the host.
    :param start: The starting point (finite target value, inside the
        indicator).
    :param indicator: Support predicate; points outside are rejected
        (target ``-inf``).
    :param prealloc: Number of samples to preallocate History memory for.
    :param save_target_values: If True, store ``log P`` at every visited
        point in ``self.target_values``.
    :param rng: int seed, ``torch.Generator`` or None (the device path), or a
        numpy generator (the host path, the reference's draws).
    :param device: where the target is evaluated (default:
        :func:`pypmc_tpu_torch.default_device`; a tensor ``start`` gives
        its own), in the working dtype there.
    """

    def __init__(self, target, proposal, start, indicator=None,
                 prealloc=0, save_target_values=False, rng=None, device=None):
        if isinstance(start, torch.Tensor) and device is None:
            device = start.device
        self.device = _device.default_device(device)
        self.dtype = _device.working_dtype(self.device)
        start = start.cpu().numpy() if isinstance(start, torch.Tensor) else start
        self.current_point = _np.array(start, dtype=float)
        self.samples = _History(len(self.current_point), prealloc)
        self.proposal = _cp(proposal)
        self.target = _point_target(_indmerge(target, indicator, -_np.inf))
        self.target_values = _History(1, prealloc) if save_target_values else None
        self.current_target_eval = self._evaluate(self.current_point)
        if not _np.isfinite(self.current_target_eval):
            raise ValueError(
                "``target(start)`` must evaluate to a finite value and "
                "``indicator(start)`` must be ``True``"
            )
        self._numpy_rng = rng if _rng.is_numpy_rng(rng) else None
        self._gen = None if self._numpy_rng is not None else _rng.as_generator(rng)
        self._scan = None

    def _tensor(self, x):
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def _evaluate(self, point):
        return float(self.target(self._tensor(point)))

    def clear(self):
        """Clear the history of visited points; the current chain state is
        untouched."""
        self.samples.clear()
        if self.target_values is not None:
            self.target_values.clear()

    def _device_capable(self):
        return self._numpy_rng is None and isinstance(self.proposal, (LocalGauss,
                                                                      LocalStudentT))

    def run(self, N=1, continue_on_NaN=False):
        """Run the chain for ``N`` steps; store visited points into
        ``self.samples``; return the number of accepted proposals.

        :param continue_on_NaN: if False (default), raise ``ValueError`` when
            the target evaluates to NaN at a proposed point (nothing is
            stored); if True, reject such points and continue.
        """
        if N == 0:
            return 0
        if self._device_capable():
            return self._run_device(N, continue_on_NaN)
        return self._run_host(N, continue_on_NaN)

    def _run_device(self, N, continue_on_NaN):
        """Tensor steps on the device, all randomness drawn first, run by
        the chain's :class:`~pypmc_tpu_torch.sampler._scan.Scan` (CUDA
        graphs on the card, kept for the chain's later runs)."""
        gen = _rng.device_generator(_rng.seed_words(self._gen), self.device)
        D = len(self.current_point)
        z = torch.randn((N, D), generator=gen, dtype=self.dtype, device=self.device)
        log_u = torch.log(torch.rand((N,), generator=gen, dtype=self.dtype,
                                     device=self.device))
        if isinstance(self.proposal, LocalStudentT):
            dof = torch.full((N,), self.proposal.dof, dtype=self.dtype, device=self.device)
            z = z * torch.sqrt(dof / _random.chisquare(gen, dof, (N,)))[:, None]
        delta = z @ self._tensor(self.proposal.cholesky_sigma).T
        points = torch.empty((N, D), dtype=self.dtype, device=self.device)
        evals = torch.empty((N,), dtype=self.dtype, device=self.device)
        carry = (self._tensor(self.current_point), self._tensor(self.current_target_eval),
                 torch.zeros((), dtype=torch.int64, device=self.device),
                 torch.zeros((), dtype=torch.bool, device=self.device))
        if self._scan is None:
            self._scan = _scan.Scan(functools.partial(_chain_steps, self.target))
        current, current_eval, accepts, nans = self._scan.run((delta, log_u), (points, evals),
                                                              carry)
        if bool(nans) and not continue_on_NaN:
            raise ValueError(_NAN_MESSAGE)
        self.samples.append(N)[:] = points.cpu().numpy()
        if self.target_values is not None:
            self.target_values.append(N)[:, 0] = evals.cpu().numpy()
        self.current_point = current.cpu().numpy().astype(float)
        self.current_target_eval = float(current_eval)
        return int(accepts)

    def _run_host(self, N, continue_on_NaN):
        """Host loop: generic/asymmetric proposals or a numpy rng
        (reference hot loop, ``markov_chain.py:100-165``); the Histories
        are appended only after the loop, so a NaN raised mid-run leaves
        nothing behind."""
        rng = self._numpy_rng if self._numpy_rng is not None else _rng.RNG_DEFAULT
        symmetric = getattr(self.proposal, "symmetric", False)
        this_run = _np.empty((N, len(self.current_point)))
        this_target_values = _np.empty((N, 1)) if self.target_values is not None else None
        accept_count = 0
        for i_N in range(N):
            proposed_point = _np.asarray(self.proposal.propose(self.current_point, rng))
            proposed_eval = self._evaluate(proposed_point)
            log_rho = proposed_eval - self.current_target_eval
            if not symmetric:  # Metropolis-Hastings correction
                log_rho -= float(self.proposal.evaluate(proposed_point, self.current_point))
                log_rho += float(self.proposal.evaluate(self.current_point, proposed_point))
            if _np.isnan(log_rho):
                if not continue_on_NaN:
                    raise ValueError(_NAN_MESSAGE)
                this_run[i_N] = self.current_point
            elif log_rho >= 0 or log_rho > _np.log(rng.rand()):
                accept_count += 1
                this_run[i_N] = proposed_point
                self.current_point = proposed_point
                self.current_target_eval = proposed_eval
            else:
                this_run[i_N] = self.current_point
            if self.target_values is not None:
                this_target_values[i_N] = self.current_target_eval
        self.samples.append(N)[:] = this_run
        if self.target_values is not None:
            self.target_values.append(N)[:] = this_target_values
        return accept_count


class AdaptiveMarkovChain(MarkovChain):
    r"""A Markov chain with [HST01] proposal-covariance adaptation.
    (Reference: ``markov_chain.py:177-402``.)

    Between runs, :meth:`adapt` combines the sample covariance of the last
    run with the previous estimate using a damping weight ``1/t^damping``,
    and rescales by ``covar_scale_factor`` which is multiplied/divided by
    ``covar_scale_multiplier`` to force the acceptance rate into
    ``[force_acceptance_min, force_acceptance_max]``.
    """

    _ADAPT_PARAMS = ("covar_scale_multiplier", "covar_scale_factor",
                     "covar_scale_factor_max", "covar_scale_factor_min",
                     "force_acceptance_max", "force_acceptance_min", "damping")

    def __init__(self, *args, **kwargs):
        self.adapt_count = 1
        self.covar_scale_multiplier = kwargs.pop("covar_scale_multiplier", 1.5)
        self.covar_scale_factor = kwargs.pop("covar_scale_factor", None)
        self.covar_scale_factor_max = kwargs.pop("covar_scale_factor_max", 100.0)
        self.covar_scale_factor_min = kwargs.pop("covar_scale_factor_min", 0.0001)
        self.force_acceptance_max = kwargs.pop("force_acceptance_max", 0.35)
        self.force_acceptance_min = kwargs.pop("force_acceptance_min", 0.15)
        self.damping = kwargs.pop("damping", 0.5)

        super(AdaptiveMarkovChain, self).__init__(*args, **kwargs)

        if self.covar_scale_factor is None:
            self.covar_scale_factor = 2.38**2 / len(self.current_point)
        self.unscaled_sigma = _np.asarray(self.proposal.sigma) / self.covar_scale_factor

    def run(self, N=1, continue_on_NaN=False):
        if N == 0:
            return 0
        self._last_accept_count = super(AdaptiveMarkovChain, self).run(N, continue_on_NaN)
        return self._last_accept_count

    def set_adapt_params(self, *args, **kwargs):
        r"""Set the variables for covariance adaptation:
        ``covar_scale_multiplier``, ``covar_scale_factor``,
        ``covar_scale_factor_max/min``, ``force_acceptance_max/min``,
        ``damping``.  (Reference: ``markov_chain.py:217-342``.)"""
        if args != ():
            raise TypeError("positional arguments are not accepted; use "
                            "set_adapt_params(name=value)")
        for name in self._ADAPT_PARAMS:
            setattr(self, name, kwargs.pop(name, getattr(self, name)))
        if kwargs:
            raise TypeError("unknown adaptation parameter(s): " + str(kwargs.keys()))

    def adapt(self):
        r"""Update the proposal covariance using the points of the last run
        ([HST01] damped estimate + acceptance-band rescaling).  Falls back
        full -> diagonal -> shrink-old on a covariance that is not positive
        definite.  (Reference: ``markov_chain.py:345-391``.)"""
        last_run = self.samples[-1]
        accept_rate = float(self._last_accept_count) / len(last_run)
        covar_estimator = _np.cov(last_run, rowvar=0)
        a_t = 1.0 / self.adapt_count**self.damping
        self.unscaled_sigma = (1 - a_t) * self.unscaled_sigma + a_t * covar_estimator
        self._update_scale_factor(accept_rate)
        scaled_sigma = self.covar_scale_factor * self.unscaled_sigma
        self.adapt_count += 1

        try:
            self.proposal.update(scaled_sigma)
        except _np.linalg.LinAlgError:
            logger.warning("full-covariance proposal update was not PD; retrying "
                           "with the diagonal only")
            try:
                self.proposal.update(_np.diag(_np.diag(scaled_sigma)))
                logger.warning("diagonal-only update accepted")
            except _np.linalg.LinAlgError:
                logger.warning("diagonal-only update not PD either; shrinking the "
                               "old covariance")
                self.proposal.update(self.proposal.sigma / self.covar_scale_multiplier)

    def _update_scale_factor(self, accept_rate):
        """Multiply/divide ``covar_scale_factor`` to force the acceptance
        rate into the configured band, within its limits."""
        if (accept_rate > self.force_acceptance_max
                and self.covar_scale_factor < self.covar_scale_factor_max):
            self.covar_scale_factor *= self.covar_scale_multiplier
        elif (accept_rate < self.force_acceptance_min
              and self.covar_scale_factor > self.covar_scale_factor_min):
            self.covar_scale_factor /= self.covar_scale_multiplier


# --------------------------------------------------------------------- #
# the chain pool                                                        #
# --------------------------------------------------------------------- #

def _cholesky_or_nan(m):
    """Batched lower Cholesky factors, and a mask of the matrices that had
    one (``cholesky_ex``'s ``info == 0`` and a finite factor); the others'
    factors are NaN."""
    chol, info = torch.linalg.cholesky_ex(m)
    ok = (info == 0) & torch.isfinite(chol).all(dim=-1).all(dim=-1)
    return torch.where(ok[:, None, None], chol, torch.full_like(chol, float("nan"))), ok


def _adapt_pool(unscaled, scale_factors, chols, points, rates, cycle, p):
    """The [HST01] adaptation of every chain at once (the JAX package's
    ``adapt_step`` vmapped, ``markov_chain.py:421-445``, and its shrink-old
    fallback): the damped covariance estimate, the acceptance-band
    rescaling, then the new Cholesky factor -- of the full matrix, else of
    its diagonal, else of the old covariance shrunk by the multiplier.
    ``points`` is ``(C, n, D)``."""
    n = points.shape[1]
    diff = points - points.mean(dim=1, keepdim=True)
    covar = torch.einsum("cni,cnj->cij", diff, diff) / (n - 1)
    a_t = 1.0 / (cycle + 1.0) ** p["damping"]
    unscaled = (1 - a_t) * unscaled + a_t * covar
    grow = (rates > p["force_acceptance_max"]) & (scale_factors < p["covar_scale_factor_max"])
    shrink = (rates < p["force_acceptance_min"]) & (scale_factors > p["covar_scale_factor_min"])
    mult = p["covar_scale_multiplier"]
    scale_factors = torch.where(grow, scale_factors * mult,
                                torch.where(shrink, scale_factors / mult, scale_factors))
    scaled = scale_factors[:, None, None] * unscaled
    full, ok_full = _cholesky_or_nan(scaled)
    diag, ok_diag = _cholesky_or_nan(torch.diag_embed(torch.diagonal(scaled, dim1=-2, dim2=-1)))
    shrunk, _ = _cholesky_or_nan(chols @ chols.transpose(-1, -2) / mult)
    chols = torch.where(ok_full[:, None, None], full,
                        torch.where(ok_diag[:, None, None], diag, shrunk))
    return unscaled, scale_factors, chols


def _pool_steps(pool_target, xs, ys, carry, consts, strict):
    """``len(log_u)`` steps of every chain of the tensor pool against
    ``pool_target``, a batched function of ``(C, D)`` (the JAX package's
    ``all_chains_cycle`` step, ``markov_chain.py:386-419``), in place on
    ``carry = (current, current_eval, accepts, nans)``; the visited points
    into ``ys``; ``consts`` the chains' proposal factors."""
    z, log_u = xs
    (points,) = ys
    current, current_eval, accepts, nans = carry
    (chols,) = consts
    cur, cur_eval = current, current_eval
    for s in range(log_u.shape[0]):
        proposed = cur + torch.einsum("cde,ce->cd", chols, z[s])
        proposed_eval = pool_target(proposed)
        if strict:
            _scan.check_capturable(proposed_eval, cur)
        log_rho = proposed_eval - cur_eval
        is_nan = torch.isnan(log_rho)
        accept = ~is_nan & ((log_rho >= 0) | (log_rho > log_u[s]))
        cur = torch.where(accept[:, None], proposed, cur)
        cur_eval = torch.where(accept, proposed_eval, cur_eval)
        points[s] = cur
        accepts += accept.to(cur.dtype)
        nans += is_nan.sum()
    current.copy_(cur)
    current_eval.copy_(cur_eval)


def _tensor_cycle(gen, scan, current, current_eval, chols, n, dof):
    """One cycle of the tensor pool (the JAX package's
    ``all_chains_cycle``, ``markov_chain.py:386-419``): all randomness drawn
    first, then ``n`` steps of every chain by ``scan``, a
    :class:`~pypmc_tpu_torch.sampler._scan.Scan` of :func:`_pool_steps`.
    Returns ``(points (C, n, D), rates (C,), nan count (), current,
    current_eval)``."""
    C, D = current.shape
    dtype, device = current.dtype, current.device
    z = torch.randn((n, C, D), generator=gen, dtype=dtype, device=device)
    log_u = torch.log(torch.rand((n, C), generator=gen, dtype=dtype, device=device))
    if dof is not None:
        dofs = torch.full((n, C), float(dof), dtype=dtype, device=device)
        z = z * torch.sqrt(dofs / _random.chisquare(gen, dofs, (n, C)))[..., None]
    points = torch.empty((n, C, D), dtype=dtype, device=device)
    carry = (current, current_eval, torch.zeros((C,), dtype=dtype, device=device),
             torch.zeros((), dtype=torch.int64, device=device))
    current, current_eval, accepts, nans = scan.run((z, log_u), (points,), carry, (chols,))
    return points.permute(1, 0, 2), accepts / n, nans, current, current_eval


def sample_adaptive_chains(target, starts, sigma0, n_steps, n_adapt_cycles,
                           key=None, dof=None, indicator=None,
                           continue_on_NaN=False, device=None, **adapt_kwargs):
    """Multi-chain adaptive Metropolis: ``C`` chains run together, each
    chain's proposal covariance adapted between cycles with the [HST01]
    rule.  (Replaces the reference pattern of one Python object per chain,
    ``examples/uniting_markov_chains_and_variational_bayes.py:72-87``.)

    :param target: a callable ``x -> log P(x)`` (or a batched target), or a
        :class:`~pypmc_tpu_torch.density.core.MixtureParams`: in float32 and
        within the JAX package's rule for its pool
        (:func:`~pypmc_tpu_torch.ops.kernels.fits`), each cycle of a mixture
        target is ONE launch of kernel ``fused_mcmc_pool``; anything else
        runs the tensor pool.
    :param starts: ``(C, D)`` starting points (each must have a finite
        target); a tensor keeps its device and dtype (a mixture target is
        moved to them), host data goes to ``device`` (default:
        :func:`pypmc_tpu_torch.default_device`) in a mixture target's dtype,
        else the working dtype there.
    :param sigma0: ``(D, D)`` or ``(C, D, D)`` initial proposal covariance.
    :param n_steps: steps per adaptation cycle.
    :param n_adapt_cycles: number of cycles; total steps = product.
    :param key: int seed, ``torch.Generator`` or None (seed 0).
    :param dof: Student-t proposal dof (scalar) or None for Gaussian.
    :param indicator: optional predicate ``x -> bool``; proposals outside
        its support evaluate to ``-inf`` and are always rejected.  A mixture
        target with an indicator runs the tensor pool.
    :param continue_on_NaN: as :meth:`MarkovChain.run`: False (default)
        raises ``ValueError`` after the run if any proposal's target value
        was NaN (checked with one synchronization for the whole run); True
        rejects such proposals.

    Returns ``(samples (C, n_adapt_cycles*n_steps, D), accept_rates (C,
    n_adapt_cycles))`` on the chains' device.
    """
    p = {"covar_scale_multiplier": 1.5, "covar_scale_factor_max": 100.0,
         "covar_scale_factor_min": 0.0001, "force_acceptance_max": 0.35,
         "force_acceptance_min": 0.15, "damping": 0.5}
    mix_target = target if isinstance(target, _core.MixtureParams) else None
    if isinstance(starts, torch.Tensor):
        device = starts.device
    device = _device.default_device(device)
    if not isinstance(starts, torch.Tensor):
        dtype = (mix_target.means.dtype if mix_target is not None
                 else _device.working_dtype(device))
        starts = torch.as_tensor(_np.asarray(starts), dtype=dtype, device=device)
    C, D = starts.shape
    covar_scale_factor = adapt_kwargs.pop("covar_scale_factor", 2.38**2 / D)
    for name in p:
        p[name] = adapt_kwargs.pop(name, p[name])
    if adapt_kwargs:
        raise TypeError("unknown adaptation parameter(s): " + str(adapt_kwargs.keys()))
    gen = _rng.as_generator(0 if key is None else key)

    if mix_target is not None:
        mix_target = mix_target.to(device=device, dtype=starts.dtype)
        pool_target = batched_target(lambda x, _mt=mix_target: _core.mixture_logpdf(_mt, x))
    else:
        pool_target = target
    pool_target = _indmerge(pool_target, indicator, -float("inf"))
    use_kernel = (mix_target is not None and indicator is None
                  and _k.gate("fused_mcmc_pool", mix_target.K, D, n_steps=int(n_steps),
                              student_t=dof is not None, like=starts)
                  and starts.dtype == torch.float32)

    current = starts
    current_eval = evaluate_target(pool_target, starts)
    bad_starts = torch.nonzero(~torch.isfinite(current_eval)).squeeze(1).cpu().numpy()
    if bad_starts.size:
        raise ValueError(
            "target is not finite at %d starting point(s) (first offenders: "
            "%s)" % (bad_starts.size, bad_starts[:5].tolist()))
    sigma0 = torch.as_tensor(sigma0, dtype=starts.dtype, device=device)
    sigma0 = torch.broadcast_to(sigma0, (C, D, D)) if sigma0.ndim == 2 else sigma0
    chols = torch.linalg.cholesky(sigma0)
    unscaled = sigma0 / covar_scale_factor
    scale_factors = torch.full((C,), covar_scale_factor, dtype=starts.dtype, device=device)
    if use_kernel:
        t_ops = _core._kernel_operands(mix_target)
        currentT = current.T.contiguous()

    scan = None if use_kernel else _scan.Scan(functools.partial(
        _pool_steps, functools.partial(evaluate_target, pool_target)))
    all_points, all_rates, nan_counts = [], [], []
    for cycle in range(n_adapt_cycles):
        seed = _rng.seed_words(gen)
        if use_kernel:
            cholr = chols.permute(1, 2, 0).reshape(D * D, C)
            points, accepts, nans, currentT, current_eval = _k.fused_mcmc_pool(
                seed, currentT, current_eval, cholr, dof, t_ops, int(n_steps))
            points = points.permute(2, 0, 1)          # (C, n, D), a view
            rates = accepts.to(starts.dtype) / n_steps
            nans = nans.sum()
        else:
            points, rates, nans, current, current_eval = _tensor_cycle(
                _rng.device_generator(seed, device), scan, current, current_eval, chols,
                int(n_steps), dof)
        all_points.append(points)
        all_rates.append(rates)
        nan_counts.append(nans)
        unscaled, scale_factors, chols = _adapt_pool(
            unscaled, scale_factors, chols, points, rates, cycle, p)

    if not continue_on_NaN:
        counts = torch.stack(nan_counts).cpu().numpy()     # one sync for the run
        bad = _np.flatnonzero(counts > 0)
        if bad.size:
            raise ValueError(
                "target returned NaN for %d proposal(s), first in adaptation "
                "cycle %d (pass continue_on_NaN=True to reject such "
                "proposals)" % (int(counts.sum()), int(bad[0])))
    samples = torch.stack(all_points, dim=1).reshape(C, n_adapt_cycles * n_steps, D)
    return samples, torch.stack(all_rates, dim=1)
