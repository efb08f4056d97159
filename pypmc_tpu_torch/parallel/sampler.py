"""The PMC run loop over the particle axis: one process on one device.

Counterpart of :func:`pypmc_tpu.parallel.sampler.pmc_run_sharded` and
:func:`~pypmc_tpu.parallel.sampler.run_is_step_sharded`.  Every reduction
over particles goes through the ``reduce`` hook of
:mod:`pypmc_tpu_torch.mix_adapt.pmc`, which is the identity in one process;
a ``torch.distributed`` group of more than one rank, or a ``mesh``, is
refused until the multi-rank path (all-reduce of the O(K D^2) statistics)
is ported.  The parameter lists are the JAX package's, ``mesh`` and
``axis_name`` included, so a positional call means the same in both.
"""

from typing import NamedTuple

import torch

from .. import _rng
from ..density import core as _core
from ..mix_adapt.pmc import (pmc_log_likelihood, pmc_step_mixture_target,
                             pmc_update)

__all__ = ["run_is_step_sharded", "pmc_run_sharded", "PMCStepStats",
           "evaluate_target_T"]

# the JAX package's particle mesh axis (pypmc_tpu/parallel/mesh.py)
_PARTICLE_AXIS = "particles"


def _check_single_process(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "a mesh is not taken yet: the port runs in one process on one device; "
            "the multi-rank path is not ported")
    if (torch.distributed.is_available() and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1):
        raise NotImplementedError(
            "pmc_run_sharded runs in one process; the multi-rank path "
            "(all-reduce of the sufficient statistics) is not ported yet")


def evaluate_target_T(target, samples_T):
    """Evaluate a callable log-target on transposed ``(D, N)`` samples.  A
    callable marked ``transposed=True`` receives ``(D, N)``, any other one
    the row-major ``(N, D)`` block; either returns ``(N,)`` log-densities."""
    if getattr(target, "__pypmc_tpu_transposed__", False):
        return target(samples_T)
    return target(samples_T.T)


def _is_body(params, key, n, target):
    """Propose, evaluate and weight ``n`` particles (transposed layout).  A
    MIXTURE target is evaluated inside the same kernel as the proposal."""
    if isinstance(target, _core.MixtureParams):
        samples_T, latent, log_q, log_p = _core.propose_logq_T(params, key, n, target)
    else:
        samples_T, latent, log_q = _core.propose_logq_T(params, key, n)
        log_p = evaluate_target_T(target, samples_T)
    return samples_T, torch.exp(log_p - log_q), latent


def run_is_step_sharded(params, target, key, n_total, mesh=None,
                        axis_name=_PARTICLE_AXIS):
    """Draw ``n_total`` importance samples; return ``(samples_T (D,
    n_total), weights, latent)``.  ``target`` is a log-density callable or a
    :class:`~pypmc_tpu_torch.density.core.MixtureParams`; ``key`` an int
    seed or a ``torch.Generator``.  ``mesh`` must be None (one process);
    ``axis_name`` is unused in one process."""
    _check_single_process(mesh)
    return _is_body(params, _rng.as_generator(key), int(n_total), target)


class PMCStepStats(NamedTuple):
    log_likelihood: torch.Tensor  # [Cap+08] eq. (5) of the UPDATED mixture
    perplexity: torch.Tensor      # normalized perplexity of the weights
    ess: torch.Tensor             # normalized effective sample size
    evidence: torch.Tensor        # mean weight = integral estimate


def pmc_run_sharded(target, params, n_total, n_steps, mesh=None, key=None,
                    rb=True, dof_solver_steps=100, mindof=1e-5, maxdof=1e3,
                    axis_name=_PARTICLE_AXIS, return_final_samples=False,
                    scan_steps=False, compute_log_likelihood=True,
                    weight_clip=False):
    """Run ``n_steps`` of (M-)PMC with ``n_total`` fresh particles per step
    on the device that holds ``params``.

    Each step with a MIXTURE target and ``rb=True`` runs the particle work
    as one kernel (``fused_is_pmc_step``); otherwise it draws and weights
    the particles (``fused_propose_logq``) and then runs
    :func:`~pypmc_tpu_torch.mix_adapt.pmc.pmc_update`.

    :param target: log target density callable, or
        :class:`~pypmc_tpu_torch.density.core.MixtureParams`.
    :param params: initial mixture; Student-t iff ``params.dof`` is not None.
    :param n_total: particles per step.
    :param n_steps: number of PMC adaptation steps.
    :param mesh: must be None: the port runs in one process on one device
        (a mesh raises ``NotImplementedError``).
    :param key: int seed or ``torch.Generator`` (None: seed 0); each step
        takes fresh seed words from it.
    :param axis_name: the JAX package's mesh axis; unused in one process.
    :param weight_clip: clip the weights at ``mean * sqrt(n)`` for the
        ADAPTATION only (truncated importance sampling, Ionides 2008);
        diagnostics and evidence stay unclipped.
    :param scan_steps: accepted for parity with the JAX package; the steps
        run in the same Python loop with identical results.
        ``return_final_samples`` is not available with it.
    :param compute_log_likelihood: False skips the extra evaluation pass per
        step (``stats.log_likelihood`` is then NaN).

    Returns ``(params, stats)`` with ``stats`` a :class:`PMCStepStats` of
    ``(n_steps,)`` tensors; with ``return_final_samples`` additionally the
    last step's ``(samples_T (D, n_total), weights)``.
    """
    _check_single_process(mesh)
    if scan_steps and return_final_samples:
        raise ValueError("return_final_samples is not available with scan_steps=True")
    gen = _rng.as_generator(0 if key is None else key)
    n = int(n_total)
    is_t = params.is_student_t
    mixture_target = isinstance(target, _core.MixtureParams)
    steps = dof_solver_steps if is_t else 0

    all_stats = []
    samples_T = weights = None
    for _ in range(n_steps):
        if mixture_target and rb and not weight_clip:
            result, samples_T, weights, latent, sw = pmc_step_mixture_target(
                params, target, gen, n, dof_solver_steps=steps,
                mindof=mindof, maxdof=maxdof)
            sum_w, sum_w2, sum_wlogw = sw[0], sw[1], sw[2]
        else:
            samples_T, weights, latent = _is_body(params, gen, n, target)
            sum_w = torch.sum(weights)
            w_adapt = weights
            if weight_clip:
                w_adapt = torch.minimum(weights, (sum_w / n) * n ** 0.5)
            result = pmc_update(params, samples_T, w_adapt,
                                latent=None if rb else latent, rb=rb,
                                dof_solver_steps=steps, mindof=mindof,
                                maxdof=maxdof, transposed=True)
            sum_w2 = torch.sum(weights * weights)
            sum_wlogw = torch.sum(torch.special.xlogy(weights, weights))
        # weight diagnostics from the raw sums: the entropy of the
        # normalized weights is log(sum w) - (sum w log w) / (sum w)
        entr = torch.log(sum_w) - sum_wlogw / sum_w
        perp = torch.exp(entr) / n
        coeff_var = sum_w2 * n / sum_w ** 2 - 1.0
        ess = 1.0 / (1.0 + coeff_var)
        if compute_log_likelihood:
            loglik = pmc_log_likelihood(result.params, samples_T, weights / sum_w,
                                        transposed=True)
        else:
            loglik = torch.full((), float("nan"), dtype=weights.dtype,
                                device=weights.device)
        all_stats.append(PMCStepStats(log_likelihood=loglik, perplexity=perp,
                                      ess=ess, evidence=sum_w / n))
        params = result.params

    stats = PMCStepStats(*[torch.stack([getattr(s, f) for s in all_stats])
                           for f in PMCStepStats._fields])
    if return_final_samples:
        return params, stats, samples_T, weights
    return params, stats
