"""Importance sampling.

Counterpart of :mod:`pypmc_tpu.sampler.importance_sampling` (the
reference's ``pypmc/sampler/importance_sampling.py``).  For a Gaussian or
Student-t mixture proposal and an int seed, ``torch.Generator`` or None, a
run is one pass on the device: :func:`~pypmc_tpu_torch.density.core.propose_logq_T`
(kernel ``fused_propose_logq`` on the card) draws the particles and their
proposal log-density, the target is evaluated on the whole block, and the
weights are ``exp(log p - log q)``.  A numpy generator or a generic
proposal runs the reference's host loop.
"""

import logging
from copy import deepcopy as _cp

import numpy as _np
import torch

from .. import _device, _rng
from ..density import core as _core
from ..density.mixture import MixtureDensity
from ..ops.lse import logsumexp
from ..tools import History as _History
from ..tools.indicator import merge_function_with_indicator as _indmerge
from ._target import evaluate_target, evaluate_target_T, map_points

logger = logging.getLogger(__name__)

__all__ = ["ImportanceSampler", "calculate_expectation", "calculate_mean",
           "calculate_covariance", "combine_weights"]


def _pair(samples, weights, device=None):
    assert len(samples) == len(weights), (
        "got %i samples but %i weights" % (len(samples), len(weights)))
    samples = _device.as_tensor(samples, device)
    return samples, _device.as_tensor(weights, samples.device, samples.dtype)


def calculate_expectation(samples, weights, f, device=None):
    r"""Expectation value :math:`\sum_n \bar w_n f(x_n)` of function ``f``
    under self-normalized weights; ``f`` is mapped over the samples
    (``torch.func.vmap``, or a host loop where it cannot be mapped).  Host
    arrays go to ``device`` (default: :func:`pypmc_tpu_torch.default_device`).
    (Reference: ``importance_sampling.py:13-44``.)"""
    samples, weights = _pair(samples, weights, device)
    values = map_points(f, samples)
    return torch.tensordot(weights, values, dims=1) / torch.sum(weights)


def calculate_mean(samples, weights, device=None):
    """Mean of weighted samples.  (Reference: ``importance_sampling.py:46-60``.)"""
    samples, weights = _pair(samples, weights, device)
    return weights @ samples / torch.sum(weights)


def calculate_covariance(samples, weights, device=None):
    """Unbiased covariance matrix of weighted samples, with the reference's
    weighted-unbiasing factor (``importance_sampling.py:62-83``)."""
    samples, weights = _pair(samples, weights, device)
    sum_w = torch.sum(weights)
    sum_weights_sq = sum_w ** 2
    sum_sq_weights = torch.sum(weights ** 2)
    diff = samples - (weights @ samples / sum_w)[None, :]
    cov = (diff * weights[:, None]).T @ diff / sum_w
    return sum_weights_sq / (sum_weights_sq - sum_sq_weights) * cov


class ImportanceSampler(object):
    r"""An importance sampler: generates weighted samples from ``target``
    using ``proposal``.  (Reference: ``importance_sampling.py:132-236``.)

    :param target: The log target density: a callable ``x -> log P(x)`` on
        a tensor point (mapped with ``torch.func.vmap``, or a host loop
        where it cannot be), or a batched target.
    :param proposal: The proposal density ``q``
        (:class:`pypmc_tpu_torch.density.mixture.MixtureDensity` of Gauss or
        StudentT components for the device path, any
        :class:`~pypmc_tpu_torch.density.base.ProbabilityDensity` otherwise).
    :param indicator: Predicate restricting the support; proposed points
        outside get zero weight (target value ``-inf``).
    :param prealloc: Number of samples for which History memory is
        preallocated.
    :param save_target_values: If True, store ``log P`` at every visited
        point in ``self.target_values``.
    :param rng: int seed, ``torch.Generator`` or None (the device path), or
        a numpy generator (the host path, the reference's draws).
    :param device: where the runs happen (default:
        :func:`pypmc_tpu_torch.default_device`), in the working dtype there.
    """

    def __init__(self, target, proposal, indicator=None, prealloc=0,
                 save_target_values=False, rng=None, device=None):
        self.proposal = _cp(proposal)
        self.target = _indmerge(target, indicator, -_np.inf)
        self.target_values = _History(1, prealloc) if save_target_values else None
        self.weights = _History(1, prealloc)
        self.samples = _History(proposal.dim, prealloc)
        self.device = _device.default_device(device)
        self._numpy_rng = rng if _rng.is_numpy_rng(rng) else None
        self._gen = None if self._numpy_rng is not None else _rng.as_generator(rng)
        # device-resident runs not yet flushed to the host Histories:
        # (samples_T (D, n), weights (n,), log_p (n,) or None)
        self._device_pending = []

    def clear(self):
        """Clear the history of samples, weights (and target values) AND
        drop any device-resident pending runs."""
        self.samples.clear()
        self.weights.clear()
        if self.target_values is not None:
            self.target_values.clear()
        self._device_pending = []

    @property
    def device_runs(self):
        """Device-resident ``(samples_T, weights)`` tuples of the runs not
        yet flushed to the host Histories (``to_host=False`` runs); pass
        them straight to :func:`combine_weights` or the adaptation updates
        to avoid the O(N*D) host round-trip."""
        return [(s, w) for s, w, _ in self._device_pending]

    def gather(self):
        """Flush all device-resident runs into the host Histories.
        Returns the number of runs flushed."""
        for samples_T, weights, log_p in self._device_pending:
            n = samples_T.shape[1]
            self.samples.append(n)[:] = samples_T.T.cpu().numpy()
            self.weights.append(n)[:, 0] = weights.cpu().numpy()
            if self.target_values is not None and log_p is not None:
                self.target_values.append(n)[:, 0] = log_p.cpu().numpy()
        flushed = len(self._device_pending)
        self._device_pending = []
        return flushed

    def run(self, N=1, trace_sort=False, to_host=True):
        """Run the sampler for ``N`` points; store samples into
        ``self.samples`` and importance weights into ``self.weights``.

        With ``to_host=False`` (device path only) the run stays resident on
        the device (:attr:`device_runs`) and the O(N*D) host transfer is
        deferred to :meth:`gather` or the next ``to_host=True`` run.

        If ``trace_sort``, return the index of the responsible proposal
        component for each sample (the samples are NOT component-sorted:
        the device path draws each particle's component, the same
        distribution without the ordering).
        """
        if N == 0:
            return 0
        if (self._numpy_rng is not None or not isinstance(self.proposal, MixtureDensity)
                or self.proposal.kind == "generic"):
            return self._run_host(N, trace_sort)

        params = self.proposal.stacked_params(device=self.device)
        samples_T, latent, log_q = _core.propose_logq_T(params, self._gen, int(N))
        log_p = evaluate_target_T(self.target, samples_T)
        weights = torch.exp(log_p - log_q)
        self._device_pending.append(
            (samples_T, weights, log_p if self.target_values is not None else None))
        if to_host:
            self.gather()
        if trace_sort:
            return latent.cpu().numpy() if to_host else latent
        return None

    def _run_host(self, N, trace_sort):
        """Host loop: numpy rng and/or a generic proposal.  The Histories
        are appended only after the target was evaluated on every sample."""
        self.gather()
        rng = self._numpy_rng if self._numpy_rng is not None else _rng.RNG_DEFAULT
        if trace_sort:
            this_samples, origin = self.proposal.propose(N, rng, trace=True, shuffle=False)
        else:
            origin = None
            this_samples = self.proposal.propose(N, rng)
        this_samples = _np.asarray(this_samples)
        log_q = _np.asarray(self.proposal.multi_evaluate(this_samples))
        points = torch.as_tensor(this_samples, dtype=_device.working_dtype(self.device),
                                 device=self.device)
        targets = evaluate_target(self.target, points).double().cpu().numpy()
        self.weights.append(N)[:, 0] = _np.exp(targets - log_q)
        self.samples.append(N)[:] = this_samples
        if self.target_values is not None:
            self.target_values.append(N)[:, 0] = targets
        return origin


def combine_weights(samples, weights, proposals, device=None):
    """Deterministic-mixture (AMIS) weights according to [Cor+12] for
    several importance-sampling runs with the same target but different
    proposals; return a :class:`~pypmc_tpu_torch.tools.History` with one run
    per proposal.  (Reference: ``importance_sampling.py:238-371``.)

    Mixture proposals are evaluated on the device: tensor samples (e.g.
    ``sampler.device_runs`` entries as ``samples[t].T`` / ``weights[t]``)
    where they lie, host samples on ``device`` (default:
    :func:`pypmc_tpu_torch.default_device`) in the working dtype there.
    Generic proposals are evaluated on the host.
    """
    assert len(samples) == len(weights), (
        "%i sample runs vs %i weight runs -- counts must agree" % (len(samples), len(weights)))
    assert len(samples) == len(proposals), (
        "%i sample runs vs %i proposals -- counts must agree" % (len(samples), len(proposals)))

    dim = samples[0].shape[-1]
    N = _np.empty(len(proposals))
    for i in range(len(N)):
        assert samples[i].ndim == 2, "samples[%i] must be a 2-D array" % i
        assert samples[i].shape[-1] == dim, (
            "samples[0] has dimension %i but samples[%i] has %i"
            % (dim, i, samples[i].shape[-1]))
        N[i] = len(samples[i])
        assert N[i] == len(weights[i]), (
            "weights[%i] has length %i but samples[%i] has %i"
            % (i, len(weights[i]), i, N[i]))
    N_total = int(N.sum())

    history = _History(1, N_total)
    # the linear path is ONLY for negative weights (exp(log q) underflows to
    # 0/0 at high dimension); exactly-zero weights stay on the log path,
    # where log(0) = -inf gives a combined weight of exactly 0
    linear = any(bool((w < 0).any()) for w in weights)
    mixtures = all(isinstance(p, MixtureDensity) and p.kind != "generic" for p in proposals)
    for t in range(len(proposals)):
        if mixtures:
            yT = _device.as_tensor(samples[t], device).T.contiguous()
            w_t = _device.as_tensor(weights[t], yT.device, yT.dtype)
            q = torch.stack([_core.mixture_logpdf_T(
                p.stacked_params(dtype=yT.dtype, device=yT.device), yT) for p in proposals],
                dim=-1)
            n_arr = torch.as_tensor(N, dtype=yT.dtype, device=yT.device)
            combined = _combine_one_run(q, w_t, t, n_arr, linear).cpu().numpy()
        else:
            y = samples[t].cpu().numpy() if isinstance(samples[t], torch.Tensor) \
                else _np.asarray(samples[t])
            q = torch.from_numpy(_np.column_stack(
                [_np.asarray(p.multi_evaluate(y), dtype=float) for p in proposals]))
            w_t = torch.as_tensor(_np.asarray(
                weights[t].cpu() if isinstance(weights[t], torch.Tensor) else weights[t],
                dtype=float))
            combined = _combine_one_run(q, w_t, t, torch.from_numpy(N), linear).numpy()
        history.append(N[t])[:, 0] = combined

    assert _np.isfinite(history[:][:, 0]).all(), "combined mixture weights contain inf/nan"
    if not linear:
        sum_w = history[:][:, 0].sum()
        assert sum_w > 0, "total combined weight must be positive, got %g" % sum_w
    return history


def _combine_one_run(q, w_t, t, n_arr, linear):
    """[Cor+12] eq. (3) for ONE run: ``q (N_t, T)`` its samples'
    log-densities under every proposal, ``w_t (N_t,)`` its weights."""
    n_total = torch.sum(n_arr)
    if linear:
        denominator = torch.exp(q) @ (n_arr / n_total)
        return torch.exp(q[:, t]) * w_t / denominator
    return torch.exp(torch.log(w_t) + q[:, t] + torch.log(n_total)
                     - logsumexp(q, n_arr, axis=-1))
