"""Hierarchical Gaussian-mixture reduction ([GR04]).

Counterpart of :mod:`pypmc_tpu.mix_adapt.hierarchical` (the reference's
``pypmc/mix_adapt/hierarchical.py``): the regroup step computes the full
``(nin, nout)`` KL-divergence matrix as one batched computation on the
device, and the refit step is a set of moment matches on the host.
"""

import copy as _copy
import logging

import numpy as _np
import torch

from .. import _device
from ..density.mixture import recover_gaussian_mixture as _unroll
from ..ops.linalg import chol_inv_det

logger = logging.getLogger(__name__)

__all__ = ["Hierarchical", "kullback_leibler", "kl_divergence_matrix"]


def kl_divergence_matrix(mu1, cov1, mu2, cov2):
    """Pairwise Gaussian KL divergences ``KL(f_i || g_j)`` as an ``(nin,
    nout)`` matrix; one batched computation over all pairs.

    A ``g`` covariance whose Cholesky factorization fails (not positive
    definite in the working precision) gives an all-``+inf`` COLUMN: the
    argmin assignment then never routes an input to an invalid output (it
    dies in the next prune), instead of grouping by the identity that stands
    in for its factor."""
    res2 = chol_inv_det(cov2)
    log_det1 = torch.linalg.slogdet(cov1)[1]
    d = res2.log_det[None, :] - log_det1[:, None]
    d = d + torch.einsum("jab,iba->ij", res2.inv, cov1)       # trace(inv2_j cov1_i)
    diff = mu1[:, None, :] - mu2[None, :, :]                     # (nin, nout, D)
    d = d + torch.einsum("ija,jab,ijb->ij", diff, res2.inv, diff)
    d = d - mu1.shape[1]
    return torch.where(res2.valid[None, :], 0.5 * d, torch.full_like(d, float("inf")))


def kullback_leibler(c1, c2):
    """Kullback-Leibler divergence ``KL(1||2)`` of two Gaussian components.
    (Reference: ``hierarchical.py:221-229``.)"""
    d = c2.log_det_sigma - c1.log_det_sigma
    d += _np.trace(c2.inv_sigma.dot(c1.sigma))
    mean_diff = c1.mu - c2.mu
    d += mean_diff.dot(c2.inv_sigma).dot(mean_diff)
    d -= len(c1.mu)
    return 0.5 * d


class Hierarchical(object):
    """Hierarchical clustering of Gaussian mixtures as in [GR04]: find a
    mixture ``g`` with fewer components that most closely matches the input
    mixture ``f``, by EM alternation of a *regroup* (argmin-KL assignment)
    and a *refit* (moment-matched merge) step.
    (Reference: ``mix_adapt/hierarchical.py:11-219``.)

    :param input_components: Gaussian
        :class:`~pypmc_tpu_torch.density.mixture.MixtureDensity`; the
        mixture to be reduced.
    :param initial_guess: Gaussian
        :class:`~pypmc_tpu_torch.density.mixture.MixtureDensity`; initial
        guess for the output, defines the maximum number of components.
    :param device, dtype: where and in what dtype the KL matrix is computed;
        by default :func:`pypmc_tpu_torch.default_device` and the working
        dtype there.  The refit runs on the host in float64.
    """

    def __init__(self, input_components, initial_guess, device=None, dtype=None):
        self.nin = len(input_components.components)
        self.nout = len(initial_guess.components)

        if not 0 < self.nout < self.nin:
            raise AssertionError(
                "need 0 < #outputs < #inputs, have %d outputs for %d inputs"
                % (self.nout, self.nin)
            )

        self.f = input_components
        self.g = _copy.deepcopy(initial_guess)

        # inv_map[j] = list of input indices currently assigned to output j
        self.inv_map = dict.fromkeys(range(self.nout))
        # per-input best KL against the current g (filled by _regroup)
        self.min_kl = _np.full(self.nin, _np.inf)

        # stacked input parameters (static during the run): on the device for
        # the KL matrix, on the host for the refit
        self._f_means, self._f_covs, self._f_weights = _unroll(self.f)
        self.device = _device.default_device(device)
        self.dtype = dtype or _device.working_dtype(self.device)
        self._f_means_dev, self._f_covs_dev = (
            torch.as_tensor(v, dtype=self.dtype, device=self.device)
            for v in (self._f_means, self._f_covs))

    def _prune_empty(self):
        """Drop output components whose weight hit zero (no inputs mapped to
        them) and rebuild ``inv_map`` for the surviving, renumbered outputs.
        Returns the number of components dropped."""
        dropped = self.g.prune()
        if not dropped:
            return 0
        self.nout -= len(dropped)
        dead = {j for (j, _, _) in dropped}
        logger.info("pruned %d empty output component(s): %s", len(dead), sorted(dead))
        survivors = [self.inv_map[j] for j in sorted(self.inv_map) if j not in dead]
        self.inv_map = dict(enumerate(survivors))
        return len(dead)

    def _distance(self):
        r"""Distance function :math:`d(f, g, \pi)`, Eq. (3) in [GR04]."""
        return _np.average(self.min_kl, weights=self._f_weights)

    def _regroup(self):
        """Update the map pi keeping g fixed: assign each input component to
        the output component with smallest KL (Eq. (7) in [GR04]); the whole
        ``(nin, nout)`` KL matrix is one batched computation."""
        g_means, g_covs, _ = _unroll(self.g)
        as_dev = lambda v: torch.as_tensor(v, dtype=self.dtype, device=self.device)
        kl = kl_divergence_matrix(self._f_means_dev, self._f_covs_dev, as_dev(g_means),
                                  as_dev(g_covs)).to("cpu", torch.float64).numpy()
        j_min = _np.argmin(kl, axis=1)
        self.min_kl = kl[_np.arange(self.nin), j_min]
        for j in range(self.nout):
            self.inv_map[j] = list(_np.flatnonzero(j_min == j))

    def _refit(self):
        """Update g keeping the map pi fixed: moment-matched merge of each
        output component's group (Eq. (7) and below in [GR04])."""
        for j, c in enumerate(self.g.components):
            members = self.inv_map[j]
            if not members:
                self.g.weights[j] = 0.0
                continue
            w = self._f_weights[members]
            total = w.sum()
            self.g.weights[j] = total
            mean = _np.einsum("i,id->d", w, self._f_means[members]) / total
            diff = mean[None, :] - self._f_means[members]
            cov = _np.einsum("i,iab->ab", w, self._f_covs[members])
            cov += _np.einsum("i,ia,ib->ab", w, diff, diff)
            cov /= total
            c.update(mean, cov)

    def run(self, eps=1e-4, kill=True, max_steps=50):
        r"""Alternate regroup/refit until the [GR04] distance stalls; the
        reduced mixture is left in ``self.g``.  Returns the step count at
        convergence, or ``None`` if ``max_steps`` ran out first.

        :param eps: declare convergence when the relative change of the
            distance falls below ``eps``.
        :param kill: remove output components with zero weight.
        :param max_steps: maximum number of update steps.
        """
        logger.info("hierarchical reduction: %d -> <=%d components (eps=%g)",
                    self.nin, len(self.g.components), eps)
        # the KL matrix is computed in the working precision: near-duplicate
        # components measure KL ~ 0 +- noise, so tolerate noise-scale
        # negativity and growth instead of failing on exact-zero plateaus
        slack = float(torch.finfo(self.dtype).eps) * 100.0
        prev = None  # distance after the previous regroup/refit pass
        for step in range(1, max_steps + 1):
            if kill:
                self._prune_empty()
            self._regroup()
            self._refit()

            d = self._distance()
            assert d >= -slack, "negative distance %g at step %d" % (d, step)
            d = max(d, 0.0)
            logger.info("step %d: d(f,g) = %g", step, d)

            if prev is not None:
                # the EM alternation can only shrink d; allow noise slack
                assert d <= prev * (1.0 + slack) + slack, (
                    "distance grew at step %d (%g -> %g)" % (step, prev, d))
                if d == prev or prev - d < eps * prev:
                    if kill:
                        self._prune_empty()
                    logger.info("converged at step %d; %d component(s) left",
                                step, len(self.g.components))
                    return step
            prev = d

        if kill:
            self._prune_empty()
        logger.info("no convergence within %d steps; %d component(s) left",
                    max_steps, len(self.g.components))
        return None
