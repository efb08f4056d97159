"""Gelman-Rubin R value [GR92] and chain grouping.

Counterpart of :mod:`pypmc_tpu.mix_adapt.r_value` (the reference's
``pypmc/mix_adapt/r_value.py``): group Markov chains by their common R
value and build a Gaussian or Student-t mixture from "long patches" of the
grouped chains [BC13].  Host numpy.
"""

import numpy as _np

from ..density._partition import partition as _partition
from ..density.mixture import create_gaussian_mixture, create_t_mixture

__all__ = ["r_value", "r_group", "make_r_gaussmix", "make_r_tmix"]


def r_value(means, variances, n, approx=False):
    """Gelman-Rubin potential-scale-reduction factor ([GR92] ch. 2.2) of
    ``m`` chains in ONE dimension, from the per-chain sample ``means`` and
    sample ``variances`` with ``n`` samples per chain.  ``approx=True``
    drops the degrees-of-freedom correction factor ``df/(df-2)``.
    (Reference: ``r_value.py:25-89``.)"""
    mu = _np.asarray(means, dtype=float)
    s2 = _np.asarray(variances, dtype=float)
    if mu.ndim != 1 or s2.ndim != 1:
        raise ValueError("per-chain means/variances must be 1-dimensional")
    if mu.shape != s2.shape:
        raise ValueError("got %i chain means but %i chain variances" % (len(mu), len(s2)))
    m = len(mu)

    within = s2.mean()                      # W: mean within-chain variance
    between_n = mu.var(ddof=1)              # B/n: variance of the chain means
    pooled = (n - 1.0) / n * within + between_n   # sigma^2_+ ([GR92] below eq. 3)
    if approx:
        return pooled / within

    # [GR92] eq. (4): the scale of the t approximation and its variance
    scale = pooled + between_n / m
    moments = _np.cov(_np.stack([s2, mu, mu * mu]))
    var_scale = (
        ((n - 1.0) / n) ** 2 / m * moments[0, 0]
        + 2.0 * ((m + 1.0) / m) ** 2 / (m - 1.0) * between_n ** 2
        + 2.0 * (m + 1.0) * (n - 1.0) / (m * m * n)
        * (moments[0, 2] - 2.0 * mu.mean() * moments[0, 1])
    )
    df = 2.0 * scale * scale / var_scale
    if df <= 2.0:
        return _np.inf
    return scale / within * df / (df - 2.0)


def r_group(means, variances, n, critical_r=2.0, approx=False):
    """Group chains whose common :func:`r_value` is less than ``critical_r``
    in every dimension; each chain joins the first group it fits, in input
    order.  (Reference: ``r_value.py:99-139``.)"""
    means = _np.asarray(means)
    variances = _np.asarray(variances)
    if means.ndim != 2 or variances.ndim != 2:
        raise ValueError("chain means/variances must be (chains, dim) arrays")
    if means.shape != variances.shape:
        raise ValueError("chain means %s and variances %s have mismatching shapes"
                         % (means.shape, variances.shape))

    def joins(group, i):
        members = group + [i]
        return all(r_value(means[members, j], variances[members, j], n, approx) < critical_r
                   for j in range(means.shape[1]))

    groups = []
    for i in range(len(means)):
        home = next((g for g in groups if joins(g, i)), None)
        if home is None:
            groups.append([i])
        else:
            home.append(i)
    return groups


def _moments(piece):
    return _np.mean(piece, axis=0), _np.cov(piece, rowvar=0)


def _split(chain, parts):
    """``chain`` cut into ``parts`` consecutive pieces of near-equal
    length (:func:`~pypmc_tpu_torch.density.partition`)."""
    bounds = _np.cumsum([0] + _partition(len(chain), parts))
    return [chain[a:b] for a, b in zip(bounds[:-1], bounds[1:])]


def _group_patches(chains, group, K_g):
    """The patches of one group: ``K_g`` patches spread over the group's
    chains (each chain cut into its share) when the group has no more
    chains than patches, else ``K_g`` patches of the group's chains laid
    end to end."""
    if K_g >= len(group):
        shares = _partition(K_g, len(group))
        return [piece for i, share in zip(group, shares) for piece in _split(chains[i], share)]
    return _split(_np.vstack([chains[i] for i in group]), K_g)


def _long_patches(data, K_g, critical_r, indices, approx):
    """The means and covariances of the long patches: chains grouped by
    :func:`r_group` on the dimensions ``indices``, each group cut into
    ``K_g`` patches.  (Reference: ``r_value.py:141-199``.)"""
    chains = [_np.asarray(d) for d in data]
    n = len(chains[0])
    if any(len(c) != n for c in chains):
        raise ValueError("all chains must have equal length")
    if indices is None:
        indices = _np.arange(chains[0].shape[1])
    if len(indices) == 0:
        raise ValueError("``indices`` must be a non-empty iterable, got %s" % (indices,))
    selected = [c[:, indices] for c in chains]
    groups = r_group([s.mean(axis=0) for s in selected],
                     [s.var(axis=0, ddof=1) for s in selected], n, critical_r, approx)
    pieces = [p for g in groups for p in _group_patches(chains, g, K_g)]
    moments = [_moments(p) for p in pieces]
    return [m for m, _ in moments], [c for _, c in moments]


def make_r_gaussmix(data, K_g=15, critical_r=2.0, indices=None, approx=False):
    """Use ``data`` from multiple chains to form a Gaussian mixture via the
    "long patches" approach of [BC13]: group chains by R value
    (:func:`r_group`), split each group into ``K_g`` patches and give each
    patch's empirical mean/covariance to a Gaussian component.
    (Reference: ``r_value.py:202-248``.)"""
    return create_gaussian_mixture(*_long_patches(data, K_g, critical_r, indices, approx))


def make_r_tmix(data, K_g=15, critical_r=2.0, dof=5.0, indices=None, approx=False):
    """Like :func:`make_r_gaussmix` but with Student-t components of the
    given ``dof`` (> 2), with sigma rescaled by ``(dof-2)/dof`` so each
    component keeps the patch covariance.
    (Reference: ``r_value.py:251-305``.)"""
    assert dof > 2.0, "finite-covariance Student-t needs dof > 2, got %g" % dof
    means, covs = _long_patches(data, K_g, critical_r, indices, approx)
    sigmas = _np.asarray(covs) * ((dof - 2.0) / dof)   # cov = dof / (dof - 2) * sigma
    return create_t_mixture(means, sigmas, [dof] * len(means))
