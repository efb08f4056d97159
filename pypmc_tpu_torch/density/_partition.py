"""Minimal lexicographic integer partition and data patching.

Counterpart of :mod:`pypmc_tpu.density._partition` (the reference's
``pypmc/density/_partition.py``); host numpy.
"""

import logging

import numpy as _np

from .gauss import Gauss
from .mixture import MixtureDensity

logger = logging.getLogger(__name__)

__all__ = ["partition", "patch_data"]


def partition(N, k):
    """Distribute ``N`` into ``k`` parts such that each part takes the value
    ``N//k`` or ``N//k + 1`` (minimal lexicographic integer partition).

    Example: ``N=5, k=2 --> [3, 2]``.  (Reference: ``_partition.py:12-24``.)
    """
    out = [N // k] * k
    for i in range(N % k):
        out[i] += 1
    return out


def _patch_component(patch, index, try_diag):
    """One Gauss from a patch's empirical moments, or None.  A covariance
    that is not positive definite falls back to its diagonal when
    ``try_diag``; a patch of one row has no covariance and is dropped."""
    if len(patch) < 2:
        logger.info("patch %i: too short for a covariance estimate (%d "
                    "row(s)); dropped", index, len(patch))
        return None
    mean = _np.mean(patch, axis=0)
    cov = _np.cov(patch, rowvar=0)
    candidates = [cov, _np.diag(_np.diag(cov))] if try_diag else [cov]
    for attempt, sigma in enumerate(candidates):
        try:
            component = Gauss(mean, sigma)
        except _np.linalg.LinAlgError as err:
            logger.info("patch %i: %s covariance rejected (%r)", index,
                        ("full", "diagonal")[attempt], err)
            continue
        if attempt:
            logger.info("patch %i: using the diagonal of the covariance", index)
        return component
    return None


def patch_data(data, L=100, try_diag=True):
    """Cut ``data`` (e.g. Markov-chain output) into consecutive patches of
    length ``L`` and return a Gaussian mixture with one component per patch,
    carrying the patch's empirical mean and covariance.  Patches without a
    valid covariance use the diagonal (if ``try_diag``) or are dropped.
    (Same contract as the reference ``_partition.py:26-89``.)
    """
    data = _np.asarray(data)
    dropped, components = [], []
    for i, start in enumerate(range(0, len(data), L)):
        component = _patch_component(data[start:start + L], i, try_diag)
        if component is None:
            dropped.append(i)
        else:
            components.append(component)
    if dropped:
        logger.warning("dropped patches without a valid covariance: %s", dropped)
    return MixtureDensity(components)
