"""Gaussian probability densities (host-side component API).

Counterpart of :mod:`pypmc_tpu.density.gauss` (the reference's
``pypmc/density/gauss.pyx``): light host wrappers around numpy parameters
with the reference's ``update``/``LinAlgError`` rollback semantics
(``gauss.pyx:23-48``).  The batched compute path for mixtures of these
components lives in :mod:`pypmc_tpu_torch.density.core`.

Draws take ``rng``: a numpy generator (the reference's semantics, and the
default) or an int seed, a ``torch.Generator`` or None, which draw through
torch.
"""

import numpy as _np
import torch
from scipy.linalg import solve_triangular as _solve_triangular

from .. import _rng
from .base import LocalDensity, ProbabilityDensity

__all__ = ["LocalGauss", "Gauss", "chol_inv_det_host"]


def standard_normal(rng, shape):
    """Standard normals of ``shape`` as a float64 numpy array, from a numpy
    generator or through torch (:func:`pypmc_tpu_torch._rng.as_generator`)."""
    if _rng.is_numpy_rng(rng):
        return rng.normal(0, 1, shape)
    return torch.randn(shape, generator=_rng.as_generator(rng),
                       dtype=torch.float64).numpy()


def chol_inv_det_host(sigma):
    """Host (numpy) Cholesky + inverse + log-det with the reference's
    validation semantics (``tools/_linalg.pyx:41-95``):

    * non-finite entries     -> ``ValueError``
    * asymmetric matrix      -> ``numpy.linalg.LinAlgError``
    * not positive definite  -> ``numpy.linalg.LinAlgError``

    Return ``(L, inverse, log_det)``.
    """
    sigma = _np.asarray_chkfinite(sigma, dtype=float)
    if sigma.ndim == 0:
        sigma = sigma.reshape(1, 1)
    if not _np.allclose(sigma, sigma.T):
        raise _np.linalg.LinAlgError("covariance must be symmetric; got\n" + repr(sigma))
    l = _np.linalg.cholesky(sigma)  # raises LinAlgError if not PD
    u = _solve_triangular(l, _np.eye(len(l)), lower=True)  # L^{-1}
    inverse = u.T.dot(u)
    log_det = 2.0 * _np.sum(_np.log(_np.diag(l)))
    if not _np.isfinite(log_det):
        raise _np.linalg.LinAlgError(
            "covariance is not positive definite (nonpositive eigenvalue) " + repr(log_det)
        )
    return l, inverse, log_det


class LocalGauss(LocalDensity):
    """A multivariate local Gaussian density ``q(x|y) = N(x; y, Sigma)`` with
    redefinable covariance.  (Reference: ``density/gauss.pyx:11-67``.)

    :param sigma: Matrix-like array; covariance matrix.
    """

    symmetric = True

    def __init__(self, sigma):
        self.update(sigma)

    def update(self, sigma):
        """Re-initialize with a new covariance matrix.

        On ``LinAlgError`` the old covariance is kept and the proposal
        remains in a valid state (``gauss.pyx:23-48``).
        """
        sigma = _np.atleast_2d(_np.array(sigma, dtype=float, copy=True))
        # raises before any internal state is touched
        cholesky_sigma, inv_sigma, log_det_sigma = chol_inv_det_host(sigma)
        self.cholesky_sigma = cholesky_sigma
        self.inv_sigma = inv_sigma
        self.log_det_sigma = log_det_sigma
        self.sigma = sigma
        self.dim = sigma.shape[0]
        self._compute_norm()

    def _compute_norm(self):
        self.log_normalization = (
            -0.5 * self.dim * _np.log(2 * _np.pi) - 0.5 * self.log_det_sigma
        )

    def _get_gauss_sample(self, rng):
        """One draw from N(0, sigma)."""
        return _np.dot(self.cholesky_sigma, standard_normal(rng, self.dim))

    def evaluate(self, x, y):
        diff = _np.asarray(x) - _np.asarray(y)
        return self.log_normalization - 0.5 * diff.dot(self.inv_sigma).dot(diff)

    def propose(self, y, rng=_rng.RNG_DEFAULT):
        """Propose x = y + L z with z standard normal."""
        return _np.asarray(y) + self._get_gauss_sample(rng)


class Gauss(ProbabilityDensity):
    r"""A Gaussian probability density usable as a mixture component.
    (Reference: ``density/gauss.pyx:69-163``.)

    :param mu: Vector-like array; the mean :math:`\mu`.
    :param sigma: Matrix-like array; the covariance matrix :math:`\Sigma`.
    """

    def __init__(self, mu, sigma):
        self.update(mu, sigma)

    def update(self, mu, sigma):
        """Re-initialize with new mean and covariance; on ``LinAlgError``
        (or a dimension mismatch) the old state is kept
        (``gauss.pyx:86-116``)."""
        mu = _np.array(mu, dtype=float)
        new_local = LocalGauss(sigma)  # validates sigma first
        # validate BEFORE any state mutation: a raise leaves the old state
        if len(mu) != new_local.sigma.shape[0]:
            raise ValueError(
                "mean has dimension %d but the covariance matrix is "
                "%d-dimensional" % (len(mu), new_local.sigma.shape[0]))
        self._local_gauss = new_local
        self.mu = mu
        self.dim = len(self.mu)
        self.inv_sigma = new_local.inv_sigma
        self.log_det_sigma = new_local.log_det_sigma
        self.sigma = new_local.sigma

    def evaluate(self, x):
        diff = _np.asarray(x) - self.mu
        return self._local_gauss.log_normalization - 0.5 * diff.dot(self.inv_sigma).dot(diff)

    def multi_evaluate(self, x, out=None):
        x = _np.asarray(x)
        diff = x - self.mu[None, :]
        res = self._local_gauss.log_normalization - 0.5 * _np.einsum(
            "ni,ij,nj->n", diff, self.inv_sigma, diff
        )
        if out is None:
            return res
        assert len(out) == len(x)
        out[:] = res
        return out

    def propose(self, N=1, rng=_rng.RNG_DEFAULT):
        """Propose N points."""
        z = standard_normal(rng, (N, self.dim))
        return self.mu[None, :] + z.dot(self._local_gauss.cholesky_sigma.T)
