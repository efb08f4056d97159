"""Student's t probability densities (host-side component API).

Counterpart of :mod:`pypmc_tpu.density.student_t` (the reference's
``pypmc/density/student_t.pyx``); batched compute for mixtures of these
components lives in :mod:`pypmc_tpu_torch.density.core`.  ``rng`` as in
:mod:`pypmc_tpu_torch.density.gauss`.
"""

import numpy as _np
import torch
from scipy.special import gammaln as _gammaln

from .. import _rng
from ..ops import random as _random
from .base import ProbabilityDensity
from .gauss import LocalGauss, standard_normal

__all__ = ["LocalStudentT", "StudentT"]


def _chisquare(rng, dof, n):
    """``n`` chi-square draws with ``dof`` degrees of freedom (float64
    numpy), clamped to float32's tiny so ``dof / chi2`` stays finite."""
    if _rng.is_numpy_rng(rng):
        draws = rng.chisquare(dof, n)
    else:
        draws = _random.chisquare(_rng.as_generator(rng),
                                  torch.tensor(dof, dtype=torch.float64), (n,)).numpy()
    return _np.maximum(draws, _np.finfo(_np.float32).tiny)


class LocalStudentT(LocalGauss):
    """A multivariate local Student's t density with redefinable covariance.
    (Reference: ``density/student_t.pyx:13-55``.)

    :param sigma: Matrix-like array; the covariance matrix.
    :param dof: Float; the degrees of freedom.
    """

    def __init__(self, sigma, dof):
        self.symmetric = True
        assert dof > 0.0, (
            "the degree of freedom must be positive, got %g" % dof
        )
        self.dof = float(dof)
        self.update(sigma)

    def _compute_norm(self):
        self.log_normalization = (
            _gammaln(0.5 * (self.dof + self.dim))
            - _gammaln(0.5 * self.dof)
            - 0.5 * self.dim * _np.log(self.dof * _np.pi)
            - 0.5 * self.log_det_sigma
        )

    def evaluate(self, x, y):
        diff = _np.asarray(x) - _np.asarray(y)
        return self.log_normalization - 0.5 * (self.dof + self.dim) * _np.log(
            1.0 + diff.dot(self.inv_sigma).dot(diff) / self.dof
        )

    def propose(self, y, rng=_rng.RNG_DEFAULT):
        # Z ~ N(0, sigma), V ~ chi^2(dof)  =>  Z * sqrt(dof/V) is t-distributed
        z = self._get_gauss_sample(rng)
        chi2 = _chisquare(rng, self.dof, 1)[0]
        return _np.asarray(y) + z * _np.sqrt(self.dof / chi2)


class StudentT(ProbabilityDensity):
    r"""A Student's t probability density usable as a mixture component.
    (Reference: ``density/student_t.pyx:57-176``.)

    :param mu: Vector-like array; the mean :math:`\mu`.
    :param sigma: Matrix-like array; the scale matrix :math:`\Sigma`.
    :param dof: Float; the degrees of freedom :math:`\nu`.
    """

    def __init__(self, mu, sigma, dof):
        self.update(mu, sigma, dof)

    def update(self, mu, sigma, dof):
        """Re-initialize with new mean, scale matrix and degrees of freedom;
        on ``LinAlgError`` the old state is kept (``student_t.pyx:78-117``)."""
        mu = _np.array(mu, dtype=float)
        new_local = LocalStudentT(sigma, dof)  # validates sigma first
        if len(mu) != new_local.sigma.shape[0]:
            raise ValueError(
                "mean has dimension %d but the covariance matrix is "
                "%d-dimensional" % (len(mu), new_local.sigma.shape[0]))
        self._local_t = new_local
        self.mu = mu
        self.dim = len(self.mu)
        self.dof = float(dof)
        self.inv_sigma = new_local.inv_sigma
        self.log_det_sigma = new_local.log_det_sigma
        self.sigma = new_local.sigma
        self._eval_prefactor = -0.5 * (self.dof + self.dim)
        self._inv_dof = 1.0 / self.dof

    def evaluate(self, x):
        diff = _np.asarray(x) - self.mu
        return self._local_t.log_normalization + self._eval_prefactor * _np.log(
            1.0 + diff.dot(self.inv_sigma).dot(diff) * self._inv_dof
        )

    def multi_evaluate(self, x, out=None):
        x = _np.asarray(x)
        diff = x - self.mu[None, :]
        maha = _np.einsum("ni,ij,nj->n", diff, self.inv_sigma, diff)
        res = self._local_t.log_normalization + self._eval_prefactor * _np.log(
            1.0 + maha * self._inv_dof
        )
        if out is None:
            return res
        assert len(out) == len(x)
        out[:] = res
        return out

    def propose(self, N=1, rng=_rng.RNG_DEFAULT):
        """Propose N points."""
        z = standard_normal(rng, (N, self.dim))
        chi2 = _chisquare(rng, self.dof, N)
        gauss = z.dot(self._local_t.cholesky_sigma.T)
        return self.mu[None, :] + gauss * _np.sqrt(self.dof / chi2)[:, None]
