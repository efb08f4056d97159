"""Mixture probability densities.

Counterpart of :mod:`pypmc_tpu.density.mixture` (the reference's
``pypmc/density/mixture.pyx``).  A :class:`MixtureDensity` keeps a list of
host-side component objects for the reference's object API; its batched
work goes through the stacked-parameter functions of
:mod:`pypmc_tpu_torch.density.core`.
"""

import inspect
from copy import deepcopy as _deepcopy

import numpy as _np
import torch

from .. import _device, _rng
from ..ops.lse import logsumexp
from . import core as _core
from .base import ProbabilityDensity
from .gauss import Gauss
from .student_t import StudentT

__all__ = [
    "MixtureDensity",
    "create_gaussian_mixture",
    "recover_gaussian_mixture",
    "create_t_mixture",
    "recover_t_mixture",
]


def _host_logsumexp(a, weights):
    """Weighted max-shifted logsumexp on host numpy (``_regularize.pyx:19-55``)."""
    a = _np.asarray(a, dtype=float)
    max_val = _np.max(a)
    if not _np.isfinite(max_val):
        max_val = 0.0
    return _np.log(_np.sum(weights * _np.exp(a - max_val))) + max_val


class MixtureDensity(ProbabilityDensity):
    """Mixture probability density.  (Reference: ``density/mixture.pyx:21-212``.)

    :param components: Iterable of ProbabilityDensities; the mixture's
        components (deep-copied).
    :param weights: Iterable of floats; the component weights (normalized
        automatically during initialization).
    """

    def __init__(self, components, weights=None):
        self.components = [_deepcopy(component) for component in components]
        assert self.components, "a mixture needs at least one component"
        self.dim = self.components[0].dim
        _np.testing.assert_equal(
            [comp.dim for comp in self.components],
            [self.dim] * len(self.components),
        )
        if weights is None:
            self.weights = _np.ones(len(self.components))
        else:
            self.weights = _np.array(weights, dtype=float)
            assert len(self.weights) == len(self.components)
        self.normalize()

    # ------------------------------------------------------------------ #
    # stacked-parameter bridge to the functional core                     #
    # ------------------------------------------------------------------ #

    @property
    def kind(self):
        """'gauss' | 'student_t' | 'generic' -- selects the batched path."""
        if all(isinstance(c, Gauss) for c in self.components):
            return "gauss"
        if all(isinstance(c, StudentT) for c in self.components):
            return "student_t"
        return "generic"

    def stacked_params(self, dtype=None, device=None):
        """The components stacked into a
        :class:`pypmc_tpu_torch.density.core.MixtureParams` on ``device``
        (default: :func:`pypmc_tpu_torch.default_device`) in ``dtype``
        (default: the working dtype there).  Only for homogeneous Gauss or
        Student-t mixtures."""
        device = _device.default_device(device)
        dtype = dtype or _device.working_dtype(device)
        kind = self.kind
        if kind == "generic":
            raise TypeError(
                "stacked_params requires a homogeneous Gauss or StudentT mixture"
            )
        local = "_local_gauss" if kind == "gauss" else "_local_t"
        stack = lambda values: torch.as_tensor(_np.array(values), dtype=dtype,
                                               device=device)
        # components hold validated covariances: reuse their host factors
        chol = stack([getattr(c, local).cholesky_sigma for c in self.components])
        eye = torch.eye(self.dim, dtype=dtype, device=device).expand_as(chol)
        weights = stack(self.weights)
        return _core.MixtureParams(
            means=stack([c.mu for c in self.components]),
            cov=stack([c.sigma for c in self.components]),
            chol=chol,
            inv_chol=torch.linalg.solve_triangular(chol, eye, upper=False),
            inv_sigma=stack([c.inv_sigma for c in self.components]),
            log_det=stack([c.log_det_sigma for c in self.components]),
            weights=weights / torch.sum(weights),
            dof=stack([c.dof for c in self.components]) if kind == "student_t" else None,
        )

    def evaluate_fn(self, batched=False, device=None):
        """A callable closed over the CURRENT stacked parameters (a snapshot:
        later updates of this mixture are not reflected), to hand the
        mixture to the samplers as their target.

        With ``batched=False`` it maps one point ``x (D,) -> log q(x)`` (the
        reference's ``evaluate`` contract, a tensor on the mixture's device).
        With ``batched=True`` it is a batched, transposed target
        (:func:`pypmc_tpu_torch.sampler.batched_target`): ``xT (D, N) ->
        (N,)`` through :func:`~pypmc_tpu_torch.density.core.mixture_logpdf_T`,
        and so through kernel ``fused_logq`` on the card.  The parameters
        live on ``device`` (default: :func:`pypmc_tpu_torch.default_device`)
        in the working dtype there."""
        params = self.stacked_params(device=device)

        def as_points(x):
            return _device.as_tensor(x, params.device, params.means.dtype)

        if batched:
            from ..sampler._target import batched_target

            @batched_target(transposed=True)
            def log_q(xT):
                return _core.mixture_logpdf_T(params, as_points(xT).contiguous())

            return log_q

        def log_q(x):
            return _core.mixture_logpdf(params, as_points(x)[None, :])[0]

        return log_q

    @classmethod
    def from_params(cls, params):
        """Build a :class:`MixtureDensity` from stacked
        :class:`~pypmc_tpu_torch.density.core.MixtureParams` (device -> host
        copy)."""
        p = _core.params_to_numpy(params)
        if params.is_student_t:
            comps = [StudentT(m, c, d) for m, c, d in zip(p["means"], p["cov"], p["dof"])]
        else:
            comps = [Gauss(m, c) for m, c in zip(p["means"], p["cov"])]
        return cls(comps, p["weights"])

    def set_params(self, params):
        """Overwrite this mixture's components/weights from stacked params
        (in-place device -> host copy)."""
        p = _core.params_to_numpy(params)
        self.weights = _np.array(p["weights"], dtype=float)
        for k, c in enumerate(self.components):
            if params.is_student_t:
                c.update(p["means"][k], p["cov"][k], p["dof"][k])
            else:
                c.update(p["means"][k], p["cov"][k])

    # ------------------------------------------------------------------ #
    # reference API                                                      #
    # ------------------------------------------------------------------ #

    def __len__(self):
        number_of_components = len(self.components)
        assert number_of_components == len(self.weights)
        return number_of_components

    def normalize(self):
        """Rescale the component weights so they sum to 1."""
        self.weights /= self.weights.sum()

    def normalized(self):
        """are the component weights normalized?"""
        return _np.allclose(self.weights.sum(), 1.0)

    def prune(self, threshold=0.0):
        """Remove components with weight <= ``threshold``.  Return list of
        removed components as ``[(index, component, weight), ...]``."""
        removed_indices = []
        removed_components = []
        n = len(self.weights)
        for i, c in enumerate(reversed(self.components)):
            if self.weights[n - i - 1] <= threshold:
                current_index = n - i - 1
                removed_indices.append(current_index)
                removed_components.append(
                    (current_index, self.components.pop(current_index), self.weights[current_index])
                )
        self.weights = _np.delete(self.weights, removed_indices)
        return removed_components

    def evaluate(self, x, individual=False):
        """Evaluate ``log q(x)`` at a single point (weights as stored).  If
        ``individual``, additionally return the per-component
        log-densities."""
        components_evaluated = _np.empty(len(self.components))
        for i, comp in enumerate(self.components):
            components_evaluated[i] = comp.evaluate(x)
        res = _host_logsumexp(components_evaluated, self.weights)
        if individual:
            return res, components_evaluated
        return res

    def multi_evaluate(self, x, out=None, individual=None, components=None):
        """Evaluate the density at all points in ``x`` (``mixture.pyx:112-156``):
        fills the ``(N, K)`` array ``individual`` with per-component
        log-densities if given; returns the ``(N,)`` mixture log-density (or
        None when a component subset is selected).  The weights are used as
        stored, normalized or not, as :meth:`evaluate` uses them."""
        x = _np.asarray(x)
        assert x.shape[1] == self.dim, (
            "points have dimension %i, mixture expects %i"
            % (x.shape[1], self.dim)
        )
        if individual is not None:
            assert individual.shape == (len(x), len(self)), (
                "individual output buffer must have shape %s for this x"
                % ((len(x), len(self)),)
            )

        if self.kind == "generic":
            return self._multi_evaluate_host(x, out, individual, components)

        params = self.stacked_params()
        logpdfs = _core.component_logpdfs(
            params, torch.as_tensor(x, dtype=params.means.dtype, device=params.device))

        if components is None:
            if individual is not None:
                individual[:] = logpdfs.cpu().numpy()
            res = logsumexp(logpdfs, params.weights, axis=-1).cpu().numpy()
            # stacked_params normalizes the weights; evaluate() uses them as
            # stored: keep the two consistent for unnormalized weights
            w_sum = float(_np.sum(self.weights))
            if w_sum != 1.0:
                res = res + _np.log(w_sum)
            if out is None:
                return res
            assert len(out) == len(x), "out has the wrong length; expected %i" % len(x)
            out[:] = res
            return out
        else:
            assert out is None, "out cannot be combined with a components subset"
            assert individual is not None
            logpdfs = logpdfs.cpu().numpy()
            for k in components:
                individual[:, k] = logpdfs[:, k]
            return None

    def _multi_evaluate_host(self, x, out, individual, components):
        if individual is None:
            individual = _np.empty((len(x), len(self)))
        if components is None:
            for k, c in enumerate(self.components):
                c.multi_evaluate(x, individual[:, k])
            res = _np.array([_host_logsumexp(row, self.weights) for row in individual])
            if out is None:
                return res
            out[:] = res
            return out
        else:
            assert out is None, "out cannot be combined with a components subset"
            for k in components:
                self.components[k].multi_evaluate(x, individual[:, k])
            return None

    def propose(self, N=1, rng=_rng.RNG_DEFAULT, trace=False, shuffle=True,
                device=None):
        """Propose N points (weights assumed normalized), as numpy arrays.

        ``rng`` may be a numpy generator (the reference's multinomial block
        allocation, ``mixture.pyx:159-212``) or an int seed, a
        ``torch.Generator`` or None (a per-particle categorical draw through
        :func:`pypmc_tpu_torch.density.core.propose` on ``device``, default
        :func:`pypmc_tpu_torch.default_device`; already unordered, so
        ``shuffle`` is a no-op there).

        If ``trace``, additionally return the generating component index per
        sample.
        """
        if trace and shuffle:
            raise ValueError("shuffle and trace cannot both be requested")

        if not _rng.is_numpy_rng(rng):
            if self.kind != "generic":
                samples, latent = _core.propose(self.stacked_params(device=device), rng,
                                                int(N))
                if trace:
                    return samples.cpu().numpy(), latent.cpu().numpy()
                return samples.cpu().numpy()
            # generic components draw on the host from a seeded numpy stream
            gen = _rng.as_generator(rng)
            rng = _np.random.RandomState(int(torch.randint(0, 2**31 - 1, (1,), generator=gen)))

        to_get = rng.multinomial(N, self.weights)
        output_samples = _np.empty((N, self.dim))
        current_write_start = 0
        for i, comp in enumerate(self.components):
            if to_get[i] != 0:
                # the arity from the signature (the reference also calls
                # propose(n) for rng-less components, mixture.pyx:199)
                try:
                    n_args = len(inspect.signature(comp.propose).parameters)
                except (TypeError, ValueError):
                    n_args = 2
                if n_args >= 2:
                    block = comp.propose(to_get[i], rng)
                else:
                    block = comp.propose(to_get[i])
                output_samples[
                    current_write_start : current_write_start + to_get[i]
                ] = block
            current_write_start += to_get[i]

        if trace:
            output_origin = _np.repeat(_np.arange(len(self.components)), to_get)
            return output_samples, output_origin
        if shuffle:
            rng.shuffle(output_samples)
        return output_samples


def create_gaussian_mixture(means, covs, weights=None):
    """Create a :class:`MixtureDensity` with :class:`Gauss` components.
    (Reference: ``mixture.pyx:214-247``.)"""
    assert len(means) == len(covs), (
        "got %i means but %i covariance matrices"
        % (len(means), len(covs))
    )
    return MixtureDensity([Gauss(m, c) for m, c in zip(means, covs)], weights)


def recover_gaussian_mixture(mixture):
    """Extract ``(means, covs, weights)`` from a Gaussian
    :class:`MixtureDensity`.  (Reference: ``mixture.pyx:249-277``.)"""
    weights = _np.array(mixture.weights)
    means = _np.array([c.mu for c in mixture.components])
    covs = _np.array([c.sigma for c in mixture.components])
    return means, covs, weights


def create_t_mixture(means, covs, dofs, weights=None):
    """Create a :class:`MixtureDensity` with :class:`StudentT` components.
    (Reference: ``mixture.pyx:279-318``.)"""
    assert len(means) == len(covs) and len(means) == len(dofs), (
        "got %i means, %i covariances and %i dofs -- counts must agree"
        % (len(means), len(covs), len(dofs))
    )
    return MixtureDensity(
        [StudentT(m, c, d) for m, c, d in zip(means, covs, dofs)], weights
    )


def recover_t_mixture(mixture):
    """Extract ``(means, covs, dofs, weights)`` from a Student-t
    :class:`MixtureDensity`.  (Reference: ``mixture.pyx:320-350``.)"""
    weights = _np.array(mixture.weights)
    means = _np.array([c.mu for c in mixture.components])
    covs = _np.array([c.sigma for c in mixture.components])
    dofs = _np.array([c.dof for c in mixture.components])
    return means, covs, dofs, weights
