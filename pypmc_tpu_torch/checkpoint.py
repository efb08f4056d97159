"""Checkpoint / resume.

Counterpart of :mod:`pypmc_tpu.checkpoint`.  Every algorithm's state is a
set of arrays, saved as plain ``.npz`` files, so a checkpoint survives
process restarts and moves between the CPU and the card, and the files of
the two packages are interchangeable.

* mixtures: :func:`save_mixture` / :func:`load_mixture` /
  :func:`load_mixture_params`
* variational Bayes: :func:`save_vb` / :func:`load_vb` (pairs with the
  ``posterior2prior`` warm-restart API, ``variational.pyx:211-231``)
* adaptive Markov chains: :func:`save_chain_state` / :func:`load_chain_state`
"""

import os

import numpy as _np
import torch

__all__ = [
    "atomic_savez",
    "is_primary_process",
    "save_mixture",
    "load_mixture",
    "load_mixture_params",
    "save_vb",
    "load_vb",
    "save_chain_state",
    "load_chain_state",
]


def is_primary_process():
    """True unless this is a non-zero rank of an initialized
    ``torch.distributed`` group: every rank runs the same host pipeline, so
    only rank 0 writes a checkpoint path."""
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def _host(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else _np.asarray(v)


def atomic_savez(path, **arrays):
    """Crash-safe ``np.savez``: write to a temp name beside ``path``, fsync,
    then atomically replace ``path``, so a process killed mid-save never
    leaves a truncated archive that later resumes would fail on.  Tensors
    are copied to the host first.  On a non-zero rank (see
    :func:`is_primary_process`) nothing is written.

    Raises ``TypeError`` naming the key of an array of object dtype (a
    ragged list, ``None``, an arbitrary object): ``np.load`` refuses such
    an entry without ``allow_pickle``, so the file could never be read
    back."""
    if not is_primary_process():
        return
    # convert before any file exists, so a failing conversion leaves none
    arrays = {k: _host(v) for k, v in arrays.items()}
    for k, v in arrays.items():
        if v.dtype == object:
            raise TypeError("checkpoint entry %r has object dtype (%r); only numeric "
                            "arrays can be saved" % (k, type(v.flat[0]) if v.size else v))
    path = str(path)
    tmp = "%s.tmp.%d" % (path, os.getpid())
    try:
        with open(tmp, "wb") as fh:
            _np.savez(fh, **arrays)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def save_mixture(path, mixture, extra=None):
    """Save a :class:`~pypmc_tpu_torch.density.mixture.MixtureDensity` or
    stacked :class:`~pypmc_tpu_torch.density.core.MixtureParams` to
    ``path`` (.npz, written atomically).  ``extra`` is an optional dict of
    further arrays stored alongside (e.g. a config fingerprint); the
    loaders ignore unknown fields."""
    from .density.core import MixtureParams

    if not isinstance(mixture, MixtureParams):
        mixture = mixture.stacked_params(dtype=torch.float64, device="cpu")
    arrays = dict(means=mixture.means, cov=mixture.cov, weights=mixture.weights)
    if mixture.dof is not None:
        arrays["dof"] = mixture.dof
    arrays.update(extra or {})
    atomic_savez(path, **arrays)


def load_mixture_params(path, device=None):
    """Load stacked :class:`~pypmc_tpu_torch.density.core.MixtureParams`
    (derived quantities recomputed) from ``path``, on ``device`` (default:
    :func:`pypmc_tpu_torch.default_device`) in the working dtype there."""
    from .density import core

    with _np.load(path) as data:
        params, _ = core.make_mixture(
            data["means"], data["cov"], data["weights"],
            data["dof"] if "dof" in data else None, device=device)
    return params


def load_mixture(path):
    """Load a host-side :class:`~pypmc_tpu_torch.density.mixture.MixtureDensity`
    from ``path`` (built in float64 on the CPU: the host classes hold
    numpy arrays)."""
    from .density.mixture import MixtureDensity

    return MixtureDensity.from_params(load_mixture_params(path, device="cpu"))


def save_vb(path, vb):
    """Save the full hyperparameter state (prior and posterior) of a
    :class:`~pypmc_tpu_torch.mix_adapt.variational.GaussianInference`."""
    atomic_savez(path, **vb.prior_posterior())


def load_vb(path, data, weights=None, **kwargs):
    """Rebuild a :class:`~pypmc_tpu_torch.mix_adapt.variational.GaussianInference`
    on ``data`` from a saved hyperparameter state; the first E-step is
    recomputed, so the instance is usable at once.  ``kwargs`` go to the
    constructor (e.g. ``device``)."""
    from .mix_adapt.variational import GaussianInference

    with _np.load(path) as f:
        state = {k: f[k] for k in f.files}
    components = int(state.pop("components"))
    return GaussianInference(data, components=components, weights=weights,
                             **state, **kwargs)


def save_chain_state(path, mc):
    """Save the adaptation state of an
    :class:`~pypmc_tpu_torch.sampler.markov_chain.AdaptiveMarkovChain` (the
    sample History is not included)."""
    atomic_savez(
        path,
        current_point=mc.current_point,
        current_target_eval=mc.current_target_eval,
        proposal_sigma=mc.proposal.sigma,
        unscaled_sigma=mc.unscaled_sigma,
        covar_scale_factor=mc.covar_scale_factor,
        adapt_count=mc.adapt_count,
    )


def load_chain_state(path, mc):
    """Restore state saved by :func:`save_chain_state` into an existing
    chain ``mc`` (constructed with the same target)."""
    with _np.load(path) as f:
        mc.current_point = f["current_point"].copy()
        mc.current_target_eval = float(f["current_target_eval"])
        mc.proposal.update(f["proposal_sigma"])
        mc.unscaled_sigma = f["unscaled_sigma"].copy()
        mc.covar_scale_factor = float(f["covar_scale_factor"])
        mc.adapt_count = int(f["adapt_count"])
    return mc
