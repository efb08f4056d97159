"""The port's public parameter lists against pypmc_tpu's.

Every name in the ``__all__`` of a ported module (and each public method of
a class there) takes the JAX package's parameters in the JAX package's
order, so that a positional call means the same in both.  The only
differences allowed are the documented ones: trailing ``device`` and
``dtype`` (before a ``**kwargs``), and ``axis_name`` -> ``reduce`` in the
PMC update functions.  What has no counterpart in PyTorch stands in
explicit lists."""

import importlib
import inspect
import pkgutil

import jax  # noqa: F401  (the JAX package's modules import it)
import numpy as np
import pytest
import torch

import pypmc_tpu
import pypmc_tpu_torch
from pypmc_tpu_torch.density import core
from pypmc_tpu_torch.mix_adapt import GaussianInference
from pypmc_tpu_torch.parallel import pmc_run_sharded, run_is_step_sharded
from pypmc_tpu_torch.pipeline import integrate

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless the CPU is asked for: ask for it."""
    with pypmc_tpu_torch.using_device("cpu"):
        yield


def _modules(pkg):
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    return sorted(name.split(".", 1)[1] for name in names)


# modules of one package with no counterpart in the other (sampler._scan:
# the chains' CUDA graphs, where the JAX package jits a lax.scan)
PORT_ONLY_MODULES = {"_device", "ops._build", "ops.kernels", "sampler._scan"}
JAX_ONLY_MODULES = {"_version", "ops.pallas_kernels"}
# names of a JAX module's __all__ with no counterpart in PyTorch: the JAX
# keys, the Pallas switch, and the JAX sharding objects (each rank holds its
# shard of particles as an ordinary tensor)
UNPORTED = {
    "_rng": {"is_jax_key", "as_jax_key"},
    "density.core": {"use_pallas"},
    "parallel.mesh": {"particle_sharding", "replicated_sharding"},
}
# names of a port module's __all__ that the JAX module does not define
PORT_ONLY_NAMES = {
    "_rng": {"as_generator", "seed_words", "device_generator", "is_numpy_rng"},
    "density.core": {"params_from_numpy", "params_to_numpy"},
    "sampler._target": {"map_points"},
}
# the port hands its reductions over particles a callable where the JAX
# package names a mesh axis
REDUCE_FOR_AXIS = {"pmc_update", "pmc_step_mixture_target", "pmc_log_likelihood"}
TRAILING = ("device", "dtype")
SHARED = sorted(set(_modules(pypmc_tpu_torch)) - PORT_ONLY_MODULES)


def test_module_lists():
    port, ref = set(_modules(pypmc_tpu_torch)), set(_modules(pypmc_tpu))
    assert port - ref == PORT_ONLY_MODULES
    assert ref - port == JAX_ONLY_MODULES


def _params(fn):
    """``(names, var-keyword name or None)`` of a callable (a class: its
    ``__init__``)."""
    if inspect.isclass(fn):
        fn = fn.__init__
    names, var_kw = [], None
    for p in inspect.signature(fn).parameters.values():
        if p.kind is inspect.Parameter.VAR_KEYWORD:
            var_kw = p.name
        else:
            names.append(p.name)
    return names, var_kw


def _same_parameters(label, port_fn, jax_fn):
    port, port_kw = _params(port_fn)
    ref, ref_kw = _params(jax_fn)
    if label.split(".")[0] in REDUCE_FOR_AXIS:
        ref = ["reduce" if n == "axis_name" else n for n in ref]
    assert port[:len(ref)] == ref, (label, port, ref)
    extra = port[len(ref):]
    assert extra == [n for n in TRAILING if n in extra], (label, extra)
    assert port_kw == ref_kw, (label, port_kw, ref_kw)


def _public_methods(cls):
    return {name for name, v in vars(cls).items()
            if not name.startswith("_") and callable(v)}


@pytest.mark.parametrize("module", SHARED)
def test_parameters_match_the_jax_package(module):
    port = importlib.import_module("pypmc_tpu_torch." + module)
    ref = importlib.import_module("pypmc_tpu." + module)
    port_all, ref_all = getattr(port, "__all__", None), getattr(ref, "__all__", None)
    assert (port_all is None) == (ref_all is None), module
    if port_all is None:
        return
    assert set(ref_all) - set(port_all) == UNPORTED.get(module, set())
    assert {n for n in port_all if not hasattr(ref, n)} == PORT_ONLY_NAMES.get(module, set())
    for name in {n for n in port_all if hasattr(ref, n)}:
        p, r = getattr(port, name), getattr(ref, name)
        if not callable(p):
            continue
        _same_parameters(name, p, r)
        if inspect.isclass(p):
            for meth in _public_methods(r) & _public_methods(p):
                _same_parameters("%s.%s" % (name, meth), getattr(p, meth), getattr(r, meth))


@pytest.mark.parametrize("name", ["propose_T", "propose", "propose_logq_T"])
def test_draws_take_a_key(name):
    assert _params(getattr(core, name))[0][:2] == ["params", "key"]


@pytest.mark.parametrize("name", ["chi2_log", "chisquare", "student_t_scale"])
def test_chi_square_draws_take_a_key(name):
    from pypmc_tpu_torch.ops import random
    assert _params(getattr(random, name))[0][0] == "key"


def _problem():
    rng = np.random.default_rng(0)
    D = 3
    target = core.make_mixture(np.stack([np.zeros(D), np.full(D, 3.0)]),
                               np.array([np.eye(D)] * 2), np.array([0.3, 0.7]))[0]
    params = core.make_mixture(rng.normal(1.5, 2.0, size=(4, D)),
                               np.array([np.eye(D) * 4.0] * 4), None,
                               np.full((4,), 8.0))[0]
    return target, params


def test_positional_key_is_the_seed():
    """pmc_run_sharded(t, p, n, steps, None, 3): ``None`` fills ``mesh``
    and 3 is the seed, as in the JAX package."""
    target, params = _problem()
    a = pmc_run_sharded(target, params, 2048, 1, None, 3)
    b = pmc_run_sharded(target, params, 2048, 1, key=3)
    for f in ("means", "cov", "weights", "dof"):
        assert torch.equal(getattr(a[0], f), getattr(b[0], f)), f
    for x, y in zip(a[1], b[1]):
        assert torch.equal(x, y)
    xa = run_is_step_sharded(params, target, 5, 512, None, "particles")
    xb = run_is_step_sharded(params, target, 5, 512)
    for x, y in zip(xa, xb):
        assert torch.equal(x, y)


def _call_with_mesh(entry, mesh):
    target, params = _problem()
    if entry == "pmc_run_sharded":
        pmc_run_sharded(target, params, 64, 1, mesh=mesh)
    elif entry == "run_is_step_sharded":
        run_is_step_sharded(params, target, 0, 64, mesh=mesh)
    elif entry == "GaussianInference":
        GaussianInference(np.zeros((8, 2)), components=2, mesh=mesh)
    else:
        integrate(target, 3, np.zeros((4, 3)), mesh=mesh)


@pytest.mark.parametrize("entry", ["pmc_run_sharded", "run_is_step_sharded",
                                   "GaussianInference", "integrate"])
def test_a_mesh_is_refused(entry):
    """A mesh that is not the port's particle mesh (a JAX mesh, say) is
    refused."""
    with pytest.raises(TypeError, match="particle mesh"):
        _call_with_mesh(entry, object())


@pytest.mark.parametrize("entry", ["pmc_run_sharded", "run_is_step_sharded"])
def test_a_multi_rank_group_needs_a_mesh(entry, monkeypatch):
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="mesh=pypmc_tpu_torch.parallel"):
        _call_with_mesh(entry, None)
