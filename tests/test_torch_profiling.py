"""pypmc_tpu_torch.profiling on the CPU: ``timed`` records a block's
seconds without touching CUDA, ``trace`` writes a Chrome trace holding the
ranges that the PMC step and the pipeline's stages open."""

import glob
import json
import os

import numpy as np
import pytest
import torch

import pypmc_tpu_torch
from pypmc_tpu_torch import profiling
from pypmc_tpu_torch.density import core
from pypmc_tpu_torch.parallel import pmc_run_sharded
from pypmc_tpu_torch.pipeline import integrate

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless the CPU is asked for: ask for it."""
    with pypmc_tpu_torch.using_device("cpu"):
        yield


@pytest.fixture
def no_cuda(monkeypatch):
    """Any use of CUDA fails the test."""
    def refuse(*args, **kwargs):
        raise AssertionError("CUDA was touched on the CPU")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.cuda, "current_device", refuse)


def test_timed_appends_label_and_seconds(no_cuda):
    results = []
    with profiling.timed("work", results):
        torch.ones(1000).sum()
    with profiling.timed():
        pass
    assert len(results) == 1
    label, seconds = results[0]
    assert label == "work" and 0.0 <= seconds < 60.0


def test_timed_without_cuda_and_without_a_requested_device(no_cuda, monkeypatch):
    """Without CUDA the port's device is no card, so there is nothing to
    wait for even where the CPU was not asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pypmc_tpu_torch.using_device(None):
        results = []
        with profiling.timed("x", results):
            pass
    assert results[0][0] == "x"


def _events(logdir):
    (path,) = glob.glob(os.path.join(logdir, "trace_*.json"))
    with open(path) as f:
        return [e.get("name", "") for e in json.load(f)["traceEvents"]]


def _problem():
    D = 3
    target = core.make_mixture(torch.tensor(np.stack([np.zeros(D), np.full(D, 3.0)])),
                               torch.tensor(np.array([np.eye(D)] * 2)),
                               torch.tensor([0.3, 0.7], dtype=torch.float64))[0]
    params = core.make_mixture(torch.tensor(np.random.default_rng(0).normal(1.5, 2, (4, D))),
                               torch.tensor(np.array([np.eye(D) * 4.0] * 4)))[0]
    return target, params


def test_trace_holds_the_pmc_step_range(tmp_path):
    target, params = _problem()
    with profiling.trace(str(tmp_path)) as logdir:
        pmc_run_sharded(target, params, 2048, 2, key=1)
    assert logdir == str(tmp_path)
    names = _events(logdir)
    assert names.count("pmc_step") == 2
    # outside a trace the range is a context that does nothing
    assert not torch.autograd.profiler._is_profiler_enabled
    with profiling.annotate("pmc_step"):
        pass


def test_trace_holds_the_pipeline_stages(tmp_path):
    target = pypmc_tpu_torch.density.create_gaussian_mixture(
        np.stack([np.zeros(2), np.full(2, 3.0)]), np.array([np.eye(2) * 0.7] * 2),
        np.array([0.4, 0.6]))
    rng = np.random.default_rng(0)
    starts = np.vstack([rng.normal(0, 1.5, (6, 2)), rng.normal(3, 1.5, (6, 2))])
    with profiling.trace(str(tmp_path)) as logdir:
        r = integrate(target, 2, starts, key=0, mcmc_steps=100, mcmc_cycles=4,
                      n_is1=1 << 11, n_is2=1 << 12, pmc_steps=2)
    names = set(_events(logdir))
    for stage in ("mcmc", "vb1", "is1_vb2", "pmc", "is2_combine"):
        assert stage + "_s" in r.details and stage in names, stage


def test_trace_default_directory_is_under_the_temporary_directory(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", None)
    with profiling.trace() as logdir:
        torch.ones(3).sum()
    assert logdir == os.path.join(str(tmp_path), "pypmc_tpu_torch_trace")
    assert glob.glob(os.path.join(logdir, "trace_*.json"))
