"""The ported examples ``examples_torch/`` of PMC and the pipeline on the
CPU: ``pmc_large_scale.py``, ``launch_2proc.py`` (two gloo ranks),
``pmc_sharded.py``, ``pmc.py`` (also in a fresh interpreter, which must
load no JAX), ``integrate_evidence.py`` and
``uniting_markov_chains_and_variational_bayes.py``, each of which draws its
own stream and so is held, at a reduced size, to the expectations its JAX
counterpart in ``examples/`` prints; and ``mixture_reduction.py``, whose
inputs are numpy's, against the JAX example's results in float64."""

import os
import subprocess
import sys

import numpy as np
import torch
from torch_examples_support import (  # noqa: F401 (fixtures)
    REPO, jax_example, on_the_cpu, port_example, workdir)

torch.set_num_threads(1)


def test_pmc_large_scale_example_finds_the_modes(workdir):
    """examples/pmc_large_scale.py's expectation: the weight mass near the
    target's two modes within 0.05 of [0.3, 0.7], at 5 x 10^4 particles a
    step (10 steps)."""
    out = port_example("pmc_large_scale").main(["--device", "cpu", "--particles", "50000"])
    assert out["ranks"] == 1 and out["n_total"] == 50_000
    np.testing.assert_allclose(out["masses"], [0.3, 0.7], atol=0.05)
    assert np.all(np.isfinite(out["ess"])) and out["ess"][-1] > 0.5
    assert len(out["per_step_ms"]) == 3 and len(out["digest"]) == 16


def test_launch_2proc_two_gloo_ranks_agree(workdir, monkeypatch):
    """Two gloo ranks of pmc_large_scale.py at 2 x 10^4 particles, 3 steps,
    each within 300 s: both exit 0 and print the same adapted digest."""
    launcher = port_example("launch_2proc")
    monkeypatch.setattr(launcher, "TIMEOUT", 300)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = launcher.main(["--device", "cpu", "--particles", "20000", "--steps", "3"])
    assert out["returncodes"] == [0, 0], [o[-2000:] for o in out["outputs"]]
    assert out["ok"] and len(out["digests"]) == 2 and len(set(out["digests"])) == 1
    assert "mesh: 2 rank(s) on cpu; 20000 particles per PMC step" in out["outputs"][0]


def test_pmc_sharded_example_finds_the_modes(workdir):
    """examples/pmc_sharded.py's expectation: the weight mass near the
    target's two modes within 0.05 of [0.3, 0.7]."""
    out = port_example("pmc_sharded").main(["--device", "cpu"])
    assert out["ranks"] == 1 and out["n_total"] == 1001
    np.testing.assert_allclose(out["masses"], [0.3, 0.7], atol=0.05)


def test_pmc_example_loads_neither_jax_nor_the_jax_package(workdir):
    """``python examples_torch/pmc.py --device cpu`` in a fresh interpreter:
    it runs, and neither jax nor pypmc_tpu is in ``sys.modules`` after."""
    path = os.path.join(REPO, "examples_torch", "pmc.py")
    probe = ("import runpy, sys; sys.argv = [%r, '--device', 'cpu']; "
             "runpy.run_path(%r, run_name='__main__'); "
             "loaded = sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'pypmc_tpu')); print('LOADED', loaded)" % (path, path))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", probe], env=env, cwd=workdir,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.splitlines()[-1] == "LOADED []", out.stdout[-2000:]
    assert "final   component weights" in out.stdout


def test_pmc_example_recovers_the_target_weights(workdir):
    """examples/pmc.py's expectation: weights 0.3/0.7 (within 0.05), the
    third component dead."""
    w = port_example("pmc").main(["--device", "cpu"])["weights"]
    assert abs(w[0] - 0.3) < 0.05 and abs(w[1] - 0.7) < 0.05 and w[2] == 0.0, w
    assert (workdir / "pmc_example.png").exists()


def test_integrate_evidence_example_within_one_percent(workdir):
    """examples/integrate_evidence.py's assert: the evidence within 1% of
    1, at D=8, 16 chains and 2^15 importance samples."""
    out = port_example("integrate_evidence").main(
        ["--device", "cpu", "--dim", "8", "--chains", "16", "--is-samples", "32768"])
    assert abs(out["evidence"] - 1.0) < 0.01 and out["ess"] > 0.15


def test_uniting_example_integral_within_one_percent(workdir):
    """examples/uniting_markov_chains_and_variational_bayes.py's estimate:
    the integral within 1% of 1, at 10 chains x 500 x 10 steps."""
    out = port_example("uniting_markov_chains_and_variational_bayes").main(
        ["--device", "cpu", "--cycles", "10"])
    assert abs(out["integral"] - 1.0) < 0.01, out
    assert out["vb2_K"] >= 1 and 0.0 < out["ess"] <= 1.0
    assert (workdir / "uniting_example.png").exists()


def test_mixture_reduction_equals_the_jax_example(workdir, monkeypatch):
    """Numpy's 400 components give the same reductions in both packages:
    Hierarchical (10 components) and VBMerge's survivors (1), to 1e-8
    relative in float64."""
    ref = jax_example("mixture_reduction", monkeypatch)
    out = port_example("mixture_reduction").main(["--device", "cpu"])
    assert out["hierarchical_steps"] == ref["steps"]
    for got, want, n in ((out["hierarchical"], ref["h"].g, 10),
                         (out["vb_mixture"], ref["vb_mix"], 1)):
        assert len(got) == len(want) == n
        np.testing.assert_allclose(got.weights, want.weights, rtol=1e-8)
        for a, b in zip(got.components, want.components):
            np.testing.assert_allclose(a.mu, b.mu, rtol=1e-8, atol=1e-12)
            np.testing.assert_allclose(a.sigma, b.sigma, rtol=1e-8, atol=1e-12)
