"""The ported examples ``examples_torch/`` on the CPU, against the JAX
package's ``examples/``: the host-path examples ``variational.py``,
``r_group.py`` and ``markov_chain.py``, the device rule and the imports of
all ten (``pmc.py`` and ``mixture_reduction.py`` are in
``test_torch_examples_pmc.py``, which takes as long).

Where an example's inputs are numpy's, the port's computation on the JAX
example's inputs (run with ``runpy``) is held to the JAX example's results
in float64; where the port draws its own stream, its example, at a reduced
size, is held to the expectations the JAX example prints.
"""

import ast
import os
import sys

import numpy as np
import pytest
import torch
from torch_examples_support import (  # noqa: F401 (fixtures)
    REPO, jax_example, on_the_cpu, port_example, workdir)

from pypmc_tpu_torch.mix_adapt import GaussianInference

EXAMPLES = ("pmc_large_scale", "launch_2proc", "pmc_sharded", "pmc", "integrate_evidence",
            "uniting_markov_chains_and_variational_bayes", "variational",
            "mixture_reduction", "r_group", "markov_chain")
# what an example of the port may import: the standard library aside
ALLOWED = {"torch", "numpy", "scipy", "pypmc_tpu_torch", "matplotlib"}

torch.set_num_threads(1)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_neither_jax_nor_the_jax_package(name):
    with open(os.path.join(REPO, "examples_torch", name + ".py")) as f:
        tree = ast.parse(f.read())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            imported.add(node.module.split(".")[0])
    assert "pypmc_tpu_torch" in imported or name == "launch_2proc"
    assert not imported & {"jax", "jaxlib", "pypmc_tpu"}
    assert imported - ALLOWED <= set(sys.stdlib_module_names), imported - ALLOWED


@pytest.mark.parametrize("name", EXAMPLES)
def test_without_cuda_an_example_raises_unless_the_cpu_is_asked_for(name, monkeypatch):
    """The device rule: ``--device`` defaults to the card, and without CUDA
    the example raises before it computes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_example(name).main([])


def test_variational_fit_of_the_jax_examples_data(workdir, monkeypatch):
    """The port's fit of the JAX example's 500 draws equals the JAX
    example's fit: the components' counts, means and covariances to 1e-8
    relative, and the converged iteration.  The packages sum in different
    orders, so at the fixed point the port's bound may still move in its
    last bits where the JAX package's repeats exactly: the port converges
    at the JAX iteration or one later, and from the JAX iteration on its
    bound moves by no more than float64 rounding."""
    ref = jax_example("variational", monkeypatch)
    vb = GaussianInference(np.array(ref["data"]), 20)
    bounds, update = [], vb._update_with_bound

    def recorded():
        bounds.append(update())
        return bounds[-1]

    vb._update_with_bound = recorded
    converged = vb.run(100)
    assert converged - ref["converged"] in (0, 1), (converged, ref["converged"])
    fixed = np.array(bounds[ref["converged"] - 2:])
    np.testing.assert_allclose(fixed, fixed[0], rtol=1e-13, atol=0)
    np.testing.assert_allclose(vb.N_comp.numpy(), np.asarray(ref["vb"].N_comp), rtol=1e-8)
    got, want = vb.make_mixture(), ref["fit_mixture"]
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got.weights, want.weights, rtol=1e-8)
    for a, b in zip(got.components, want.components):
        np.testing.assert_allclose(a.mu, b.mu, rtol=1e-8)
        np.testing.assert_allclose(a.sigma, b.sigma, rtol=1e-8)


def test_variational_example_keeps_two_components(workdir):
    """examples/variational.py's expectation: of K=20, two survive."""
    out = port_example("variational").main(["--device", "cpu"])
    assert out["converged"] is not None and len(out["mixture"]) == 2
    assert np.allclose(np.sort(out["mixture"].weights), [0.3, 0.7], atol=0.05)


def test_r_group_of_the_jax_examples_chains(workdir, monkeypatch):
    """The port's r_group and make_r_gaussmix on the JAX example's five
    chains: the same groups, the same long-patches mixture to 1e-10."""
    ref = jax_example("r_group", monkeypatch)
    groups, mixture = port_example("r_group").group(ref["stacked_values"])
    assert groups == ref["found_groups"] == [[0, 1], [2, 3, 4]]
    want = ref["result"]
    assert len(mixture) == len(want)
    np.testing.assert_allclose(mixture.weights, want.weights, rtol=1e-10)
    for a, b in zip(mixture.components, want.components):
        np.testing.assert_allclose(a.mu, b.mu, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(a.sigma, b.sigma, rtol=1e-10, atol=1e-14)


def test_r_group_example_finds_the_two_groups(workdir):
    """examples/r_group.py's expectation, exactly, at 5 x (100 + 4 x 250)
    steps."""
    out = port_example("r_group").main(["--device", "cpu", "--runs", "4", "--steps", "250"])
    assert out["groups"] == [[0, 1], [2, 3, 4]]
    assert out["chain_steps"] == 5 * (100 + 4 * 250)


def test_markov_chain_example_finds_the_target_mean(workdir):
    """examples/markov_chain.py's expectation: the sample mean within 0.05
    of the target's, at 2,000 burn-in and 20 x 500 steps."""
    out = port_example("markov_chain").main(["--device", "cpu", "--burn-in", "2000",
                                             "--runs", "20"])
    np.testing.assert_allclose(out["mean"], [4.3, 1.1], atol=0.05)
    assert 0.0 < out["accept_rate"] < 1.0 and out["chain_steps"] == 12_000
