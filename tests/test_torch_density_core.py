"""pypmc_tpu_torch.density.core against pypmc_tpu.density.core: the
deterministic functions in float64 against the JAX XLA path, and the
proposal draws (the plain version of fused_propose_logq) in distribution."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pypmc_tpu.density.core as jcore
import pypmc_tpu_torch
from pypmc_tpu_torch.density import core

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless the CPU is asked for: ask for it."""
    with pypmc_tpu_torch.using_device("cpu"):
        yield

RTOL64, ATOL64 = 1e-10, 1e-12


def mixture(rng, K, D, student_t, dead=False):
    means = rng.normal(0, 2, (K, D))
    a = rng.normal(0, 0.4, (K, D, D))
    covs = np.eye(D)[None] + np.einsum("kij,klj->kil", a, a)
    w = rng.uniform(0.5, 1.5, K)
    if dead:
        w[K // 2] = 0.0
    dofs = rng.uniform(6, 12, K) if student_t else None
    jp, valid = jcore.make_mixture(means, covs, w / w.sum(), dofs)
    assert bool(np.asarray(valid).all())
    return jp, core.params_from_numpy(jp)


def moments(p):
    """Mean and covariance of the mixture (numpy, float64)."""
    w = p.weights.numpy()
    means, covs = p.means.numpy(), p.cov.numpy()
    scale = np.ones_like(w) if p.dof is None else p.dof.numpy() / (p.dof.numpy() - 2)
    mean = w @ means
    second = np.einsum("k,kij->ij", w, covs * scale[:, None, None]
                       + np.einsum("ki,kj->kij", means, means))
    return mean, second - np.outer(mean, mean)


def test_params_numpy_roundtrip_and_make_mixture():
    rng = np.random.default_rng(0)
    jp, tp = mixture(rng, 4, 3, True)
    back = core.params_to_numpy(tp)
    for f, v in back.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jp, f)))
    means, covs, dofs = back["means"], back["cov"], back["dof"]
    w = rng.uniform(size=4)
    tp2, valid = core.make_mixture(torch.tensor(means), torch.tensor(covs),
                                   torch.tensor(w), torch.tensor(dofs))
    jp2, jvalid = jcore.make_mixture(means, covs, w, dofs)
    assert valid.all() and bool(np.asarray(jvalid).all())
    for f, v in core.params_to_numpy(tp2).items():
        np.testing.assert_allclose(v, np.asarray(getattr(jp2, f)), rtol=RTOL64,
                                   atol=ATOL64, err_msg=f)


@pytest.mark.parametrize("student_t,dead", [(True, False), (False, True)])
def test_mixture_logpdf_matches_jax(student_t, dead):
    rng = np.random.default_rng(1)
    jp, tp = mixture(rng, 4, 5, student_t, dead)
    x = rng.normal(0, 3, (301, 5))
    ref = np.asarray(jcore.mixture_logpdf_T(jp, jnp.asarray(x.T)))
    got = core.mixture_logpdf_T(tp, torch.tensor(x.T.copy())).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL64, atol=ATOL64)
    np.testing.assert_allclose(core.mixture_logpdf(tp, torch.tensor(x)).numpy(), ref,
                               rtol=RTOL64, atol=ATOL64)
    np.testing.assert_allclose(
        core.component_logpdfs(tp, torch.tensor(x)).numpy(),
        np.asarray(jcore.component_logpdfs(jp, jnp.asarray(x))), rtol=RTOL64, atol=ATOL64)
    np.testing.assert_allclose(
        core.mahalanobis_all_T(tp, torch.tensor(x.T.copy())).numpy(),
        np.asarray(jcore.mahalanobis_all_T(jp, jnp.asarray(x.T))), rtol=RTOL64, atol=ATOL64)


def test_cumulative_weights_tail_sums():
    w = np.array([0.2, 0.0, 0.5, 0.3, 0.0])
    got = core._cumulative_weights(torch.tensor(w)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcore._cumulative_weights(jnp.asarray(w))))
    assert got[-1] == 1.0 and got[0] == got[1] and got[3] == got[4]


def test_update_masked_matches_jax_and_guards_all_dead():
    rng = np.random.default_rng(2)
    jp, tp = mixture(rng, 3, 4, True)
    means = rng.normal(size=(3, 4))
    covs = np.array(tp.cov.numpy())
    covs[1] = -covs[1]                    # this update fails: component dies
    w = np.array([0.5, 0.3, 0.2])
    dofs = np.array([5.0, 6.0, 7.0])
    mask = np.array([True, True, False])
    jnew, jok = jcore.update_masked(jp, means, covs, w, dofs, jnp.asarray(mask))
    new, ok = core.update_masked(tp, torch.tensor(means), torch.tensor(covs),
                                 torch.tensor(w), torch.tensor(dofs), torch.tensor(mask))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    for f, v in core.params_to_numpy(new).items():
        np.testing.assert_allclose(v, np.asarray(getattr(jnew, f)), rtol=RTOL64,
                                   atol=ATOL64, err_msg=f)
    dead, ok = core.update_masked(tp, torch.tensor(means), -torch.tensor(np.abs(covs)),
                                  torch.tensor(w))
    assert not ok.any()
    assert torch.equal(dead.weights, torch.zeros(3, dtype=torch.float64))


@pytest.mark.parametrize("K,D,student_t,dead", [
    (4, 3, True, True), (1, 1, True, False), (1, 5, False, False),
    (3, 1, False, False), (5, 7, True, False)])
def test_propose_logq_distribution(K, D, student_t, dead):
    """The plain fused_propose_logq: odd N, latent frequencies against the
    weights, dead components never drawn, moments against the mixture's,
    and log q / log p against the JAX XLA evaluation of the same points."""
    rng = np.random.default_rng(K * 10 + D)
    jp, tp = mixture(rng, K, D, student_t, dead)
    jt, tt = mixture(rng, 2, D, not student_t)
    N = 40001
    xT, lat, log_q, log_p = core.propose_logq_T(tp, 7, N, tt)
    assert xT.shape == (D, N) and lat.shape == (N,) and lat.dtype == torch.int32
    x = xT.numpy()
    assert np.isfinite(x).all()
    counts = np.bincount(lat.numpy(), minlength=K)
    w = tp.weights.numpy()
    assert counts.shape == (K,)
    assert np.all(counts[w == 0] == 0)
    sd = np.sqrt(N * w * (1 - w))
    assert np.all(np.abs(counts - N * w) <= 5 * sd + 1e-9)
    mean, cov = moments(tp)
    m = x.mean(axis=1)
    assert np.all(np.abs(m - mean) < 6 * np.sqrt(np.diag(cov) / N))
    c = np.cov(x).reshape(D, D)
    assert np.all(np.abs(c - cov) < 0.1 * np.sqrt(np.outer(np.diag(cov), np.diag(cov))))
    np.testing.assert_allclose(log_q.numpy(), np.asarray(jcore.mixture_logpdf_T(jp, x)),
                               rtol=RTOL64, atol=ATOL64)
    np.testing.assert_allclose(log_p.numpy(), np.asarray(jcore.mixture_logpdf_T(jt, x)),
                               rtol=RTOL64, atol=ATOL64)


def test_propose_seeds_and_generators():
    rng = np.random.default_rng(3)
    _, tp = mixture(rng, 3, 2, True)
    a = core.propose_logq_T(tp, 11, 500)
    b = core.propose_logq_T(tp, 11, 500)
    c = core.propose_logq_T(tp, 12, 500)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert torch.equal(core.propose_logq_T(tp, np.int64(11), 500)[0], a[0])
    gen = torch.Generator().manual_seed(4)
    d, e = core.propose_T(tp, gen, 500), core.propose_T(tp, gen, 500)
    assert not torch.equal(d[0], e[0])           # a generator advances
    f, g = core.propose(tp, None, 10), core.propose(tp, None, 10)
    assert f[0].shape == (10, 2) and not torch.equal(f[0], g[0])   # default stream
    with pytest.raises(TypeError):
        core.propose_T(tp, "seed", 5)
