"""The proposal's random inputs and the float64 route, against pypmc_tpu.

``ops.kernels.draw_proposal_inputs`` (kernel ``csrc/draw.cu`` on the card)
is the port's counterpart of ``jax.random`` in the JAX package's
``propose_T``; its plain version runs here, and with ``propose_T`` it is
held to the JAX package's draw in distribution (the two draw different
numbers from the same seed).  The gates send anything but float32 on the
card to the unfused path, as ``pypmc_tpu.density.core.use_pallas`` sends
any array that is not float32 to XLA: the decision is evaluated here for a
card's dtype, and the unfused routes it takes are run here, with the card's
decision forced for CPU tensors, against the JAX package's XLA path in
float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import pypmc_tpu.density.core as jcore
import pypmc_tpu.mix_adapt.pmc as jpmc
import pypmc_tpu.mix_adapt.variational as jvb
import pypmc_tpu_torch
from pypmc_tpu_torch.density import core
from pypmc_tpu_torch.mix_adapt import pmc
from pypmc_tpu_torch.mix_adapt import variational as tvb
from pypmc_tpu_torch.ops import _build, kernels

torch.set_num_threads(1)

# a p-value below this fails a test of a distribution (every draw is seeded,
# so a run is deterministic; the bound says how unlikely the fixed draws
# would have to be)
P_MIN = 1e-4


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless the CPU is asked for: ask for it."""
    with pypmc_tpu_torch.using_device("cpu"):
        yield


def mixture(rng, K, D, student_t, dead, dtype):
    means = rng.normal(0, 3, (K, D))
    a = rng.normal(0, 0.3, (K, D, D))
    covs = np.eye(D)[None] + np.einsum("kij,klj->kil", a, a)
    w = rng.uniform(0.5, 1.5, K)
    if dead:
        w[K // 2] = 0.0
        if K > 2:
            w[-1] = 0.0       # a dead trailing component too
    dofs = rng.uniform(3, 9, K) if student_t else None
    cast = lambda v: None if v is None else v.astype(dtype)
    jp, valid = jcore.make_mixture(cast(means), cast(covs), cast(w / w.sum()), cast(dofs))
    assert bool(np.asarray(valid).all())
    return jp, core.params_from_numpy(jp)


def whitened(params, xT, latent):
    """``U_k (x - mu_k)`` of each particle with its component, ``(D, n)``:
    standard normal coordinates, or Student-t with the component's dof."""
    U, mu = np.asarray(params.inv_chol), np.asarray(params.means)
    x, lat = np.asarray(xT).T, np.asarray(latent)
    return np.einsum("nij,nj->in", U[lat], x - mu[lat])


def frequencies_hold(latent, weights, n):
    """The components' counts against the weights: a chi-square test on
    the live components, and no draw of a dead one."""
    counts = np.bincount(np.asarray(latent), minlength=len(weights))
    live = weights > 0
    assert counts[~live].sum() == 0, counts
    if live.sum() > 1:
        assert stats.chisquare(counts[live], n * weights[live] / weights[live].sum()
                               ).pvalue > P_MIN, counts


def coordinates_hold(w, latent, dofs):
    """Each whitened coordinate standard normal (Gaussian) or Student-t
    with its component's dof: the probability transform of every
    coordinate uniform (KS)."""
    lat = np.asarray(latent)
    u = stats.norm.cdf(w) if dofs is None else stats.t.cdf(w, np.asarray(dofs)[lat][None, :])
    assert stats.kstest(u.ravel(), "uniform").pvalue > P_MIN


# K, D, Student-t, dead components, dtype, particles
DRAW_CASES = [(3, 40, True, False, np.float64, 20000), (3, 40, False, True, np.float32, 20000),
              (1, 40, True, False, np.float32, 8000), (5, 5, True, True, np.float64, 30000),
              (4, 7, False, False, np.float32, 1000)]


@pytest.mark.parametrize("case", DRAW_CASES)
def test_plain_draw_in_distribution(case):
    """The plain version's components, normals and Student-t scales: the
    components' frequencies against the weights (a dead component never
    drawn), the normals standard (KS, mean 0, variance 1 to 5 standard
    errors), and ``dof / scale^2`` chi-square with the component's dof
    (KS); without normals only the components, the same ones."""
    K, D, student_t, dead, dtype, n = case
    rng = np.random.default_rng(K * 100 + D)
    jp, tp = mixture(rng, K, D, student_t, dead, dtype)
    ops = core._kernel_operands(tp)
    cumw, dof = ops.fields()["cumw"], tp.dof
    latent, zT, scale = kernels.draw_proposal_inputs((7, 8), cumw, dof, n, D, True)
    assert latent.dtype == torch.int32 and zT.dtype == scale.dtype == tp.means.dtype
    assert zT.shape == (D, n) and scale.shape == (n,)
    frequencies_hold(latent.numpy(), np.asarray(jp.weights, dtype=np.float64), n)
    z = zT.double().numpy()
    assert stats.kstest(z.ravel(), "norm").pvalue > P_MIN
    se = 1 / np.sqrt(z.size)
    assert abs(z.mean()) < 5 * se and abs(z.var() - 1) < 5 * np.sqrt(2) * se
    if student_t:
        nu = dof.double().numpy()[latent.numpy()]
        chi2 = nu / scale.double().numpy() ** 2
        assert stats.kstest(stats.chi2.cdf(chi2, nu), "uniform").pvalue > P_MIN
    else:
        assert torch.all(scale == 1)
    only, none_z, none_s = kernels.draw_proposal_inputs((7, 8), cumw, dof, n, D, False)
    assert none_z is None and none_s is None and torch.equal(only, latent)


@pytest.mark.parametrize("case", DRAW_CASES)
def test_propose_against_the_jax_package_in_distribution(case):
    """``propose_T`` (the plain draw, then the route its gate takes: the
    drawn transform, fused_transform's plain version or the tensor
    transform) against the JAX package's ``propose_T`` on the same mixture:
    both packages' components hold to the weights, both packages' whitened
    coordinates to their laws, and the two whitened samples agree (a
    two-sample KS on every coordinate at once and on the squared norms)."""
    K, D, student_t, dead, dtype, n = case
    rng = np.random.default_rng(K * 100 + D)
    jp, tp = mixture(rng, K, D, student_t, dead, dtype)
    xT, latent = core.propose_T(tp, 11, n)
    jxT, jlatent = jcore.propose_T(jp, jax.random.PRNGKey(11), n)
    assert xT.dtype == tp.means.dtype and xT.shape == (D, n)
    weights = np.asarray(jp.weights, dtype=np.float64)
    dofs = None if tp.dof is None else tp.dof.numpy()
    w = whitened(jp, xT.double().numpy(), latent.numpy())
    jw = whitened(jp, np.asarray(jxT, dtype=np.float64), np.asarray(jlatent))
    for lat, white in ((latent.numpy(), w), (np.asarray(jlatent), jw)):
        frequencies_hold(lat, weights, n)
        coordinates_hold(white, lat, dofs)
    assert stats.ks_2samp(w.ravel(), jw.ravel()).pvalue > P_MIN
    assert stats.ks_2samp((w ** 2).sum(0), (jw ** 2).sum(0)).pvalue > P_MIN


def test_draw_seeds():
    """The same words draw the same inputs; other words, others; K=1 draws
    component 0 only."""
    rng = np.random.default_rng(3)
    _, tp = mixture(rng, 1, 3, True, False, np.float32)
    cumw = core._kernel_operands(tp).fields()["cumw"]
    a = kernels.draw_proposal_inputs((1, 2), cumw, tp.dof, 500, 3, True)
    b = kernels.draw_proposal_inputs((1, 2), cumw, tp.dof, 500, 3, True)
    c = kernels.draw_proposal_inputs((1, 3), cumw, tp.dof, 500, 3, True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[1], c[1])
    assert torch.all(a[0] == 0)


# ------------------------------------------------------------------ #
# float64 on the card: the unfused path, as the JAX package's XLA      #
# ------------------------------------------------------------------ #

GATE_SHAPES = [(10, 10, 2), (1, 1, 1), (30, 10, 2), (2, 40, 2), (12, 40, 2), (400, 10, 2),
               (100, 2, 2), (1, 129, 1), (16, 8, 2)]


@pytest.mark.parametrize("kernel", _build.KERNELS)
def test_the_gates_refuse_float64_on_the_card(kernel, monkeypatch):
    """For operands on a CUDA device (a ``(device, dtype)`` pair: the
    decision needs no live tensor), the gates refuse every dtype but
    float32, as ``use_pallas`` refuses an array that is not float32 (with
    the Pallas kernels enabled off the TPU, as in interpret mode); float32
    on the card and any dtype on the CPU decide by the shape alone."""
    monkeypatch.setenv("PYPMC_TPU_PALLAS_INTERPRET", "1")
    assert not jcore.use_pallas(jnp.zeros(4, jnp.float64))
    assert jcore.use_pallas(jnp.zeros(4, jnp.float32))
    rule = {"n_steps": 400} if kernel == "fused_mcmc_pool" else {}
    for K, D, Kt in GATE_SHAPES:
        shape = kernels.fits(kernel, K, D, Kt, **rule)
        for like in (("cuda", torch.float32), ("cpu", torch.float64), ("cpu", torch.float32),
                     torch.zeros(1, dtype=torch.float64)):
            assert kernels.fits(kernel, K, D, Kt, like=like, **rule) == shape, (K, D, like)
        for dtype in (torch.float64, torch.float16):
            assert not kernels.fits(kernel, K, D, Kt, like=("cuda", dtype), **rule)
            assert "not float32" in kernels.refusal(kernel, K, D, Kt, like=("cuda:0", dtype),
                                                    **rule)


@pytest.mark.parametrize("kernel", ["fused_pmc_stats", "fused_vb_estep", "fused_is_pmc_step"])
def test_route_counts_the_float64_refusal(kernel):
    """``route`` returns None for float64 on the card where float32 takes
    the dense or the K-blocked kernel, and counts the route as
    ``plain:<kernel>``; ``gate`` counts its refusals alike."""
    card64, card32 = ("cuda", torch.float64), ("cuda", torch.float32)
    kernels.reset_launch_counts()
    for K, D, N in ((10, 10, 1 << 20), (100, 2, 2 * 10 ** 7)):
        assert kernels.route(kernel, K, D, N, 2, like=card32) in ("dense", "blocked")
        assert kernels.route(kernel, K, D, N, 2, like=card64) is None
    assert kernels.elects_blocked(kernel, 100, 2, 2 * 10 ** 7, 2, like=card32)
    assert not kernels.elects_blocked(kernel, 100, 2, 2 * 10 ** 7, 2, like=card64)
    assert not kernels.gate("fused_logq", 10, 10, like=card64)
    assert kernels.gate("fused_logq", 10, 10, like=card32)
    counts = kernels.launch_counts()
    assert counts["plain:" + kernel] == 2 and counts["plain:fused_logq"] == 1
    assert sum(counts.values()) == 3


@pytest.fixture()
def float64_card(monkeypatch):
    """Every CPU tensor decided as if it lay on the card: the gates then
    send float64 to the unfused path, as they do on a CUDA device."""
    def card_dtype(like):
        if like is None:
            return None
        return like.dtype if isinstance(like, torch.Tensor) else like[1]

    monkeypatch.setattr(kernels, "_card_dtype", card_dtype)
    kernels.reset_launch_counts()


def assert_params_close(got, ref, rtol=1e-10, atol=1e-12):
    for f, v in core.params_to_numpy(got).items():
        r = getattr(ref, f)
        if v is None:
            assert r is None
            continue
        np.testing.assert_allclose(v, np.asarray(r), rtol=rtol, atol=atol, err_msg=f)


@pytest.mark.parametrize("student_t", [True, False])
def test_float64_pmc_update_on_the_card_is_the_xla_update(float64_card, student_t):
    """``pmc_update`` of float64 particles the gate decides for the card
    takes the unfused path (no kernel's plain version; fused_rho's and
    fused_maha's refusals counted) and equals the JAX package's XLA update
    to 1e-10."""
    rng = np.random.default_rng(21)
    jp, tp = mixture(rng, 4, 6, student_t, True, np.float64)
    xT = rng.normal(0, 3, (6, 3000))
    w = rng.exponential(1.0, 3000)
    got = pmc.pmc_update(tp, torch.tensor(xT), torch.tensor(w), transposed=True)
    ref = jpmc.pmc_update(jp, jnp.asarray(xT), jnp.asarray(w), rb=True, transposed=True,
                          fused="off", dof_solver_steps=100 if student_t else 0)
    assert_params_close(got.params, ref.params)
    counts = kernels.launch_counts()
    assert counts["plain:fused_pmc_stats"] == 1 and counts["plain:fused_rho"] == 1
    assert counts["plain:fused_maha"] == int(student_t)


def test_float64_step_and_vb_on_the_card_take_the_unfused_path(float64_card):
    """A float64 PMC step against a mixture target decided for the card
    draws through propose_T (the components and normals of the draw, the
    tensor transform) and evaluates unfused: its refusals counted, its
    update the JAX package's XLA update of its particles; one VB iteration
    of float64 data takes the unfused E-step and equals the JAX package's
    XLA iteration to 1e-10."""
    rng = np.random.default_rng(22)
    jp, tp = mixture(rng, 3, 5, True, False, np.float64)
    jt, tt = mixture(rng, 2, 5, False, False, np.float64)
    result, xT, w, latent, sw = pmc.pmc_step_mixture_target(tp, tt, 5, 2048)
    counts = kernels.launch_counts()
    for name in ("fused_is_pmc_step", "fused_propose_logq", "fused_transform_rng",
                 "fused_transform", "fused_pmc_stats", "fused_rho"):
        assert counts["plain:" + name] == 1, name
    assert counts["plain:fused_logq"] == 2
    ref = jpmc.pmc_update(jp, jnp.asarray(xT.numpy()), jnp.asarray(w.numpy()), rb=True,
                          transposed=True, fused="off", dof_solver_steps=100)
    assert_params_close(result.params, ref.params)
    frequencies_hold(latent.numpy(), np.asarray(jp.weights), 2048)

    data = rng.normal(0, 1, (1500, 3)) + np.repeat(rng.normal(0, 4, (3, 3)), 500, axis=0)
    prior = dict(components=3, alpha0=np.array([1.0, 1.5, 2.0]), beta0=np.ones(3),
                 nu0=np.array([4.0, 5.0, 6.0]), m0=rng.normal(0, 4, (3, 3)),
                 W0=np.array([np.eye(3)] * 3))
    kernels.reset_launch_counts()
    vb = tvb.GaussianInference(torch.tensor(data), **prior)
    jvbi = jvb.GaussianInference(jnp.asarray(data), **prior)
    vb.update()
    jvbi.update()
    assert kernels.launch_counts()["plain:fused_vb_estep"] == 2   # constructor and update
    for name in ("alpha", "beta", "nu", "m", "W", "N_comp"):
        np.testing.assert_allclose(tvb._host(getattr(vb, name)),
                                   np.asarray(getattr(jvbi, name)),
                                   rtol=1e-10, atol=1e-12, err_msg=name)
