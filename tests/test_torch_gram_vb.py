"""fused_vb_estep's Gram pass (``csrc/gram_stats.cuh`` in its VB mode, D = 17
to 128 where K D <= 128) on the CPU: a torch mirror of the mode's reduction
(the coordinates reversed as the kernel stages them, float32 sums over a
tile's column slices, float64 block partials added in slice order, the
blocks' rows summed in block order) against the plain version in float64,
the plain version against the JAX package's Pallas kernel in interpret
mode, the plan that elects the pass, and ``GaussianInference`` of both
packages at shapes that take it.  The kernel itself runs only on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import pypmc_tpu.ops.pallas_kernels as pk
from pypmc_tpu.mix_adapt import variational as jvb
import pypmc_tpu_torch
from pypmc_tpu_torch.mix_adapt import variational as tvb
from pypmc_tpu_torch.ops import _build, kernels

torch.set_num_threads(1)

# (K, D): the Gram pass's most components (K D <= 128 at D = 17), two
# components at the record draws' last D, one past them
GRAM_SHAPES = [(7, 17), (2, 64), (1, 96)]
# the statistics per particle (divided by N) within ATOL + RTOL max |float64
# plain version| per output, chip_smoke.py's TOL["stats"]: float32
# projections and sums over at most 64 columns against float64
ATOL, RTOL = 1e-6, 1e-4
# the plain float32 version against the Pallas kernel's float32 (interpret
# mode), per particle, as tests/test_torch_ops.py holds them
ATOL_JAX = RTOL_JAX = 2e-3
# GaussianInference of both packages in float64 (tests/test_torch_variational.py)
RTOL64, ATOL64 = 1e-9, 1e-11
NAMES = ("N_comp", "sd", "g", "log_q_Z")


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless the CPU is asked for: ask for it."""
    with pypmc_tpu_torch.using_device("cpu"):
        yield


@pytest.fixture()
def interpret(monkeypatch):
    monkeypatch.setattr(pk, "INTERPRET", True)


def vb_operands(rng, K, D):
    """VB's float32 operands: ``A_k = sqrt(nu_k) chol(W_k)^T`` (upper
    triangular), the means and the constants."""
    a = rng.normal(0, 0.4, (K, D, D)) / np.sqrt(D)
    W = np.linalg.inv(np.eye(D)[None] + np.einsum("kij,klj->kil", a, a))
    nu = rng.uniform(D, D + 5, K)
    A = np.sqrt(nu)[:, None, None] * np.transpose(np.linalg.cholesky(W), (0, 2, 1))
    m = rng.normal(0, 0.3, (K, D))
    const = rng.normal(0, 1, K)
    return [torch.tensor(v, dtype=torch.float32) for v in (A, m, const)]


def particles(rng, m, N):
    """N particles near the means and weights, a third of them 0."""
    K, D = m.shape
    xT = m[torch.tensor(rng.integers(0, K, N))].T + torch.tensor(
        rng.normal(0, 1.0, (D, N)), dtype=torch.float32)
    w = torch.tensor(rng.exponential(1.0, N), dtype=torch.float32)
    w[::3] = 0.0
    return xT.contiguous(), w


def vb_gram_mirror(xT, w, a, m, const, n_blocks):
    """The statistics as ``csrc/gram_stats.cuh``'s VB mode reduces them:
    the coordinates reversed as the kernel stages them (xT's row D - 1 - j
    into row j, m reversed, A' = J A J, of which the pass reads the lower
    triangle: A's upper one); block b of ``n_blocks`` walks tiles b, b +
    n_blocks, ... of ``_build._GRAM_P`` particles (zero past N); a tile's
    projections, log rho = c - maha / 2, the plain log-sum-exp, w r and
    w r (log rho - lse) in float32; the scalar rows summed over the tile
    in float32; g' and sd' summed in float32 over each of the pass's column
    slices, the S slices' sums joined pairwise in lane order, reversed back
    (g_ij from g'(D-1-j, D-1-i)) and added into the block's float64
    accumulators; the blocks' rows summed in block order (the kernel's
    float64 output)."""
    K, D = a.shape[:2]
    N, P = xT.shape[1], _build._GRAM_P
    slices = _build.gram_layout(K, D)[0]
    rev = torch.arange(D - 1, -1, -1)
    a_low = torch.tril(a[:, rev][:, :, rev])
    m_rev = m[:, rev]
    E = kernels._entries(K, D)
    PC = (E - 3) // K
    rows, cols = torch.tril_indices(D, D)
    flat = torch.zeros(E, dtype=torch.float64)
    for b in range(n_blocks):
        acc = torch.zeros(E, dtype=torch.float64)
        for tile in range(b, -(-N // P), n_blocks):
            n0 = tile * P
            n = min(P, N - n0)
            x = torch.zeros((D, P), dtype=torch.float32)
            x[:, :n] = xT[rev, n0:n0 + n]
            wt = torch.zeros(P, dtype=torch.float32)
            wt[:n] = w[n0:n0 + n]
            diff = a_low @ (x[None] - m_rev[:, :, None])
            log_rho = const[:, None] - 0.5 * torch.sum(diff * diff, dim=1)
            log_r = log_rho - torch.logsumexp(log_rho, dim=0)[None]
            wr = wt[None] * torch.exp(log_r)
            t1 = wr * log_r
            for k in range(K):
                acc[k * PC:k * PC + 3] += torch.stack(
                    [wr[k].sum(), wr[k].sum(), t1[k].sum()]).double()
            acc[K * PC:] += torch.stack(
                [wt.sum(), (wt * wt).sum(), torch.special.xlogy(wt, wt).sum()]).double()
            cd = wr[:, None, :] * diff
            parts = [(torch.einsum("kip,kjp->kij", cd[:, :, s::slices], diff[:, :, s::slices]),
                      cd[:, :, s::slices].sum(-1)) for s in range(slices)]
            while len(parts) > 1:
                parts = [(u[0] + v[0], u[1] + v[1]) for u, v in zip(parts[::2], parts[1::2])]
            g_rev, sd_rev = parts[0]
            g = g_rev[:, rev][:, :, rev].transpose(1, 2)
            sd = sd_rev[:, rev]
            for k in range(K):
                acc[k * PC + 3:k * PC + 3 + D] += sd[k].double()
                acc[k * PC + 3 + D:(k + 1) * PC] += g[k, rows, cols].double()
        flat += acc
    stats = kernels._unpack_stats(flat, K, D, 0)
    return stats["s0"], stats["sd"], stats["g"], stats["t1"].sum()


def assert_close_per_particle(got, ref, n, atol, rtol):
    for name, g, r in zip(NAMES, got, ref):
        g, r = g.double() / n, r.double() / n
        bound = atol + rtol * float(r.abs().max())
        err = float((g - r).abs().max())
        assert err <= bound, (name, err, bound)


@pytest.mark.parametrize("K,D", GRAM_SHAPES)
def test_vb_gram_mirror_matches_the_plain_version_in_float64(K, D):
    """The mirror of the VB mode's reduction at a ragged N >= 1024 (a last
    tile of 17 particles), three blocks, a third of the weights 0, against
    plain_vb_estep in float64 on the same float32 inputs, per particle
    within ATOL + RTOL max|plain|.  The mirror reads A's upper triangle
    alone: with NaN below A's diagonal it gives the same statistics.  The
    plain float32 version (the CPU's route of the wrapper) within the same
    tolerance."""
    assert _build.dense_plan("fused_vb_estep", K, D)[0] == "gram"
    rng = np.random.default_rng(K * 1000 + D)
    a, m, const = vb_operands(rng, K, D)
    N = 1024 + 17
    xT, w = particles(rng, m, N)
    ref = kernels.plain_vb_estep(xT.double(), w.double(), a.double(), m.double(),
                                 const.double())
    got = vb_gram_mirror(xT, w, a, m, const, n_blocks=3)
    assert_close_per_particle(got, ref, N, ATOL, RTOL)
    below = a.clone()
    i, j = torch.tril_indices(D, D, -1)
    below[:, i, j] = float("nan")
    for g, u in zip(got, vb_gram_mirror(xT, w, below, m, const, n_blocks=3)):
        assert bool(torch.equal(g, u))
    assert_close_per_particle(kernels.fused_vb_estep(xT, w, a, m, const), ref, N, ATOL, RTOL)


@pytest.mark.parametrize("n_blocks", [1, 2, 17])
def test_vb_gram_mirror_is_the_same_sum_in_any_grid(n_blocks):
    """The mirror's statistics do not depend on the grid beyond float32
    rounding (the kernel's grid is one wave of blocks, which differs by
    card): 1, 2 and 17 blocks within the float64 tolerance of each other."""
    K, D = 2, 64
    rng = np.random.default_rng(5)
    a, m, const = vb_operands(rng, K, D)
    N = 1024 + 33
    xT, w = particles(rng, m, N)
    one = vb_gram_mirror(xT, w, a, m, const, 1)
    assert_close_per_particle(vb_gram_mirror(xT, w, a, m, const, n_blocks), one, N, ATOL, RTOL)


@pytest.mark.parametrize("K,D", GRAM_SHAPES)
def test_plain_vb_estep_matches_pallas_interpret_at_gram_shapes(interpret, K, D):
    """plain_vb_estep (the Gram pass's plain version, float32) against the
    JAX package's fused_vb_estep in interpret mode on the same particles,
    weights and operands, N = 1024 + 77, a third of the weights 0."""
    rng = np.random.default_rng(K + D)
    a, m, const = vb_operands(rng, K, D)
    N = 1024 + 77
    xT, w = particles(rng, m, N)
    b2 = torch.einsum("kid,kd->ki", a, m).reshape(K * D, 1)
    ref = pk.fused_vb_estep(jnp.asarray(xT.numpy()), jnp.asarray(w.numpy()),
                            jnp.asarray(a.reshape(K * D, D).numpy()), jnp.asarray(b2.numpy()),
                            jnp.asarray(const.reshape(K, 1).numpy()), dim=D)
    got = kernels.fused_vb_estep(xT, w, a, m, const, variant="gram")
    for name, g, r in zip(NAMES, got, ref):
        np.testing.assert_allclose(g.numpy() / N, np.asarray(r) / N, rtol=RTOL_JAX,
                                   atol=ATOL_JAX, err_msg=name)


def test_the_plan_elects_the_gram_pass_past_d16():
    """_build.dense_plan("fused_vb_estep") is fused_pmc_stats' Gram plan
    (64 particles a tile, its slices, 8 x 8 blocks and shared memory) at
    every (K, D) chip_smoke.py holds the pass to on the card (its
    GRAM_SHAPES: the JAX rule's reach past D = 16), the register pass to D =
    16 as before, and the entry table where neither fits (K = 137, D = 1)
    or past the JAX rule's K D <= 128 (K = 5, D = 40); the wrapper's
    variant= takes the Gram pass and the entry table there, not the
    register pass."""
    for K, D in chip_smoke.GRAM_SHAPES:
        plan = _build.dense_plan("fused_vb_estep", K, D)
        assert plan == _build.dense_plan("fused_pmc_stats", K, D), (K, D)
        assert plan == ("gram", _build._GRAM_P) + _build.gram_layout(K, D), (K, D)
        assert plan[4] <= _build.SMEM_LIMIT
        assert kernels._elect("fused_vb_estep", K, D, None) == "gram"
        assert kernels._elect("fused_vb_estep", K, D, "table") == "table"
        with pytest.raises(ValueError, match="the plan"):
            kernels._elect("fused_vb_estep", K, D, "reg")
    for K, D in ((10, 10), (16, 10), (8, 16), (1, 16), (128, 1)):
        assert _build.dense_plan("fused_vb_estep", K, D)[0] == "reg", (K, D)
    assert _build.dense_plan("fused_vb_estep", 137, 1)[0] == "table"
    assert _build.dense_plan("fused_vb_estep", 5, 40)[0] == "table"


def clusters(K, D, N=2048, seed=3):
    """N weighted points around K centres in D dimensions (float64)."""
    rng = np.random.default_rng(seed + K * D)
    centers = rng.normal(0, 4, (K, D))
    data = centers[np.arange(N) % K] + rng.normal(0, 1, (N, D))
    return data, np.abs(rng.normal(1, 0.2, N))


@pytest.mark.parametrize("K,D", [(6, 20), (3, 40)])
def test_gaussian_inference_on_the_gram_shapes_matches_the_jax_package(K, D):
    """GaussianInference of both packages in float64 at K D = 120 past D =
    16 (the port's one-pass E-step, whose card route is the Gram pass; 2048
    points): the first E-step and three updates with their bounds, to
    RTOL64 (tests/test_torch_variational.py's tolerances)."""
    data, weights = clusters(K, D)
    assert kernels.route("fused_vb_estep", K, D, len(data), like=torch.zeros(1, dtype=torch.float64))
    assert _build.dense_plan("fused_vb_estep", K, D)[0] == "gram"
    kernels.reset_launch_counts()
    t = tvb.GaussianInference(data, components=K, weights=weights)
    j = jvb.GaussianInference(data, components=K, weights=weights)
    assert t._e.r is None           # the one-pass E-step ran
    assert kernels.launch_counts()["plain:fused_vb_estep"] == 0
    fields = ("N_comp", "x_mean_comp", "S")
    for f in fields:
        np.testing.assert_allclose(tvb._host(getattr(t, f)), np.asarray(getattr(j, f)),
                                   rtol=RTOL64, atol=ATOL64, err_msg=f)
    for _ in range(3):
        np.testing.assert_allclose(t._update_with_bound(), j._update_with_bound(), rtol=RTOL64,
                                   err_msg="bound")
    for f in fields + ("alpha", "beta", "nu", "m", "W", "log_det_W"):
        np.testing.assert_allclose(tvb._host(getattr(t, f)), np.asarray(getattr(j, f)),
                                   rtol=RTOL64, atol=ATOL64, err_msg=f)
