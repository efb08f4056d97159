"""The Gram statistics pass of fused_pmc_stats and fused_is_pmc_step
(``csrc/gram_stats.cuh``, D = 17 to 128 where K D <= 128) on the CPU: a
torch mirror of the pass's reduction (float32 sums over a tile's column
slices, float64 block partials added in slice order, the blocks' rows
summed in block order) against the plain version in float64, and both plain
versions against the JAX package's Pallas kernels in interpret mode.  The
kernel itself runs only on the card (``tests/test_torch_kernels_gpu.py``,
``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pypmc_tpu.density.core as jcore
import pypmc_tpu.ops.pallas_kernels as pk
import pypmc_tpu_torch
from pypmc_tpu_torch.density import core
from pypmc_tpu_torch.ops import _build, kernels

torch.set_num_threads(1)

# (K, D): the Gram pass's most components (K D <= 128 at D = 17), two
# components at the record draws' last D, one past them
GRAM_SHAPES = [(7, 17), (2, 64), (1, 96)]
# the statistics per particle (divided by N) within ATOL + RTOL max |float64
# plain version| per output, chip_smoke.py's TOL["stats"]: float32 whitening
# and sums over at most 64 columns against float64
ATOL, RTOL = 1e-6, 1e-4
# the plain float32 version against the Pallas kernel's float32 (interpret
# mode), per particle: two float32 paths summed in different orders, as
# tests/test_torch_ops.py holds them
ATOL_JAX = RTOL_JAX = 2e-3
KEYS = ("s0", "s0c", "sd", "g", "sw", "t1")


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless the CPU is asked for: ask for it."""
    with pypmc_tpu_torch.using_device("cpu"):
        yield


@pytest.fixture()
def interpret(monkeypatch):
    monkeypatch.setattr(pk, "INTERPRET", True)
    monkeypatch.setattr(jcore, "use_pallas", lambda *a, **k: True)


def spd(rng, K, D):
    a = rng.normal(0, 0.4, (K, D, D)) / np.sqrt(D)
    return np.eye(D)[None] + np.einsum("kij,klj->kil", a, a)


def mixture(rng, K, D, student_t, dead):
    """A float32 mixture (the JAX package's params and the port's), means
    near one another so that every live component takes particles; a dead
    component (weight 0) at K // 2 where ``dead``."""
    means = rng.normal(0, 0.5, (K, D))
    w = rng.uniform(0.5, 1.5, K)
    if dead:
        w[K // 2] = 0.0
    dofs = rng.uniform(4, 12, K) if student_t else None
    cast = lambda v: None if v is None else v.astype(np.float32)
    jp, valid = jcore.make_mixture(cast(means), cast(spd(rng, K, D)), cast(w / w.sum()),
                                   cast(dofs))
    assert bool(np.asarray(valid).all())
    return jp, core.params_from_numpy(jp)


def gram_mirror(xT, w, ops, dof_stats, n_blocks):
    """The statistics as ``csrc/gram_stats.cuh`` reduces them: block b of
    ``n_blocks`` walks tiles b, b + n_blocks, ... of ``_build._GRAM_P``
    particles (zero past N); a tile's whitened differences, log q, rho,
    gamma, c and t1 in float32; the scalar rows summed over the tile in
    float32; g and sd summed in float32 over each of the pass's column
    slices (columns s, s + S, ...), the S slices' sums joined pairwise in
    lane order (the xor shuffles' tree) in float32 and added into the
    block's float64 accumulators; the blocks' rows summed in block order,
    then cast to float32 (the kernel's output)."""
    K, D, N = ops.K, ops.dim, xT.shape[1]
    P = _build._GRAM_P
    slices = _build.gram_layout(K, D)[0]
    f = ops.fields()
    E = kernels._entries(K, D)
    PC = (E - 3) // K
    rows, cols = torch.tril_indices(D, D)
    flat = torch.zeros(E, dtype=torch.float64)
    for b in range(n_blocks):
        acc = torch.zeros(E, dtype=torch.float64)
        for tile in range(b, -(-N // P), n_blocks):
            n0 = tile * P
            m = min(P, N - n0)
            x = torch.zeros((D, P), dtype=torch.float32)
            x[:, :m] = xT[:, n0:n0 + m]
            wt = torch.zeros(P, dtype=torch.float32)
            wt[:m] = w[n0:n0 + m]
            diff, maha, ind = kernels._component_logpdfs_T(x, f, D, ops.student_t)
            rho, _ = kernels._rho_from_logpdfs(ind, f["weights"][:, None])
            wrho = rho * wt[None, :]
            gamma = torch.ones_like(wrho)
            t1 = torch.zeros_like(wrho)
            if ops.student_t:
                nu = f["dof"][:, None]
                gamma = (nu + D) / (nu + maha)
                if dof_stats:
                    t1 = wrho * (torch.log(0.5 * (maha + nu)) - f["psi"][:, None] + gamma)
            c = wrho * gamma
            for k in range(K):
                acc[k * PC:k * PC + 3] += torch.stack(
                    [wrho[k].sum(), c[k].sum(), t1[k].sum()]).double()
            acc[K * PC:] += torch.stack(
                [wt.sum(), (wt * wt).sum(), torch.special.xlogy(wt, wt).sum()]).double()
            cd = c[:, None, :] * diff
            parts = [(torch.einsum("kip,kjp->kij", cd[:, :, s::slices], diff[:, :, s::slices]),
                      cd[:, :, s::slices].sum(-1)) for s in range(slices)]
            while len(parts) > 1:
                parts = [(a[0] + b[0], a[1] + b[1]) for a, b in zip(parts[::2], parts[1::2])]
            g, sd = parts[0]
            for k in range(K):
                acc[k * PC + 3:k * PC + 3 + D] += sd[k].double()
                acc[k * PC + 3 + D:(k + 1) * PC] += g[k, rows, cols].double()
        flat += acc
    return kernels._unpack_stats(flat.float(), K, D, 3)


def assert_stats_close(got, ref, n, atol, rtol, keys=KEYS):
    for key in keys:
        g, r = got[key].double() / n, ref[key].double() / n
        if key == "sw":   # fused_pmc_stats' sum w, sum w^2 (the step's sum w log w too)
            r = r[:g.shape[0]]
        bound = atol + rtol * float(r.abs().max())
        err = float((g - r).abs().max())
        assert err <= bound, (key, err, bound)


def particles(rng, ops, N):
    """N particles near the mixture and weights, a third of them 0."""
    xT = torch.tensor(rng.normal(0, 1.2, (ops.dim, N)), dtype=torch.float32)
    xT += ops.fields()["mu"][0][:, None]
    w = torch.tensor(rng.exponential(1.0, N), dtype=torch.float32)
    w[::3] = 0.0
    return xT, w


@pytest.mark.parametrize("K,D", GRAM_SHAPES)
@pytest.mark.parametrize("student_t,dof_stats", [(True, True), (True, False), (False, False)])
def test_gram_mirror_matches_the_plain_version_in_float64(K, D, student_t, dof_stats):
    """The mirror of the pass's reduction at a ragged N >= 1024 (a last tile
    of 17 particles), three blocks, against plain_pmc_stats in float64 on
    the same float32 inputs, per particle within ATOL + RTOL max|plain|; a
    dead component's statistics exactly 0."""
    assert _build.dense_plan("fused_pmc_stats", K, D)[0] == "gram"
    assert _build.dense_plan("fused_is_pmc_step", K, D, 2)[0] == "gram"
    rng = np.random.default_rng(K * 1000 + D + 10 * student_t + dof_stats)
    dead = K > 1
    _, tp = mixture(rng, K, D, student_t, dead)
    ops = core._kernel_operands(tp)
    ops64 = kernels.MixtureOperands(ops.packed.double(), K, D, student_t)
    N = 1024 + 17
    xT, w = particles(rng, ops, N)
    got = gram_mirror(xT, w, ops, dof_stats, n_blocks=3)
    ref = kernels.plain_pmc_stats(xT.double(), w.double(), ops64, dof_stats, n_sw=3)
    assert_stats_close(got, ref, N, ATOL, RTOL)
    if dead:
        for key in ("s0", "s0c", "sd", "g", "t1"):
            assert bool((got[key][K // 2] == 0).all()), key
    # the plain version in float32 (the CPU's route of the wrapper) too
    plain32 = kernels.fused_pmc_stats(xT, w, ops, dof_stats)
    assert_stats_close(plain32, ref, N, ATOL, RTOL)


@pytest.mark.parametrize("n_blocks", [1, 2, 17])
def test_gram_mirror_is_the_same_sum_in_any_grid(n_blocks):
    """The mirror's statistics do not depend on the grid beyond float32
    rounding (the kernel's grid is one wave of blocks, which differs by
    card): 1, 2 and 17 blocks within the float64 tolerance of each other."""
    K, D = 2, 64
    rng = np.random.default_rng(5)
    _, tp = mixture(rng, K, D, True, False)
    ops = core._kernel_operands(tp)
    N = 1024 + 33
    xT, w = particles(rng, ops, N)
    one = gram_mirror(xT, w, ops, True, 1)
    assert_stats_close(gram_mirror(xT, w, ops, True, n_blocks), one, N, ATOL, RTOL)


def jax_stats(ref, K, D):
    """The JAX kernel's statistics in the shapes of plain_pmc_stats'."""
    out = {key: torch.tensor(np.asarray(ref[key])) for key in KEYS}
    for key in ("s0", "s0c", "t1", "sw"):
        out[key] = out[key].reshape(-1)
    out["sd"] = out["sd"].reshape(K, D)
    out["g"] = out["g"].reshape(K, D, D)
    return out


def _jax_operands(jp, K, D, student_t):
    a2, b2, ln, wk, dof, center = jcore._pallas_operands(jp, "inv_chol")
    psi = (jax.scipy.special.digamma(0.5 * (D + jp.dof)).reshape(K, 1).astype(jnp.float32)
           if student_t else None)
    return a2, b2, ln, wk, dof, center, psi


@pytest.mark.parametrize("K,D", GRAM_SHAPES)
def test_plain_pmc_stats_matches_pallas_interpret_at_gram_shapes(interpret, K, D):
    """plain_pmc_stats (the Gram pass's plain version, float32) against the
    JAX package's fused_pmc_stats in interpret mode on the same particles
    and weights, a ragged N >= 1024, a dead component where K > 1."""
    student_t = K != 2
    rng = np.random.default_rng(K + D)
    jp, tp = mixture(rng, K, D, student_t, dead=K > 1)
    ops = core._kernel_operands(tp)
    N = 1024 + 77
    xT, w = particles(rng, ops, N)
    a2, b2, ln, wk, dof, _, psi = _jax_operands(jp, K, D, student_t)
    ref = pk.fused_pmc_stats(jnp.asarray(xT.numpy()), jnp.asarray(w.numpy()), a2, b2, ln, wk,
                             dof, psi, dim=D, dof_stats=student_t)
    got = kernels.plain_pmc_stats(xT, w, ops, student_t)
    ref = jax_stats(ref, K, D)
    assert_stats_close(got, ref, N, ATOL_JAX, RTOL_JAX)


@pytest.mark.parametrize("K,D", GRAM_SHAPES)
def test_plain_is_pmc_step_matches_pallas_interpret_at_gram_shapes(interpret, K, D):
    """The step at the Gram pass's shapes: the JAX kernel's weights and
    statistics on its own draw (interpret mode, 2048 particles, a dead
    component where K > 1 never drawn) against the plain versions on the
    same particles: w = exp(plain log p - plain log q), plain_pmc_stats
    with sum w log w; and plain_is_pmc_step's own draw evaluated the same
    way (its draw is torch's, so only the arithmetic is compared)."""
    student_t = K != 2
    rng = np.random.default_rng(K * D)
    jp, tp = mixture(rng, K, D, student_t, dead=K > 1)
    jt, tt = mixture(rng, 2, D, not student_t, dead=False)
    n = 2048
    a2, b2, ln, wk, dof_col, center, psi_c = _jax_operands(jp, K, D, student_t)
    xT, latent, w, ref = pk.fused_is_pmc_step(
        jnp.array([3, 4], dtype=jnp.int32), jnp.cumsum(jp.weights).reshape(K, 1),
        jp.chol.reshape(K * D, D), jp.means.T, None if jp.dof is None else jp.dof.reshape(1, K),
        a2, b2, ln, wk, dof_col, center, psi_c, jcore._pallas_operands(jt, "inv_chol"),
        n=n, dim=D, dof_stats=student_t)
    if K > 1:
        assert not np.any(np.asarray(latent) == K // 2)
    x, wt = torch.tensor(np.asarray(xT)), torch.tensor(np.asarray(w))
    ops, tops = core._kernel_operands(tp), core._kernel_operands(tt)
    np.testing.assert_allclose(
        wt.numpy(), torch.exp(kernels.plain_logq(x, tops) - kernels.plain_logq(x, ops)).numpy(),
        rtol=2e-3, atol=1e-30)
    got = kernels.plain_pmc_stats(x, wt, ops, student_t, n_sw=3)
    ref = jax_stats(ref, K, D)
    assert_stats_close(got, ref, n, ATOL_JAX, RTOL_JAX)
    # the port's step (its plain version on the CPU, whatever the pass)
    xs, lat, ws, stats = kernels.fused_is_pmc_step((3, 4), ops, tops, n, student_t)
    if K > 1:
        assert not bool((lat == K // 2).any())
    torch.testing.assert_close(ws, torch.exp(kernels.plain_logq(xs, tops)
                                             - kernels.plain_logq(xs, ops)))
    ops64 = kernels.MixtureOperands(ops.packed.double(), K, D, student_t)
    ref64 = kernels.plain_pmc_stats(xs.double(), ws.double(), ops64, student_t, n_sw=3)
    assert_stats_close(stats, ref64, n, ATOL, RTOL)
