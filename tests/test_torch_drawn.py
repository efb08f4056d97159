"""fused_transform_rng and fused_propose_logq past D = 64, on the CPU.

On the card both run a block-tiled product on normals drawn in shared
memory (``csrc/tiled.cuh`` ``DrawnX``, ``draw_tiled_kernel``); here their
plain versions run.  This file holds

- the plain versions at (K=1, D=200), (K=3, Kt=1, D=96) and (K=2, D=128)
  in float64: the samples' moments, components and Student-t scales in
  distribution, and log q and log p recomputed on the port's own samples
  against the JAX package's XLA path;
- the plans and the election (``_build.DRAW_TILED_D_MIN``, the looped
  kernel forcible to D = 128 only, no warp kernel);
- a mirror of the drawn tile walk: a numpy Philox-4x32-10 and Box-Muller,
  each panel drawn as ``draw_eight`` draws it (``drawn_panel_words``:
  which thread draws which rows from which words of which Philox blocks),
  the panels walked as the engine walks them (row tiles, triangular panels,
  row tile 0's panels kept past D = 128), the particles bucketed by
  component (``_build.transform_tiles``; in order at K = 1): the normals
  equal the looped kernel's sequential stream, each drawn once to D = 256,
  and the walk's product is ``plain_transform`` on those normals (and the
  JAX package's ``fused_transform`` on them, its Pallas kernel in interpret
  mode).

The kernels themselves run only on the card
(``tests/test_torch_kernels_gpu.py -k drawn``, ``chip_smoke.py``), where x
and latent are held to the looped kernels bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import pypmc_tpu.density.core as jcore
import pypmc_tpu.ops.pallas_kernels as pk
import pypmc_tpu_torch
from pypmc_tpu_torch.density import core
from pypmc_tpu_torch.ops import _build, kernels

torch.set_num_threads(1)

P_MIN = 1e-4          # a p-value below this fails a test of a distribution
RTOL64, ATOL64 = 1e-10, 1e-10


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless the CPU is asked for: ask for it."""
    with pypmc_tpu_torch.using_device("cpu"):
        yield


def mixture(rng, K, D, student_t, dead=False, dtype=np.float64, spread=2.0):
    means = rng.normal(0, spread, (K, D))
    a = rng.normal(0, 0.3, (K, D, D))
    covs = np.eye(D)[None] + np.einsum("kij,klj->kil", a, a) / D * 4
    w = rng.uniform(0.5, 1.5, K)
    if dead:
        w[K // 2] = 0.0
    dofs = rng.uniform(6, 12, K) if student_t else None
    cast = lambda v: None if v is None else v.astype(dtype)
    jp, valid = jcore.make_mixture(cast(means), cast(covs), cast(w / w.sum()), cast(dofs))
    assert bool(np.asarray(valid).all())
    return jp, core.params_from_numpy(jp)


def moments(params):
    w = params.weights.numpy()
    scale = np.ones_like(w) if params.dof is None else (params.dof / (params.dof - 2)).numpy()
    mu, cov = params.means.numpy(), params.cov.numpy()
    mean = w @ mu
    second = np.einsum("k,kij->ij", w, cov * scale[:, None, None]
                       + np.einsum("ki,kj->kij", mu, mu))
    return mean, second - np.outer(mean, mean)


def whitened_sq(params, xT, latent):
    """``|U_k (x - mu_k)|^2`` of each particle with its component."""
    U, mu = params.inv_chol.numpy(), params.means.numpy()
    x, lat = xT.numpy().T, latent.numpy()
    y = np.einsum("nij,nj->ni", U[lat], x - mu[lat])
    return np.sum(y * y, axis=1)


# (K, Kt, D): row 5's routes past D = 64 at the wide IS path's K = 1, D =
# 200, the PMC path's K = 3, Kt = 1 at D = 96, and row 4's K = 2 at D = 128
PLAIN_SHAPES = [(1, 0, 200), (3, 1, 96), (2, 0, 128)]


@pytest.mark.parametrize("K,Kt,D", PLAIN_SHAPES)
def test_plain_propose_logq_past_d64_against_the_jax_package(K, Kt, D):
    """fused_propose_logq's plain version (the wrapper on the CPU, float64):
    the components against the weights (a dead one never drawn), the
    samples' mean and covariance against the mixture's, the whitened
    squared distances against the chi-square (Gaussian) or D F(D, dof)
    (Student-t) law, and log q and log p on the port's own samples equal to
    the JAX package's XLA path's (float64, 1e-10)."""
    rng = np.random.default_rng(100 * K + D)
    jp, tp = mixture(rng, K, D, True, dead=K > 2)
    jt, tt = mixture(rng, max(Kt, 1), D, False, spread=1.0)
    N = 6000
    ops = core._kernel_operands(tp)
    out = kernels.fused_propose_logq((7, 1), ops, N, core._kernel_operands(tt) if Kt else None)
    xT, lat, log_q = out[:3]
    assert xT.shape == (D, N) and lat.dtype == torch.int32 and xT.dtype == torch.float64
    w = tp.weights.numpy()
    counts = np.bincount(lat.numpy(), minlength=K)
    assert counts.shape == (K,) and np.all(counts[w == 0] == 0)
    if (w > 0).sum() > 1:
        live = w > 0
        assert stats.chisquare(counts[live], N * w[live]).pvalue > P_MIN
    mean, cov = moments(tp)
    x = xT.numpy()
    assert np.all(np.abs(x.mean(axis=1) - mean) < 5 * np.sqrt(np.diag(cov) / N))
    assert np.all(np.abs(np.cov(x) - cov) < 0.25 * np.sqrt(np.outer(np.diag(cov), np.diag(cov))))
    m = whitened_sq(tp, xT, lat)
    for k in np.flatnonzero(w > 0):
        dof = float(tp.dof[k])
        assert stats.kstest(m[lat.numpy() == k] / D, stats.f(D, dof).cdf).pvalue > P_MIN
    np.testing.assert_allclose(log_q.numpy(), np.asarray(jcore.mixture_logpdf_T(jp, x)),
                               rtol=RTOL64, atol=ATOL64)
    if Kt:
        np.testing.assert_allclose(out[3].numpy(), np.asarray(jcore.mixture_logpdf_T(jt, x)),
                                   rtol=RTOL64, atol=ATOL64)
    # every variant the shape has runs the plain version here, alike
    for variant in kernels._transform_variants(D):
        again = kernels.fused_propose_logq((7, 1), ops, N, core._kernel_operands(tt) if Kt
                                           else None, variant=variant)
        assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.parametrize("K,Kt,D", PLAIN_SHAPES)
def test_plain_transform_rng_past_d64_in_distribution(K, Kt, D):
    """fused_transform_rng's plain version on given components (float64):
    each particle from its own component, the Student-t scales in law (the
    whitened squared distances D F(D, dof) a component), a Gaussian
    mixture's chi-square(D); log q of its samples the JAX package's."""
    rng = np.random.default_rng(200 * K + D)
    for student_t in (True, False):
        jp, tp = mixture(rng, K, D, student_t)
        N = 5000
        lat = torch.tensor(rng.integers(0, K, N), dtype=torch.int32)
        ops = core._kernel_operands(tp)
        xT = kernels.fused_transform_rng((3, 9), lat, ops)
        assert xT.shape == (D, N) and torch.isfinite(xT).all()
        m = whitened_sq(tp, xT, lat)
        for k in range(K):
            law = stats.f(D, float(tp.dof[k])) if student_t else stats.chi2(D, scale=1.0 / D)
            assert stats.kstest(m[lat.numpy() == k] / D, law.cdf).pvalue > P_MIN
        np.testing.assert_allclose(kernels.plain_logq(xT, ops).numpy(),
                                   np.asarray(jcore.mixture_logpdf_T(jp, xT.numpy())),
                                   rtol=RTOL64, atol=ATOL64)


@pytest.mark.parametrize("D", [65, 96, 128, 129, 200, 248, 2040])
def test_the_drawn_products_are_elected_past_d64(D):
    """From DRAW_TILED_D_MIN (65) fused_transform_rng and fused_propose_logq
    elect "tiled": the tiled engine's 256 threads and 41,600 B of shared
    memory, 107,136 B past D = 128 (row tile 0's eight panels: two blocks
    still share an SM), 128 particles a block; the looped kernel stays
    forcible to D = 128 only, the record kernel to 64, and the warp kernel
    is gone: "warp" raises ValueError; every (K, Kt) the JAX rule admits is
    within the kernels' limits."""
    assert _build.DRAW_TILED_D_MIN == 65
    want = ("tiled", False, 0, 256, 41_600 if D <= 128 else 107_136)
    assert _build.draw_tiled_smem(D) == want[4]
    for kernel in ("fused_transform_rng", "fused_propose_logq"):
        S = 1
        while kernels.fits("fused_propose_logq", S + 1, D):
            S += 1
        for K in range(1, S + 1):
            for Kt in (0, S - K) if kernel == "fused_propose_logq" else (0,):
                assert _build.draw_plan(kernel, K, D, Kt) == want
                assert kernels._elect(kernel, K, D, None, Kt) == "tiled"
                assert _build.limit_reason(kernel, K, D, Kt) is None
        assert _build.block_particles(kernel, D) == 128
        assert kernels._elect(kernel, 1, D, "tiled") == "tiled"
        for variant, ok in (("looped", D <= 128), ("rec", False), ("warp", False)):
            if ok:
                assert kernels._elect(kernel, 1, D, variant) == variant
            else:
                with pytest.raises(ValueError, match="the plan"):
                    kernels._elect(kernel, 1, D, variant)
    # below it the record kernel, with the looped and the drawn product forcible
    assert _build.draw_plan("fused_propose_logq", 2, 64, 1)[0] == "rec"
    assert kernels._transform_variants(64) == ("rec", "looped", "tiled")


def test_the_bucket_kernels_counts_limit_the_drawn_products_past_one_component():
    """The drawn products bucket their particles by component where K > 1
    (the bucket kernel's counts in a block's shared memory); at K = 1 they
    walk the particles in order, so K = 1 has no such limit."""
    most = max(K for K in range(1, 4000) if _build.transform_bucket_plan(K)[3] <= _build.SMEM_LIMIT)
    for kernel in ("fused_transform_rng", "fused_propose_logq"):
        assert _build.limit_reason(kernel, most, 65) is None
        assert "bucket" in _build.limit_reason(kernel, most + 1, 65)
        assert _build.limit_reason(kernel, 1, 2040) is None


# ------------------------------------------------------------------ #
# the drawn tile walk, mirrored                                       #
# ------------------------------------------------------------------ #

M32 = np.uint64(0xFFFFFFFF)


def philox(k0, k1, n, c2):
    """Philox-4x32-10 block ``c2`` of the streams (k0, k1, n) for particle
    indices ``n`` (an array): ``(4, len(n))`` uint32 words, as
    ``csrc/common.cuh`` ``PhiloxT::refill`` computes them."""
    n = np.asarray(n, np.uint64)
    x0, x1 = n & M32, n >> np.uint64(32)
    x2 = np.full_like(n, np.uint64(c2))
    x3 = np.zeros_like(n)
    a, b = np.uint64(k0), np.uint64(k1)
    for _ in range(10):
        p0 = np.uint64(0xD2511F53) * x0
        p1 = np.uint64(0xCD9E8D57) * x2
        x0, x1, x2, x3 = ((p1 >> np.uint64(32)) ^ x1 ^ a) & M32, p1 & M32, \
            ((p0 >> np.uint64(32)) ^ x3 ^ b) & M32, p0 & M32
        a = (a + np.uint64(0x9E3779B9)) & M32
        b = (b + np.uint64(0xBB67AE85)) & M32
    return np.stack([x0, x1, x2, x3])


def box_muller(w0, w1):
    """``Philox::box_muller`` in float64: (z0, z1) of two words."""
    u = ((w0 >> np.uint64(8)) + np.uint64(1)).astype(np.float64) / 16777216.0
    v = (w1 >> np.uint64(8)).astype(np.float64) / 16777216.0
    r = np.sqrt(-2.0 * np.log(u))
    return r * np.cos(2 * np.pi * v), r * np.sin(2 * np.pi * v)


def sequential_normals(key, n, off, D):
    """``draw_normals``' D normals of each particle of ``n`` from its stream
    after its first ``off`` words, read word by word as the looped kernel
    reads them (``next()``), ``(D, len(n))``; and the word the stream goes
    on at (the Student-t scale's)."""
    words = []
    blocks = (off + 2 * ((D + 1) // 2) + 3) // 4
    for c2 in range(blocks):
        words.extend(philox(*key, n, c2))
    z = np.zeros((D, len(n)))
    w = off
    for i in range(0, D, 2):
        z0, z1 = box_muller(words[w], words[w + 1])
        z[i] = z0
        if i + 1 < D:
            z[i + 1] = z1
        w += 2
    return z, w


def drawn_panel_words(p, off):
    """``[(rows, first Philox block, words), ...]`` of the two halves of a
    block drawing panel p (``csrc/tiled.cuh`` ``DrawnX``, ``draw_eight``):
    threads 0-127 draw rows 16 p .. 16 p + 7 of their column's particle,
    threads 128-255 rows 16 p + 8 .. 16 p + 15, each from its stream's words
    ``off + row`` (Box-Muller pairs on words off + 2 i, off + 2 i + 1 for
    rows 2 i, 2 i + 1), read from Philox blocks ``j // 4`` on, j the half's
    first row."""
    out = []
    for h in range(2):
        j = 16 * p + 8 * h
        out.append((tuple(range(j, j + 8)), j // 4, tuple(range(off + j, off + j + 8))))
    return out


def drawn_panel(key, cols, p, off, D):
    """Panel p (16 x len(cols)) as a block of the drawn product draws it:
    each half of the block (drawn_panel_words) its 8 rows of each column's
    particle from the Philox blocks that hold their words, zero past D and
    past the run (a column of -1)."""
    panel = np.zeros((16, len(cols)))
    live = cols >= 0
    n = np.where(live, cols, 0)
    for rows, first, words in drawn_panel_words(p, off):
        assert words[0] // 4 == first and len(rows) == 8
        have = np.concatenate([philox(*key, n, first + b) for b in range(3)])
        for q in range(4):
            z0, z1 = box_muller(have[words[2 * q] - 4 * first], have[words[2 * q + 1] - 4 * first])
            for r, z in ((2 * q, z0), (2 * q + 1, z1)):
                row = rows[r] - 16 * p
                panel[row] = np.where(live & (rows[r] < D), z, 0.0)
    return panel


def drawn_walk(key, off, latent, scale, mu, L):
    """The drawn product's function, walked as the engine walks it: the
    tiles (bucketed by component, ``_build.transform_tiles``; at K = 1 the
    particles in order, 128 a tile), each tile's row tiles of 128 rows and
    their triangular panels of 16, panel p drawn (or, past D = 128, row tile
    0's panels kept for the row tiles below: the cache) and the product
    accumulated panel by panel, ``x = mu_k + scale (L_k z)`` on each
    particle of the tile.  Returns x (NaN where no tile writes) and the
    number of times each (row, particle) normal was drawn."""
    K, D = mu.shape
    N = latent.shape[0]
    if K == 1:
        tiles = [(0, np.array([n if n < N else -1 for n in range(t, t + 128)]))
                 for t in range(0, N, 128)]
    else:
        perm, slots = _build.transform_tiles(latent, K)
        tiles = [(k, np.concatenate([perm[first:first + len_], -np.ones(128 - len_, int)]))
                 for k, first, len_, _ in slots[slots[:, 0] >= 0]]
    x = np.full((D, N), np.nan)
    draws = np.zeros((D, N), int)
    n_rows = -(-D // 128)
    for k, cols in tiles:
        cache = {}
        for rt in range(n_rows):
            acc = np.zeros((128, 128))
            for p in range((min(D, (rt + 1) * 128) - 1) // 16 + 1):
                if D > 128 and p < 8 and rt > 0:
                    z = cache[p]
                else:
                    z = drawn_panel(key, cols, p, off, D)
                    live = cols >= 0
                    for r in range(16):
                        if 16 * p + r < D:
                            draws[16 * p + r, cols[live]] += 1
                    if D > 128 and p < 8:
                        cache[p] = z
                row = rt * 128 + np.arange(128)[:, None]
                j = 16 * p + np.arange(16)[None, :]
                a = np.where((row < D) & (j < D) & (j <= row),
                             L[k][np.minimum(row, D - 1), np.minimum(j, D - 1)], 0.0)
                acc += a @ z
            for c, n in enumerate(cols):
                if n >= 0:
                    rows = slice(rt * 128, min(D, rt * 128 + 128))
                    x[rows, n] = mu[k, rows] + scale[n] * acc[:rows.stop - rows.start, c]
    return x, draws


@pytest.mark.parametrize("K,D,N,off", [(1, 65, 300, 0), (3, 65, 400, 1), (1, 130, 257, 1),
                                       (2, 200, 300, 0), (1, 270, 129, 1)])
def test_the_drawn_walk_is_the_plain_transform_on_the_streams_normals(K, D, N, off):
    """The walk over the drawn panels (the drawn product's function: its
    panel order, each thread's stream words, the bucketed particles, row
    tile 0's panels kept past D = 128) draws each particle's normals equal
    to the looped kernel's sequential stream (bit for bit in float64), each
    once to D = 256 (row tile 0's eight panels kept past 128; past 256 the
    panels right of them are drawn again by the row tiles below), and its
    product equals plain_transform on those normals (float64, 1e-12); the
    Student-t scale's stream goes on after the normals at word off + 2
    ceil(D / 2)."""
    rng = np.random.default_rng(K + D + off)
    _, tp = mixture(rng, K, D, True)
    ops = core._kernel_operands(tp)
    key = (0x9E3779B9, 0x7F4A7C15 + off)
    lat = rng.integers(0, K, N).astype(np.int32)
    scale = rng.uniform(0.5, 1.5, N)
    z, end = sequential_normals(key, np.arange(N), off, D)
    assert end == off + 2 * ((D + 1) // 2)
    x, draws = drawn_walk(key, off, lat, scale, tp.means.numpy(), tp.chol.numpy())
    assert np.isfinite(x).all()
    panels = -(-D // 16)
    if D <= 256:
        assert (draws == 1).all()
    else:
        assert (draws[128:] >= 1).all() and draws.max() == 2 and panels > 16
    ref = kernels.plain_transform(torch.tensor(z), torch.tensor(lat), torch.tensor(scale), ops)
    np.testing.assert_allclose(x, ref.numpy(), rtol=1e-12, atol=1e-12)
    # the panels themselves are the stream's normals, bit for bit
    cols = np.arange(min(N, 128))
    for p in range(panels):
        panel = drawn_panel(key, cols, p, off, D)
        rows = slice(16 * p, min(D, 16 * p + 16))
        assert np.array_equal(panel[:rows.stop - rows.start], z[rows, cols])


@pytest.fixture()
def interpret(monkeypatch):
    monkeypatch.setattr(pk, "INTERPRET", True)


def test_the_drawn_walk_matches_pallas_interpret_on_its_normals(interpret):
    """The drawn walk's product on float32 inputs against the JAX package's
    fused_transform on the same normals (its Pallas kernel in interpret
    mode, as tests/test_pallas_kernels.py runs it; the Pallas kernel
    contracts in split precision: that test's rtol 1e-4, atol 5e-4)."""
    rng = np.random.default_rng(5)
    K, D, N, off = 2, 130, 300, 1
    jp, tp = mixture(rng, K, D, False, dtype=np.float32)
    key = (12345, 678)
    lat = rng.integers(0, K, N).astype(np.int32)
    scale = np.ones(N, np.float32)
    z, _ = sequential_normals(key, np.arange(N), off, D)
    x, _ = drawn_walk(key, off, lat, scale, tp.means.numpy().astype(np.float64),
                      tp.chol.numpy().astype(np.float64))
    ref = pk.fused_transform(jnp.asarray(z.astype(np.float32)), jnp.asarray(lat),
                             jnp.asarray(scale), jp.chol.reshape(K * D, D), jp.means.T, dim=D)
    np.testing.assert_allclose(x, np.asarray(ref), rtol=1e-4, atol=5e-4)
