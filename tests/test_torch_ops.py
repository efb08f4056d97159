"""pypmc_tpu_torch.ops against pypmc_tpu.ops: the deterministic functions in
float64 against the JAX XLA path, the plain kernel versions in float32
against the JAX Pallas kernels in interpret mode, and the chi-square sampler
in distribution.  Inputs are made with numpy and handed to both packages."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import pypmc_tpu.density.core as jcore
import pypmc_tpu.mix_adapt.pmc as jpmc
import pypmc_tpu.ops.pallas_kernels as pk
from pypmc_tpu.ops import linalg as jlinalg
from pypmc_tpu.ops import lse as jlse
import pypmc_tpu_torch
from pypmc_tpu_torch.density import core
from pypmc_tpu_torch.mix_adapt import pmc
from pypmc_tpu_torch.ops import _build, kernels, linalg, lse, random

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless the CPU is asked for: ask for it."""
    with pypmc_tpu_torch.using_device("cpu"):
        yield

RTOL64, ATOL64 = 1e-10, 1e-12
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spd(rng, K, D):
    a = rng.normal(0, 0.4, (K, D, D))
    return np.eye(D)[None] + np.einsum("kij,klj->kil", a, a)


def mixture(rng, K, D, student_t, dead=False, dtype=np.float64):
    means = rng.normal(0, 2, (K, D))
    w = rng.uniform(0.5, 1.5, K)
    if dead:
        w[K // 2] = 0.0
    dofs = rng.uniform(4, 12, K) if student_t else None
    cast = lambda v: None if v is None else v.astype(dtype)
    jp, valid = jcore.make_mixture(cast(means), cast(spd(rng, K, D)), cast(w / w.sum()),
                                   cast(dofs))
    assert bool(np.asarray(valid).all())
    return jp, core.params_from_numpy(jp)


# ------------------------------------------------------------------ #
# float64 against the XLA path                                        #
# ------------------------------------------------------------------ #

def test_logsumexp_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(0, 30, (257, 5))
    a[3] = -np.inf
    a[7, 2] = -np.inf
    w = rng.dirichlet(np.ones(5))
    ref = np.asarray(jlse.logsumexp(jnp.asarray(a), jnp.asarray(w), axis=-1))
    got = lse.logsumexp(torch.tensor(a), torch.tensor(w), axis=-1).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL64, atol=ATOL64)
    got2 = lse.logsumexp2D(torch.tensor(a), torch.tensor(w)).numpy()
    np.testing.assert_array_equal(got, got2)
    assert np.isneginf(got[3])


def test_regularize_and_tiny():
    x = torch.tensor([0.0, 1.0, -2.0], dtype=torch.float64)
    out = lse.regularize(x)
    assert out[0] == lse.tiny(torch.float64) == jlse.tiny(jnp.float64)
    assert x[0] == 0.0   # input not mutated
    np.testing.assert_array_equal(out[1:].numpy(), [1.0, -2.0])


def test_chol_inv_det_matches_jax_and_masks_non_pd():
    rng = np.random.default_rng(1)
    m = spd(rng, 5, 6)
    m[1] = -m[1]                         # negative definite
    m[3, 0, 0] = np.nan                  # non-finite input
    ref = jlinalg.chol_inv_det(jnp.asarray(m))
    got = linalg.chol_inv_det(torch.tensor(m))
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(valid, [True, False, True, False, True])
    for f in ("chol", "inv_chol", "inv"):
        np.testing.assert_allclose(getattr(got, f).numpy()[valid],
                                   np.asarray(getattr(ref, f))[valid],
                                   rtol=RTOL64, atol=ATOL64)
    np.testing.assert_allclose(got.log_det.numpy()[valid], np.asarray(ref.log_det)[valid],
                               rtol=RTOL64, atol=ATOL64)
    assert np.isnan(got.chol.numpy()[~valid]).all()


def test_symmetrize_and_bilinear_sym():
    rng = np.random.default_rng(2)
    m = rng.normal(size=(3, 4, 4))
    v = rng.normal(size=(3, 4))
    np.testing.assert_allclose(linalg.symmetrize(torch.tensor(m)).numpy(),
                               np.asarray(jlinalg.symmetrize(jnp.asarray(m))),
                               rtol=RTOL64, atol=ATOL64)
    np.testing.assert_allclose(
        linalg.bilinear_sym(torch.tensor(m), torch.tensor(v)).numpy(),
        np.asarray(jlinalg.bilinear_sym(jnp.asarray(m), jnp.asarray(v))),
        rtol=RTOL64, atol=ATOL64)


@pytest.mark.parametrize("K,D", [(120, 1), (1, 200)])
def test_plain_versions_at_the_repaired_shapes_match_jax(K, D):
    """The shapes the CUDA kernels newly take -- the statistics kernels'
    64-particle tile (K=120, D=1) and the wide path (D=200: the block-tiled
    kernels of fused_logq, fused_maha and fused_rho) --
    through the plain versions of fused_logq, fused_rho, fused_maha and the
    PMC statistics (pmc_update's dense route where K*D <= 128), in float64,
    against the JAX package's XLA path on the same numpy inputs."""
    rng = np.random.default_rng(K + D)
    jp, tp = mixture(rng, K, D, True, dead=K > 1)
    ops = core._kernel_operands(tp)
    N = 3000
    xT = rng.normal(0, 2, (D, N))
    x = torch.tensor(xT)
    lq_ref = np.asarray(jcore.mixture_logpdf_T(jp, jnp.asarray(xT)))
    np.testing.assert_allclose(kernels.plain_logq(x, ops).numpy(), lq_ref,
                               rtol=RTOL64, atol=ATOL64)
    rho, lq = kernels.plain_rho(x, ops)
    np.testing.assert_allclose(rho.numpy(), np.asarray(jpmc.calculate_rho_rb_T(jp, jnp.asarray(xT))),
                               rtol=RTOL64, atol=ATOL64)
    np.testing.assert_allclose(lq.numpy(), lq_ref, rtol=RTOL64, atol=ATOL64)
    np.testing.assert_allclose(
        kernels.plain_maha(x, tp.inv_chol, tp.means).numpy(),
        np.asarray(jcore.mahalanobis_all_T(jp, jnp.asarray(xT))), rtol=RTOL64, atol=ATOL64)
    w = rng.exponential(1.0, N)
    ref = jpmc.pmc_update(jp, jnp.asarray(xT), jnp.asarray(w), rb=True, transposed=True,
                          fused="off")
    assert (K * D <= 128) == (kernels.route("fused_pmc_stats", K, D, N) == "dense")
    got = pmc.pmc_update(tp, x, torch.tensor(w), rb=True, transposed=True, fused="auto")
    for f, v in core.params_to_numpy(got.params).items():
        r = getattr(ref.params, f)
        if v is None:
            assert r is None
        else:
            np.testing.assert_allclose(v, np.asarray(r), rtol=RTOL64, atol=ATOL64, err_msg=f)


# ------------------------------------------------------------------ #
# chi-square sampler, in distribution                                  #
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("df", [0.7, 3.5, 40.0])
def test_chi2_log_ks_against_scipy(df):
    draws = random.chisquare(123, torch.tensor(df, dtype=torch.float64), (20000,)).numpy()
    assert np.isfinite(draws).all() and (draws > 0).all()
    _, p = stats.kstest(draws, "chi2", args=(df,))
    assert p > 1e-3, p


def test_chi2_log_seeded_and_tiny_dof():
    a = random.chi2_log(5, torch.tensor(1e-5), (1000,))
    b = random.chi2_log(5, torch.tensor(1e-5), (1000,))
    c = random.chi2_log(6, torch.tensor(1e-5), (1000,))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.isfinite(a).all()        # log space: no underflow to -inf
    scale = random.student_t_scale(7, torch.full((4000,), 8.0, dtype=torch.float64), (4000,))
    # E[dof / chi2(dof)] = dof / (dof - 2)
    np.testing.assert_allclose(float((scale ** 2).mean()), 8.0 / 6.0, rtol=0.05)


# ------------------------------------------------------------------ #
# the dispatch gate and the dense kernels' stated limits             #
# ------------------------------------------------------------------ #

def test_dispatch_gate():
    x = torch.zeros(3)
    assert kernels.use_kernel(x) is False
    assert kernels.use_kernel(x.double()) is False
    with pytest.raises(TypeError):
        kernels.use_kernel(torch.zeros(3, device="meta"))


def test_limits_are_stated_and_enforced():
    _build.check_limits("fused_is_pmc_step", 10, 10, 2)     # the flagship fits
    with pytest.raises(ValueError, match="limit"):
        _build.check_limits("fused_is_pmc_step", 64, 40, 2)
    # the thread kernels stop at D = 128; the six with a tiled path past it
    # at WIDE_D_MAX
    with pytest.raises(ValueError, match="D <= 128"):
        _build.check_limits("fused_pmc_stats", 1, 129)
    for kernel in _build.WIDE:
        _build.check_limits(kernel, 1, 129)
        _build.check_limits(kernel, 1, _build.WIDE_D_MAX)
        with pytest.raises(ValueError, match="D <= %d" % _build.WIDE_D_MAX):
            _build.check_limits(kernel, 1, _build.WIDE_D_MAX + 1)
    assert _build.smem_bytes("fused_is_pmc_step", 10, 10, 2) < _build.SMEM_LIMIT
    # operands past shared memory: the record kernels of fused_logq and
    # fused_rho stream their records through two chunk buffers up to D = 64;
    # past it their tiled kernels ask for their panels at every shape, and in
    # the other evaluation kernels the operands are read from device memory
    # and the kernel asks for none; the statistics kernels ask for their tile
    # and accumulators alone
    assert _build.smem_bytes("fused_logq", 60, 32) == 2 * 20 * 4 * _build._rec_floats(32)
    assert _build.smem_bytes("fused_logq", 4, 128) == _build.tiled_plan()[4] == 41_600
    assert _build.smem_bytes("fused_rho", 60, 32) == 2 * 20 * 4 * _build._rec_floats(32)
    assert _build.smem_bytes("fused_rho", 4, 128) == 41_600
    assert _build.smem_bytes("fused_transform", 60, 32) == 0
    _build.check_limits("fused_logq", 60, 32)
    assert 0 < _build.smem_bytes("fused_vb_estep", 1, 128) <= _build.SMEM_LIMIT
    assert (_build.smem_bytes("fused_vb_estep", 1, 128)
            < _build._stats_bytes(1, 128, _build._operand_floats("fused_vb_estep", 1, 128, 0)))


def test_eval_plan_streams_records_in_chunks():
    """fused_logq's and fused_maha's kernels up to D = 64 stream 16-byte
    component records (fused_maha's in the VB layout): the whole mixture in
    one buffer where it fits half an SM's shared memory, else two buffers of
    equal chunks; past D = 64 their tiled kernel takes a component at a time
    in two panel buffers (41,600 B at every K), and so does fused_rho's."""
    rec = _build._rec_floats
    vb = lambda D: _build._rec_floats(D, vb=True)
    assert (4 * rec(40), 4 * vb(40), 4 * rec(10)) == (3696, 6576, 352)
    pinned = {
        ("fused_maha", 32, 40): (8, 2, 2 * 8 * 4 * vb(40)),       # 2 x 52,608 B
        ("fused_logq", 32, 40): (11, 2, 2 * 11 * 4 * rec(40)),    # chunks 11, 11, 10
        ("fused_logq", 200, 10): (200, 1, 70_400),
        ("fused_maha", 200, 10): (200, 1, 200 * 4 * vb(10)),
        ("fused_logq", 2, 40): (2, 1, 2 * 4 * rec(40)),
        ("fused_maha", 2, 40): (2, 1, 2 * 4 * vb(40)),
        ("fused_logq", 60, 32): (20, 2, 2 * 20 * 4 * rec(32)),
        ("fused_maha", 60, 32): (12, 2, 2 * 12 * 4 * vb(32)),
        ("fused_logq", 1, 128): (1, 2, 41_600),
        ("fused_maha", 1, 128): (1, 2, 41_600),
        ("fused_rho", 1, 128): (1, 2, 41_600),
    }
    for (kernel, K, D), plan in pinned.items():
        assert _build.eval_plan(kernel, K, D) == plan, (kernel, K, D)
        assert plan[2] == _build.smem_bytes(kernel, K, D) <= _build.SMEM_LIMIT
        _build.check_limits(kernel, K, D)
    # two blocks of 256 threads (16 warps) share an SM's 228 KB at K=32,
    # D=40, three of the K=200, D=10 log-density's
    assert _build.EVAL_THREADS == 256
    assert [_build.eval_threads(D) for D in (10, 40, 64, 65, 128)] == [256] * 5
    for kernel in ("fused_logq", "fused_maha"):
        assert 2 * (_build.eval_plan(kernel, 32, 40)[2] + 1024) <= 228 * 1024
        assert 3 * (_build.eval_plan(kernel, 32, 40)[2] + 1024) > 228 * 1024
    assert 3 * (_build.eval_plan("fused_logq", 200, 10)[2] + 1024) <= 228 * 1024
    # a chunk's records fit half an SM however many components there are
    for kernel in ("fused_logq", "fused_maha"):
        for K, D in ((5000, 10), (1000, 64), (100, 33)):
            kc, buffers, smem = _build.eval_plan(kernel, K, D)
            assert buffers == 2 and kc < K and smem <= _build._HALF_SMEM
    assert _build.eval_plan("fused_rho", 4, 128) == (1, 2, 41_600)
    # fused_rho streams fused_logq's records to D = 64 and takes the tiled
    # kernel past it, as fused_logq does
    for K, D in ((32, 40), (200, 10), (2, 40), (60, 32), (10, 10), (1, 64)):
        assert _build.eval_plan("fused_rho", K, D) == _build.eval_plan("fused_logq", K, D)
    for K, D in ((1, 65), (1, 128), (2, 200)):
        assert _build.eval_plan("fused_rho", K, D) == _build.eval_plan("fused_logq", K, D)
        assert _build.eval_plan("fused_logq", K, D) == (1, 2, _build.tiled_plan()[4])
    assert _build.eval_plan("fused_rho", 32, 40) == (11, 2, 2 * 11 * 3696)
    assert _build.eval_plan("fused_rho", 10, 10) == (10, 1, 10 * 352)
    # past D = 128 the tiled kernel's panels, 256 threads, 128 particles a
    # block
    assert _build.eval_plan("fused_rho", 2, 200) == (1, 2, 41_600)
    assert _build.eval_threads(200) == 256
    assert [_build.block_particles("fused_rho", D) for D in (10, 100, 200)] == [256, 128, 128]
    # the tiled kernels: 256 threads, 128 particles
    for kernel in _build.TILED:
        assert [_build.block_particles(kernel, D) for D in (10, 100, 200)] == [256, 128, 128]
        assert _build.block_particles(kernel, 40, "tiled") == 128
    assert _build.eval_threads(200, "tiled") == 256
    # fused_transform's record kernel takes 256 threads to D = 64, its tiled
    # pair (as its looped kernel) 128 particles a block past it
    assert [_build.block_particles("fused_transform", D)
            for D in (10, 64, 65, 128, 129)] == [256, 256, 128, 128, 128]
    assert _build.block_particles("fused_transform", 100, "looped") == _build.THREADS == 128
    assert _build.block_particles("fused_pmc_stats", 100) == 128


# a grid of (K, D) over the JAX rule's reach, with the shapes where the dense
# statistics tile of 128 particles does not fit (D = 1, K = 109-128) and the
# dimensions past the thread kernels' 128
GRID_K = (1, 2, 4, 16, 32, 64, 109, 110, 120, 127, 128, 200, 400)
GRID_D = tuple(range(1, 2101))


@pytest.mark.parametrize("kernel", _build.KERNELS)
def test_every_shape_the_rule_admits_is_within_the_kernels_limits(kernel):
    """Where fits() sends a shape to a kernel (the JAX package's rule), the
    CUDA kernel takes it: _build.limit_reason names no limit, so the wrapper
    launches on the card where the JAX package returns a result.  The two
    kernels with a register pass take it at every admitted shape to D = 16
    (K = 128 at D = 1 the largest) and the entry table past it."""
    rules = ([{"n_steps": 400, "student_t": t} for t in (False, True)]
             if kernel == "fused_mcmc_pool" else [{}])
    refused, passes = [], {}
    for rule in rules:
        for Kt in (0, 2):
            for K in GRID_K:
                for D in GRID_D:
                    if not kernels.fits(kernel, K, D, Kt, **rule):
                        if D > 64:
                            break    # the rule only tightens with D at a fixed K
                        continue
                    if _build.limit_reason(kernel, K, D, Kt) is not None:
                        refused.append((K, D, Kt))
                    if kernel in _build._DENSE:
                        passes.setdefault(_build.dense_plan(kernel, K, D, Kt)[0], set()).add(D)
    assert refused == []
    if kernel in _build._DENSE:
        assert passes["reg"] == set(range(1, 17)) and min(passes["table"]) == 17


@pytest.mark.parametrize("kernel", _build.TILED)
def test_every_shape_the_rule_admits_past_d64_takes_the_tiled_plan(kernel):
    """Where the JAX rule sends fused_logq, fused_maha, fused_rho or
    fused_transform a shape with D = 65-2,040, the mirror of the tiled plan
    (csrc/tiled.cuh) holds it: the elected kernel is the tiled one from
    TILED_D_MIN (fused_transform's tiled pair from TRANSFORM_TILED_D_MIN, its
    looped kernel below), its shared memory and threads are within a block's
    limits (41,600 B, 256 threads, the same at every K; fused_transform's
    bucket kernel's counts too), and check_limits passes."""
    P, BM, BK, threads, smem = _build.tiled_plan()
    assert (P, BM, BK, threads) == (128, 128, 16, 256)
    assert smem == 4 * (2 * BK * (BM + 4) + 2 * BK * P + 2 * BK + 16 * P) == 41_600
    assert _build.TILED_D_MIN == 65
    draw = kernel == "fused_transform"
    first = _build.TRANSFORM_TILED_D_MIN if draw else _build.TILED_D_MIN
    assert 65 <= first <= 129
    elect = ((lambda K, D: _build.transform_plan(K, D)[0]) if draw
             else (lambda K, D: _build.eval_variant(kernel, D)))
    assert [elect(1, D) for D in (1, 64, first, 2040)] == ["rec"] * 2 + ["tiled"] * 2
    admitted = 0
    for K in sorted(set(GRID_K) | {3, 19, 30, 41, 60}):
        for D in range(65, 2041):
            if not kernels.fits(kernel, K, D):
                break    # the rule only tightens with D at a fixed K
            admitted += 1
            assert elect(K, D) == ("tiled" if D >= first else "looped")
            if draw:
                if D >= first:
                    assert _build.transform_plan(K, D) == ("tiled", False, 0, threads, smem)
                    assert _build.transform_bucket_plan(K)[3] <= _build.SMEM_LIMIT
            else:
                assert _build.eval_plan(kernel, K, D) == (1, 2, smem)
                assert _build.eval_threads(D, "tiled") == threads <= 1024
            assert _build.block_particles(kernel, D) == P
            if D >= first:
                assert smem == _build.smem_bytes(kernel, K, D) <= _build.SMEM_LIMIT
            _build.check_limits(kernel, K, D)
    # the rule's largest K at D = 65, 96, 128, 200 and its reach at K = 1
    largest = {D: max(K for K in range(1, 200) if kernels.fits(kernel, K, D))
               for D in (65, 96, 128, 200, 1000)}
    assert largest == {65: 60, 96: 41, 128: 30, 200: 19, 1000: 3}
    assert admitted > 2000


def test_reach_of_the_rule_and_the_limits():
    """The JAX rule's reach at K=1, which D_MAX covers: D = 2,040 for the
    128-particle tile, 248 for the 1024-particle one, 125 for a proposal with
    a 2-component target."""
    reach = lambda kernel, Kt=0, **rule: max(
        D for D in range(1, 2200) if kernels.fits(kernel, 1, D, Kt, **rule))
    for kernel in ("fused_logq", "fused_rho", "fused_maha", "fused_transform"):
        assert reach(kernel) == 2040 <= _build.D_MAX[kernel]
    assert reach("fused_transform_rng") == 248 <= _build.D_MAX["fused_transform_rng"]
    assert reach("fused_propose_logq") == 248 and reach("fused_propose_logq", 2) == 125
    assert all(_build.D_MAX[k] == 128 for k in _build.KERNELS if k not in _build.WIDE)


def test_statistics_tile_and_pool_variant_mirrors():
    """_build's mirrors of csrc/stats.cuh stats_layout and csrc/mcmc_pool.cu
    pool_variant / pmc_mcmc_pool_smem_bytes, against hand-worked values."""
    # D = 1: 4K + 3 rows of 129 floats (8-byte aligned) and K * 5 + 3
    # entries of 14 bytes
    assert _build._stats_bytes(108, 1, 0) == 224_464 + 543 * 14 == 232_066 <= _build.SMEM_LIMIT
    assert _build._stats_bytes(109, 1, 0) == 226_528 + 548 * 14 == 234_200 > _build.SMEM_LIMIT
    assert [_build.stats_tile(K, 1) for K in (108, 109, 128)] == [128, 64, 64]
    assert _build.stats_tile(10, 10) == 128 and _build.stats_tile(64, 2) == 128
    # the 64-particle kernels are built to D=8, where the JAX rule sends
    # D=1 only: past it the limit names the tile
    assert _build.stats_tile(60, 4) == 64 and _build.limit_reason("fused_pmc_stats", 60, 4) is None
    assert _build.stats_tile(40, 9) == 64
    assert "D <= 8" in _build.limit_reason("fused_vb_estep", 40, 9)
    # the 64-particle tile at K=128, D=1: rows 65 floats apart, the 1,280
    # operand floats of fused_pmc_stats staged in front (~146 KB)
    ops = 128 * 1 + 128 * 1 + 4 * 128
    assert _build._operand_floats("fused_pmc_stats", 128, 1, 0) == ops
    table = _build._table_bytes("fused_pmc_stats", 128, 1)
    assert table == (4 * (ops + 515 * 65) + 7) // 8 * 8 + 643 * 14 == 145_978
    # (the shape's elected pass is the register pass: test_dense_register_plan_mirrors)
    for kernel in ("fused_pmc_stats", "fused_is_pmc_step", "fused_vb_estep"):
        assert _build.limit_reason(kernel, 128, 1, 2) is None
        assert _build.smem_bytes(kernel, 128, 1, 2) <= _build.SMEM_LIMIT
    # the pool: a warp a chain for the pipeline's 32 chains at D=40, a
    # thread a chain for benchmarks/mcmc_chains.py's 16384 at D=10; the
    # warp variant's largest pool grows with D's thread instantiation
    assert _build.pool_variant(32, 40) == "warp" and _build.pool_variant(16384, 10) == "thread"
    assert _build.pool_variant(1, 8) == "thread" == _build.pool_variant(32, 2)
    assert _build.pool_variant(4096, 9) == "warp" == _build.pool_variant(4096, 16)
    assert _build.pool_variant(4097, 16) == "thread"
    assert _build.pool_variant(8192, 17) == "warp" == _build.pool_variant(8192, 32)
    assert _build.pool_variant(8193, 32) == "thread"
    assert _build.pool_variant(32768, 40) == "warp" and _build.pool_variant(32769, 40) == "thread"
    assert _build.pool_variant(1 << 20, 41) == "warp" == _build.pool_variant(1 << 20, 64)
    assert _build.pool_variant(32, 65) == "thread" == _build.pool_variant(16384, 65)
    # the warp variant stages the target's records (at D=40, 3,696 B each)
    # beside three slices of D + 8 floats
    assert _build.pool_smem_bytes(2, 40, "warp") == 2 * 3696 + 4 * 3 * 48 == 7968
    assert _build.pool_smem_bytes(60, 64, "warp") == 4 * 3 * 72      # records past the limit
    # the thread variant's record instantiation: the records, and past DMAX
    # 32 two columns of DMAX floats a thread (the state, the proposal)
    assert _build.pool_smem_bytes(1, 10, "thread") == 4 * 88 == 352
    assert _build.pool_smem_bytes(2, 40, "thread") == 2 * 3696 + 4 * 2 * 40 * 128 == 48_352
    assert _build.pool_smem_bytes(2, 33, "thread") == 4 * 2 * _build._rec_floats(33) + 40_960
    # past D = 64, or records past shared memory: the looped kernel's packed
    # operands, staged where they fit
    assert _build.pool_smem_bytes(2, 65, "thread") == 4 * (2 * 65 + 2 * 65 * 65 + 8)
    assert _build.pool_smem_bytes(30, 64, "thread") == 0
    assert _build.smem_bytes("fused_mcmc_pool", 2, 40, 0) == _build.pool_smem_bytes(2, 40, "thread")


# (K, D, Kt) -> the plan of fused_vb_estep, fused_is_pmc_step and
# fused_pmc_stats, worked
# by hand from csrc/reg_stats.cuh: S slices (one band, D <= 10: 128 // K,
# at least 8; three: 8, 16 or 32), groups = ceil(K / (128 // S)) with one
# band or ceil(K / (32 / S)) with three; a component's r = (D + 3) | 1 rows
# (diff, w rho, c, t1) at a stride of 64 + (S r^-1 mod 32); records (VB: pad4(D) + 4 + D pad4(D)
# floats; the step: pad4(D) + 4 + tri_row(D), the 2-component target's and
# K thresholds besides; fused_pmc_stats: the step's K records alone), the
# staging of (D + 1) x 128 floats, the tile and (one group:
# within the tile; more: beside it) the scratch of 8 K P + 192 floats, then
# K P + 3 float64 accumulators, P = 3 + D + D (D + 1) / 2
def _vb_reg(recs, D, tile, scratch, groups, E):
    floats = recs + (D + 1) * 128 + (max(tile, scratch) if groups == 1 else tile + scratch)
    return (4 * floats + 7) // 8 * 8 + 8 * (E + 3)


DENSE_PLANS = {
    # K=10, D=10: one band, 128 // 10 = 12 slices, one group; rows 13 at
    # stride 92 (13 x 5 = 1 mod 32, 12 x 5 = 28 mod 32); VB records 136
    # floats, the step's 88
    (10, 10): (("reg", 64, 12, 1, _vb_reg(10 * 136, 10, 10 * 13 * 92, 12 * 680 + 192, 1, 680)),
               ("reg", 64, 12, 1, _vb_reg(12 * 88 + 10, 10, 10 * 13 * 92, 12 * 680 + 192, 1,
                                          680)),
               ("reg", 64, 12, 1, _vb_reg(10 * 88, 10, 10 * 13 * 92, 12 * 680 + 192, 1, 680))),
    # the last K of one group at D=10, and the first of two
    (16, 10): (("reg", 64, 8, 1, _vb_reg(16 * 136, 10, 16 * 936, 8 * 1088 + 192, 1, 1088)),
               ("reg", 64, 8, 1, _vb_reg(18 * 88 + 16, 10, 16 * 936, 8 * 1088 + 192, 1, 1088)),
               ("reg", 64, 8, 1, _vb_reg(16 * 88, 10, 16 * 936, 8 * 1088 + 192, 1, 1088))),
    (17, 10): (("reg", 64, 8, 2, _vb_reg(17 * 136, 10, 17 * 936, 8 * 1156 + 192, 2, 1156)),
               ("reg", 64, 8, 2, _vb_reg(19 * 88 + 17, 10, 17 * 936, 8 * 1156 + 192, 2, 1156)),
               ("reg", 64, 8, 2, _vb_reg(17 * 88, 10, 17 * 936, 8 * 1156 + 192, 2, 1156))),
    # D=11: three bands of 4 components at 8 slices; rows 15 at stride 88
    # (15 x 15 = 1 mod 32, 8 x 15 = 24 mod 32); P = 80; records 12 + 4 + 84
    (11, 11): (("reg", 64, 8, 3, _vb_reg(11 * 148, 11, 11 * 15 * 88, 8 * 880 + 192, 3, 880)),
               ("reg", 64, 8, 3, _vb_reg(13 * 100 + 11, 11, 11 * 15 * 88, 8 * 880 + 192, 3,
                                         880)),
               ("reg", 64, 8, 3, _vb_reg(11 * 100, 11, 11 * 15 * 88, 8 * 880 + 192, 3, 880))),
    # D=16: rows 19 at stride 88 (19 x 27 = 1, 8 x 27 = 24 mod 32), P = 155,
    # records 16 + 4 + 16 x 16 = 276 floats (the step's 16 + 4 + 160); one
    # component takes 32 slices (stride 64), two 16 (16 x 27 = 16 mod 32)
    (8, 16): (("reg", 64, 8, 2, _vb_reg(8 * 276, 16, 8 * 19 * 88, 8 * 1240 + 192, 2, 1240)),
              ("reg", 64, 8, 2, _vb_reg(10 * 180 + 8, 16, 8 * 19 * 88, 8 * 1240 + 192, 2,
                                        1240)),
              ("reg", 64, 8, 2, _vb_reg(8 * 180, 16, 8 * 19 * 88, 8 * 1240 + 192, 2, 1240))),
    (1, 16): (("reg", 64, 32, 1, _vb_reg(276, 16, 19 * 64, 32 * 155 + 192, 1, 155)),
              ("reg", 64, 32, 1, _vb_reg(3 * 180 + 1, 16, 19 * 64, 32 * 155 + 192, 1, 155)),
              ("reg", 64, 32, 1, _vb_reg(180, 16, 19 * 64, 32 * 155 + 192, 1, 155))),
    (2, 16): (("reg", 64, 16, 1, _vb_reg(2 * 276, 16, 2 * 19 * 72, 16 * 310 + 192, 1, 310)),
              ("reg", 64, 16, 1, _vb_reg(4 * 180 + 2, 16, 2 * 19 * 72, 16 * 310 + 192, 1,
                                         310)),
              ("reg", 64, 16, 1, _vb_reg(2 * 180, 16, 2 * 19 * 72, 16 * 310 + 192, 1, 310))),
    # K=128 at D=1 (the JAX rule's reach): eight groups; rows 5 at stride 72
    (128, 1): (("reg", 64, 8, 8, _vb_reg(128 * 12, 1, 128 * 5 * 72, 8 * 640 + 192, 8, 640)),
               ("reg", 64, 8, 8, _vb_reg(130 * 12 + 128, 1, 128 * 5 * 72, 8 * 640 + 192, 8,
                                         640)),
               ("reg", 64, 8, 8, _vb_reg(128 * 12, 1, 128 * 5 * 72, 8 * 640 + 192, 8, 640))),
    # the first (K, D <= 16) past shared memory: K=137 at D=1 (K=136 fits),
    # the entry table's 64-particle tile (at D=1 a record is 12 floats in
    # every layout, so fused_pmc_stats' plan is VB's)
    (137, 1): (("table", 64, 0, 0, None),) * 3,
    (136, 1): (("reg", 64, 8, 9, None),) * 3,
    # D=17: the entry table
    (4, 17): (("table", 128, 0, 0, None),) * 3,
}


@pytest.mark.parametrize("K,D", sorted(DENSE_PLANS))
def test_dense_register_plan_mirrors(K, D):
    """_build.dense_plan, the mirror of csrc/reg_stats.cuh dense_plan,
    against hand-worked plans; the shared memory the wrappers' limits read
    is the plan's."""
    for kernel, want in zip(("fused_vb_estep", "fused_is_pmc_step", "fused_pmc_stats"),
                            DENSE_PLANS[(K, D)]):
        got = _build.dense_plan(kernel, K, D, 2)
        assert got[:4] == want[:4], (kernel, got)
        if want[4] is not None:
            assert got[4] == want[4], (kernel, got)
        assert _build.smem_bytes(kernel, K, D, 2) == got[4]
        assert (_build.limit_reason(kernel, K, D, 2) is None) == (got[4] <= _build.SMEM_LIMIT)
        if got[0] == "reg":
            assert got[4] <= _build.SMEM_LIMIT
        else:
            assert got[4] == _build._table_bytes(kernel, K, D, 2)
    assert _build.dense_plan("fused_vb_estep", 137, 1)[0] == "table"
    assert _build._dense_reg_bytes("fused_vb_estep", 137, 0, 1, 8, 9) > _build.SMEM_LIMIT
    assert _build._dense_reg_bytes("fused_is_pmc_step", 136, 2, 1, 8, 9) <= _build.SMEM_LIMIT
    assert _build._dense_reg_bytes("fused_pmc_stats", 137, 0, 1, 8, 9) > _build.SMEM_LIMIT
    assert _build._dense_reg_bytes("fused_pmc_stats", 136, 0, 1, 8, 9) <= _build.SMEM_LIMIT


# (K, D) -> fused_transform's plan, worked by hand from csrc/transform.cu
# transform_plan: to D = 64 the record kernel, 256 threads, a record of
# (D + D (D + 1) / 2) | 1 floats, the K records staged where they fit half
# an SM (228 KB / 2 - 1 KB = 115,712 B), else none; from D = 65
# (TRANSFORM_TILED_D_MIN) the tiled pair, whose product kernel has the tiled
# engine's 256 threads and 41,600 B (the looped kernel's plan, forced to D =
# 128: 128 threads, mu | L | dof staged where they fit 232,448 B)
TRANSFORM_PLANS = {
    (32, 40): ("rec", True, 861, 256, 32 * 861 * 4),       # 110,208 B: two blocks an SM
    (33, 40): ("rec", True, 861, 256, 113_652),
    (34, 40): ("rec", False, 861, 256, 0),                 # 117,096 B past half an SM
    (10, 10): ("rec", True, 65, 256, 2600),
    (13, 64): ("rec", True, 2145, 256, 13 * 2145 * 4),
    (14, 64): ("rec", False, 2145, 256, 0),
    (2, 65): ("tiled", False, 0, 256, 41_600),
    (1, 128): ("tiled", False, 0, 256, 41_600),
    (4, 128): ("tiled", False, 0, 256, 41_600),
    (1, 129): ("tiled", False, 0, 256, 41_600),
}
# the looped kernel's plan where it is forced (variant="looped"), D = 65-128
LOOPED_PLANS = {(2, 65): ("looped", True, 0, 128, 4 * (2 * 65 * 66 + 2)),
                (1, 128): ("looped", True, 0, 128, 4 * (128 * 129 + 1)),
                (4, 128): ("looped", False, 0, 128, 0)}


@pytest.mark.parametrize("K,D", sorted(TRANSFORM_PLANS))
def test_transform_plan_mirrors(K, D):
    """_build.transform_plan, the mirror of csrc/transform.cu
    transform_plan, against hand-worked plans: the kernel, the records
    staged, their odd stride (the K components' words at one offset in K
    distinct banks, where the looped kernel's D * D stride puts them in one
    at D = 40), the threads and the shared memory, which smem_bytes and
    limit_reason read."""
    got = _build.transform_plan(K, D)
    assert got == TRANSFORM_PLANS[(K, D)]
    assert _build.smem_bytes("fused_transform", K, D) == got[4] <= _build._HALF_SMEM
    assert _build.limit_reason("fused_transform", K, D) is None
    particles = {"rec": got[3], "tiled": 128}[got[0]]
    assert _build.block_particles("fused_transform", D) == particles
    if (K, D) in LOOPED_PLANS:
        # the looped kernel's operands, as the draws' looped plans stage them
        assert _build._record_plan(D, 0, _build._operand_floats("fused_transform", K, D, 0)) \
            == LOOPED_PLANS[(K, D)]
        assert _build.block_particles("fused_transform", D, "looped") == 128
    if got[0] == "rec":
        F = got[2]
        assert F % 2 == 1 and F >= D + D * (D + 1) // 2
        banks = {k * F % 32 for k in range(min(K, 32))}
        assert len(banks) == min(K, 32)
        if D == 40:
            assert {k * D * D % 32 for k in range(K)} == {0}
    # fused_transform_rng's plan: the same kernels, its staged records
    # followed by the K dofs; from D = 65 (DRAW_TILED_D_MIN) its drawn
    # product, the tiled engine's 41,600 B and past D = 128 row tile 0's
    # eight 16 x 128 panels beside them (107,136 B: two blocks an SM)
    rng = _build.transform_plan(K, D, rng=True)
    want = (got[:4] + (got[4] + 4 * K,) if got[0] == "rec" and got[1] else got)
    if got[0] == "tiled":
        want = ("tiled", False, 0, 256, 41_600 + (65_536 if D > 128 else 0))
    assert rng == want
    if rng[0] == "tiled":
        assert _build.draw_tiled_smem(D) == rng[4]
    assert 2 * (_build.draw_tiled_smem(D) + 1024) <= 228 * 1024
    assert _build.smem_bytes("fused_transform_rng", K, D) == rng[4]
    assert _build.block_particles("fused_transform_rng", D) == {"rec": 256, "tiled": 128}[rng[0]]


# (kernel, K, Kt, D) -> the plan of fused_transform_rng and
# fused_propose_logq, worked by hand from csrc/transform.cu transform_plan
# and csrc/propose_logq.cu propose_plan (common.cuh draw_plan): to D = 64
# the record kernel, 256 threads, staged where its records fit half an SM
# (115,712 B): fused_transform_rng's K draw records of (D + D (D + 1) / 2) | 1
# floats and K dofs; fused_propose_logq's K + Kt evaluation records
# (rec_floats: 88 floats at D = 10, 924 at D = 40, 2,116 at D = 62), K draw
# records and K thresholds; to D = 128 the looped kernel's operands where
# they fit 232,448 B (fused_propose_logq: the packed proposal and the
# target's evaluation part), which stays forcible; from D = 65
# (DRAW_TILED_D_MIN) the drawn tiled products, the tiled engine's 256 threads
# and 41,600 B, past D = 128 with row tile 0's panels beside (107,136 B)
DRAW_PLANS = {
    ("fused_transform_rng", 10, 0, 10): ("rec", True, 65, 256, 4 * 10 * 66),     # 2,640 B
    ("fused_transform_rng", 11, 0, 40): ("rec", True, 861, 256, 4 * 11 * 862),   # the route
    ("fused_transform_rng", 33, 0, 40): ("rec", True, 861, 256, 113_784),
    ("fused_transform_rng", 34, 0, 40): ("rec", False, 861, 256, 0),
    ("fused_transform_rng", 13, 0, 64): ("rec", True, 2145, 256, 111_592),
    ("fused_transform_rng", 14, 0, 64): ("rec", False, 2145, 256, 0),
    ("fused_transform_rng", 2, 0, 65): ("tiled", False, 0, 256, 41_600),
    ("fused_transform_rng", 1, 0, 129): ("tiled", False, 0, 256, 107_136),
    # the flagship: 12 x 88 + 10 x 66 floats
    ("fused_propose_logq", 10, 2, 10): ("rec", True, 65, 256, 6864),
    ("fused_propose_logq", 10, 0, 10): ("rec", True, 65, 256, 4 * (10 * 88 + 10 * 66)),
    # the widest K the rule admits at D = 40 with a 2-component target
    ("fused_propose_logq", 9, 2, 40): ("rec", True, 861, 256, 4 * (11 * 924 + 9 * 862)),
    # the largest records the rule admits (K + Kt = 7 at D = 62): 16 B spare
    ("fused_propose_logq", 7, 0, 62): ("rec", True, 2015, 256, 115_696),
    ("fused_propose_logq", 5, 2, 62): ("rec", True, 2015, 256, 4 * (7 * 2116 + 5 * 2016)),
    ("fused_propose_logq", 8, 0, 62): ("rec", False, 2015, 256, 0),
    ("fused_propose_logq", 40, 2, 40): ("rec", False, 861, 256, 0),
    ("fused_propose_logq", 2, 2, 65): ("tiled", False, 0, 256, 41_600),
    ("fused_propose_logq", 3, 1, 128): ("tiled", False, 0, 256, 41_600),
    ("fused_propose_logq", 1, 1, 129): ("tiled", False, 0, 256, 107_136),
}
# the looped kernels' plans where they are forced (variant="looped"), D =
# 65-128: the operands staged where they fit 232,448 B
DRAW_LOOPED_PLANS = {
    ("fused_transform_rng", 2, 0, 65): ("looped", True, 0, 128, 4 * (2 * 65 * 66 + 2)),
    ("fused_propose_logq", 2, 2, 65): ("looped", True, 0, 128, 4 * (17_040 + 8_588)),
    ("fused_propose_logq", 3, 1, 128): ("looped", False, 0, 128, 0),
}


@pytest.mark.parametrize("kernel,K,Kt,D", sorted(DRAW_PLANS))
def test_draw_plans_mirror(kernel, K, Kt, D):
    """_build.transform_plan(rng=True) and _build.propose_plan, the mirrors
    of the C plans of fused_transform_rng and fused_propose_logq, against
    hand-worked plans: the kernel, the records staged, the draw records' odd
    stride (the components' words at one offset in distinct banks), the
    threads and the shared memory, which smem_bytes and limit_reason read."""
    got = _build.draw_plan(kernel, K, D, Kt)
    assert got == DRAW_PLANS[(kernel, K, Kt, D)]
    assert _build.smem_bytes(kernel, K, D, Kt) == got[4] <= (
        _build._HALF_SMEM if got[0] == "rec" else _build.SMEM_LIMIT)
    assert _build.limit_reason(kernel, K, D, Kt) is None
    assert _build.block_particles(kernel, D) == {"rec": 256, "tiled": 128}[got[0]]
    if got[0] == "tiled":
        assert got[4] == _build.draw_tiled_smem(D)
    if (kernel, K, Kt, D) in DRAW_LOOPED_PLANS:
        assert _build._record_plan(D, 0, _build._operand_floats(kernel, K, D, Kt)) \
            == DRAW_LOOPED_PLANS[(kernel, K, Kt, D)]
    if got[0] == "rec":
        F = got[2]
        assert F % 2 == 1 and F == _build._transform_rec_floats(D)
        assert len({k * F % 32 for k in range(min(K, 32))}) == min(K, 32)


def test_every_shape_the_propose_rule_admits_takes_the_staged_record_kernel():
    """Up to D = 64, at every (K, Kt) the JAX rule admits for
    fused_propose_logq (it reads K + Kt alone), whatever the split, the plan
    is the record kernel with its records staged; so is fused_transform_rng's
    at every K it admits.  The largest need is K = 7, Kt = 0, D = 62."""
    most = (0, None)
    for D in range(1, 65):
        S = 1
        while kernels.fits("fused_propose_logq", S + 1, D):
            S += 1
        assert kernels.fits("fused_transform_rng", S, D)
        assert not kernels.fits("fused_transform_rng", S + 1, D)
        for K in range(1, S + 1):
            for Kt in range(0, S - K + 1):
                plan = _build.propose_plan(K, Kt, D)
                assert plan[:2] == ("rec", True), (K, Kt, D, plan)
                most = max(most, (plan[4], (K, Kt, D)))
            assert _build.transform_plan(K, D, rng=True)[:2] == ("rec", True), (K, D)
    assert most == (115_696, (7, 0, 62))


def _variant_call(kernel, K, D, variant):
    """Call ``kernel``'s wrapper on CPU tensors of a (K, D) mixture with
    ``variant``."""
    rng = np.random.default_rng(K + D)
    jp, tp = mixture(rng, K, D, True, dtype=np.float32)
    ops = core._kernel_operands(tp)
    N = 33
    xT = torch.tensor(rng.normal(0, 1, (D, N)), dtype=torch.float32)
    w = torch.ones(N)
    latent = torch.tensor(rng.integers(0, K, N), dtype=torch.int32)
    if kernel == "fused_transform":
        return kernels.fused_transform(xT, latent, w, ops, variant=variant)
    if kernel == "fused_transform_rng":
        return kernels.fused_transform_rng((1, 2), latent, ops, variant=variant)
    if kernel == "fused_propose_logq":
        return kernels.fused_propose_logq((1, 2), ops, N, ops, variant=variant)
    if kernel == "fused_pmc_stats":
        return kernels.fused_pmc_stats(xT, w, ops, True, variant=variant)
    if kernel == "fused_is_pmc_step":
        return kernels.fused_is_pmc_step((1, 2), ops, ops, N, True, variant=variant)
    if kernel == "fused_logq":
        return kernels.fused_logq(xT, ops, variant=variant)
    if kernel == "fused_maha":
        return kernels.fused_maha(xT, tp.inv_chol, tp.means, variant=variant)
    A = torch.linalg.cholesky(torch.eye(D).expand(K, D, D)).transpose(1, 2).contiguous()
    return kernels.fused_vb_estep(xT, w, A, torch.zeros(K, D), torch.zeros(K), variant=variant)


@pytest.mark.parametrize("kernel,K,D,variant,ok", [
    # fused_transform: the record kernel to D = 64, the looped kernel beside
    # it to D = 128, the tiled pair beside them and alone past D = 128
    ("fused_transform", 3, 10, "rec", True), ("fused_transform", 3, 10, "looped", True),
    ("fused_transform", 3, 10, "warp", False), ("fused_transform", 1, 65, "rec", False),
    ("fused_transform", 1, 65, "looped", True), ("fused_transform", 1, 129, "looped", False),
    ("fused_transform", 1, 129, "warp", False), ("fused_transform", 3, 10, "reg", False),
    ("fused_transform", 1, 65, "tiled", True), ("fused_transform", 1, 129, "tiled", True),
    ("fused_transform", 3, 10, "tiled", True),
    # the two random draws: the same kernels
    ("fused_transform_rng", 3, 10, "rec", True), ("fused_transform_rng", 3, 10, "looped", True),
    ("fused_transform_rng", 3, 10, "warp", False), ("fused_transform_rng", 1, 65, "rec", False),
    ("fused_transform_rng", 1, 65, "looped", True),
    ("fused_transform_rng", 1, 129, "looped", False),
    ("fused_transform_rng", 1, 129, "tiled", True), ("fused_transform_rng", 3, 10, "tiled", True),
    ("fused_propose_logq", 3, 10, "rec", True), ("fused_propose_logq", 3, 10, "looped", True),
    ("fused_propose_logq", 3, 10, "table", False), ("fused_propose_logq", 1, 65, "rec", False),
    ("fused_propose_logq", 1, 65, "looped", True), ("fused_propose_logq", 1, 129, "rec", False),
    ("fused_propose_logq", 1, 129, "warp", False), ("fused_propose_logq", 1, 129, "tiled", True),
    ("fused_propose_logq", 1, 65, "tiled", True), ("fused_propose_logq", 1, 129, "looped", False),
    # the statistics kernels: the register pass to D = 16 and the entry table
    # beside it; the entry table alone past it
    ("fused_pmc_stats", 3, 4, "reg", True), ("fused_pmc_stats", 3, 4, "table", True),
    ("fused_pmc_stats", 2, 17, "reg", False), ("fused_pmc_stats", 2, 17, "table", True),
    ("fused_pmc_stats", 3, 4, "looped", False), ("fused_vb_estep", 2, 17, "reg", False),
    ("fused_vb_estep", 3, 4, "table", True), ("fused_is_pmc_step", 2, 17, "reg", False),
    ("fused_is_pmc_step", 3, 4, "rec", False),
    # fused_logq and fused_maha: the record kernel to D = 64, the tiled
    # kernel beside it and alone past it (they have no looped kernel)
    ("fused_logq", 3, 10, "rec", True), ("fused_logq", 3, 10, "tiled", True),
    ("fused_logq", 3, 10, "looped", False), ("fused_logq", 1, 65, "rec", False),
    ("fused_logq", 1, 65, "tiled", True), ("fused_logq", 1, 65, "looped", False),
    ("fused_maha", 1, 100, "looped", False), ("fused_logq", 1, 129, "looped", False),
    ("fused_logq", 1, 129, "tiled", True), ("fused_logq", 1, 129, "warp", False),
    ("fused_maha", 3, 10, "rec", True), ("fused_maha", 3, 10, "tiled", True),
    ("fused_maha", 1, 65, "rec", False), ("fused_maha", 1, 129, "tiled", True),
    ("fused_maha", 1, 129, "warp", False), ("fused_maha", 3, 4, "reg", False),
])
def test_variant_raises_where_the_plan_has_no_such_pass(kernel, K, D, variant, ok):
    """A wrapper's variant= names the plan's pass or its yardstick; any
    other raises ValueError naming the plan, on the CPU as on the card (the
    CPU runs the plain version whatever the variant)."""
    if ok:
        _variant_call(kernel, K, D, variant)
    else:
        with pytest.raises(ValueError, match="the plan"):
            _variant_call(kernel, K, D, variant)


def test_launch_counts_name_the_variants():
    """launch_counts() names each variant of the kernels that have several:
    the three draws' record, looped and tiled kernels (fused_transform's
    tiled pair, the others' drawn products; no warp kernel), the statistics
    kernels' register and entry-table passes, fused_logq's, fused_maha's and
    fused_rho's record and tiled kernels (fused_pmc_stats' tile width is no
    longer a variant)."""
    kernels.reset_launch_counts()
    names = {n for n in kernels.launch_counts() if n.startswith("variant:")}
    for kernel in ("fused_transform", "fused_transform_rng", "fused_propose_logq"):
        assert {"variant:%s=%s" % (kernel, v) for v in ("rec", "looped", "tiled")} <= names
        assert "variant:%s=warp" % kernel not in names
    for kernel in ("fused_pmc_stats", "fused_vb_estep", "fused_is_pmc_step"):
        assert {"variant:%s=%s" % (kernel, v) for v in ("reg", "table")} <= names
    for kernel in _build.TILED:
        assert {"variant:%s=%s" % (kernel, v) for v in ("rec", "tiled")} <= names
        assert ("variant:%s=looped" % kernel in names) == (kernel in _build.DRAWS)
    assert not any(n.endswith("=tile") for n in names)


def test_package_imports_without_jax():
    code = "import pypmc_tpu_torch, sys; assert 'jax' not in sys.modules"
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


# ------------------------------------------------------------------ #
# plain kernel versions against the Pallas kernels (interpret mode)   #
# ------------------------------------------------------------------ #

@pytest.fixture()
def interpret(monkeypatch):
    monkeypatch.setattr(pk, "INTERPRET", True)
    monkeypatch.setattr(jcore, "use_pallas", lambda *a, **k: True)


@pytest.mark.parametrize("student_t,dead", [(True, False), (False, True)])
def test_plain_logq_matches_pallas_interpret(interpret, student_t, dead):
    rng = np.random.default_rng(3)
    jp, tp = mixture(rng, 3, 5, student_t, dead, dtype=np.float32)
    xT = rng.normal(0, 2, (5, 1500)).astype(np.float32)
    a2, b2, ln, w, dof, center = jcore._pallas_operands(jp, "inv_chol")
    ref = np.asarray(pk.fused_logq(jnp.asarray(xT), a2, b2, ln, w, dof, center, dim=5))
    got = kernels.fused_logq(torch.tensor(xT), core._kernel_operands(tp)).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("student_t,dead", [(True, True), (False, False)])
def test_plain_pmc_stats_matches_pallas_interpret(interpret, student_t, dead):
    """Statistics are compared per particle (divided by N): the sums of the
    two float32 paths run in different orders."""
    import jax

    rng = np.random.default_rng(4)
    D, N = 4, 1999
    jp, tp = mixture(rng, 3, D, student_t, dead, dtype=np.float32)
    xT = rng.normal(0, 2, (D, N)).astype(np.float32)
    w = rng.exponential(1.0, N).astype(np.float32)
    a2, b2, ln, wk, dof, _ = jcore._pallas_operands(jp, "inv_chol")
    psi = (jax.scipy.special.digamma(0.5 * (D + jp.dof)).reshape(3, 1)
           if student_t else None)
    ref = pk.fused_pmc_stats(jnp.asarray(xT), jnp.asarray(w), a2, b2, ln, wk, dof, psi,
                             dim=D, dof_stats=student_t)
    got = kernels.fused_pmc_stats(torch.tensor(xT), torch.tensor(w),
                                  core._kernel_operands(tp), student_t)
    for key in ("s0", "s0c", "sd", "g", "sw", "t1"):
        np.testing.assert_allclose(got[key].numpy() / N, np.asarray(ref[key]) / N,
                                   rtol=2e-3, atol=2e-3, err_msg=key)


GATE_SHAPES = [(10, 10, 2), (1, 1, 1), (30, 10, 2), (2, 40, 2), (64, 32, 2), (400, 10, 2),
               (370, 10, 2), (1, 128, 1), (1, 129, 1), (3, 500, 1), (128, 1, 1), (2, 64, 4),
               (2, 64, 5), (16, 8, 2), (17, 8, 2)]


def jax_rule(kernel, K, D, Kt, n=None, n_steps=None, student_t=False):
    """Whether the JAX package runs its Pallas kernel for this shape (for
    the transforms, ``density/core.py:308-314``; for the pool, ``K`` is the
    target's component count, ``sampler/markov_chain.py:449-457``; for a
    K-blocked kernel, its VMEM fit, ``mix_adapt/pmc.py:228``, ``:430``)."""
    if kernel in ("fused_logq", "fused_rho", "fused_maha"):
        return pk.fits_vmem(K, D, pk.QUANTUM_EVAL)
    if kernel == "fused_propose_logq":
        return pk.fits_vmem(K + Kt, D, pk.QUANTUM_RNG)
    if kernel == "fused_is_pmc_step":
        return K * D <= 128 and pk.fits_vmem(K + Kt, D, pk.QUANTUM_RNG)
    if kernel in ("fused_transform", "fused_transform_rng"):
        quantum = pk.QUANTUM_RNG if kernel == "fused_transform_rng" else pk.QUANTUM_EVAL
        return pk.fits_vmem(K, D, quantum) and (n is None or n >= 1024)
    if kernel == "fused_mcmc_pool":
        return pk.fits_vmem_mcmc(D, K, n_steps, student_t)
    if kernel in ("fused_pmc_stats_blocked", "fused_vb_estep_blocked"):
        return pk.fits_vmem_blocked(K, D, pk.QUANTUM_EVAL)
    if kernel == "fused_is_pmc_step_blocked":
        return pk.fits_vmem_blocked(K + Kt, D, pk.QUANTUM_RNG)
    return K * D <= 128


@pytest.mark.parametrize("kernel", _build.KERNELS)
def test_fits_is_the_jax_rule(kernel):
    """fits() routes a shape to the kernel exactly where the JAX package
    runs its Pallas kernel; refusal() names the rule otherwise.  The CUDA
    kernel's own limits are a separate check, which its wrapper makes."""
    rule = {"n_steps": 400} if kernel == "fused_mcmc_pool" else {}
    for K, D, Kt in GATE_SHAPES:
        fits = kernels.fits(kernel, K, D, Kt, **rule)
        assert fits == jax_rule(kernel, K, D, Kt, **rule), (K, D, Kt)
        assert (kernels.refusal(kernel, K, D, Kt, **rule) is None) == fits
        reason = _build.limit_reason(kernel, K, D, Kt)
        if reason is None:
            _build.check_limits(kernel, K, D, Kt)
        else:
            with pytest.raises(ValueError, match="limit"):
                _build.check_limits(kernel, K, D, Kt)
    assert kernels.fits(kernel, 10, 10, 2, **rule)
    assert kernels.fits(kernel, 2, 40, 2, **rule)


def test_transform_and_pool_rules_over_a_grid(monkeypatch):
    """The two transform routes (with the particle count) and the pool
    (with the steps of a cycle and the proposal family) over a grid of
    shapes, against fits_vmem / fits_vmem_mcmc; the pool's step chunk is
    mcmc_step_chunk at its default cap."""
    monkeypatch.delenv("PYPMC_TPU_MCMC_SC", raising=False)
    for K in (1, 2, 5, 11, 12, 13, 16, 40, 64, 200):
        for D in (1, 2, 10, 32, 40, 64, 128, 129):
            for n in (None, 1, 1023, 1024, 1 << 22):
                for kernel in ("fused_transform", "fused_transform_rng"):
                    assert kernels.fits(kernel, K, D, n=n) == jax_rule(kernel, K, D, 0, n=n), \
                        (kernel, K, D, n)
    for Kt in (1, 2, 5, 30):
        for D in (1, 2, 10, 40, 64, 100, 128):
            for n_steps in (1, 7, 64, 96, 400, 500, 1000):
                assert kernels.mcmc_step_chunk(n_steps, D) == pk.mcmc_step_chunk(n_steps, D)
                for student_t in (False, True):
                    assert kernels.fits("fused_mcmc_pool", Kt, D, n_steps=n_steps,
                                        student_t=student_t) == \
                        pk.fits_vmem_mcmc(D, Kt, n_steps, student_t), (Kt, D, n_steps, student_t)
    # the routes of the pipeline's D=40 configuration
    assert kernels.fits("fused_transform_rng", 11, 40, n=1024)
    assert not kernels.fits("fused_transform_rng", 12, 40, n=1024)
    assert kernels.fits("fused_transform", 16, 40, n=1024)
    assert not kernels.fits("fused_propose_logq", 11, 40, 2)
    assert kernels.fits("fused_mcmc_pool", 2, 40, n_steps=400)
    with pytest.raises(ValueError, match="n_steps"):
        kernels.fits("fused_mcmc_pool", 2, 40)


@pytest.mark.parametrize("kernel", ["fused_pmc_stats", "fused_vb_estep", "fused_is_pmc_step"])
def test_elects_blocked_is_the_jax_rule(kernel):
    """Where the single-pass kernel is out, the JAX package elects its
    K-blocked variant if the mixture fits its VMEM and the unfused (K, N)
    matrices would crowd 12 GiB."""
    Kt = 2
    for K, D, N in ((30, 10, 10 ** 6), (400, 2, 3 * 10 ** 6), (400, 10, 3 * 10 ** 6),
                    (64, 40, 1 << 25), (2000, 2, 10 ** 6), (600, 2, 2 * 10 ** 6), (4, 8, 1 << 30),
                    (100, 2, 2 * 10 ** 7)):
        if kernel == "fused_is_pmc_step":
            fit = pk.fits_vmem_blocked(K + Kt, D, pk.QUANTUM_RNG)
        else:
            fit = pk.fits_vmem_blocked(K, D, pk.QUANTUM_EVAL)
        want = not jax_rule(kernel, K, D, Kt) and fit and pk.prefer_blocked(K, N)
        if not kernels.fits(kernel, K, D, Kt):
            assert kernels.elects_blocked(kernel, K, D, N, Kt) == want, (K, D, N)
    assert kernels.elects_blocked(kernel, 100, 2, 2 * 10 ** 7, Kt)
    assert not kernels.elects_blocked("fused_logq", 400, 2, 3 * 10 ** 6)


def test_gate_counts_the_plain_route():
    kernels.reset_launch_counts()
    assert kernels.gate("fused_logq", 10, 10)
    assert kernels.gate("fused_logq", 2, 40)
    assert not kernels.gate("fused_logq", 400, 10)
    assert not kernels.gate("fused_pmc_stats", 30, 10)
    counts = kernels.launch_counts()
    assert counts["plain:fused_logq"] == 1 and counts["plain:fused_pmc_stats"] == 1
    assert sum(counts.values()) == 2
    kernels.reset_launch_counts()
    assert sum(kernels.launch_counts().values()) == 0


def test_fused_logq_launch_maps_under_vmap_in_one_launch():
    """The launch's vmap rule folds the batch into the particle axis, so a
    vmapped per-point (or per-block) call is one launch.  A stand-in CPU
    kernel (the plain version, counting its calls) takes the CUDA launch's
    place; the wrapper itself never reaches the launch with CPU tensors."""
    rng = np.random.default_rng(8)
    _, tp = mixture(rng, 3, 4, True, dtype=np.float32)
    ops = core._kernel_operands(tp)
    calls = []

    def cpu_kernel(xT, packed, K, student_t):
        calls.append(tuple(xT.shape))
        return kernels.plain_logq(xT, kernels.MixtureOperands(packed, K, xT.shape[0], student_t))

    kernels._logq_launch.register_kernel("cpu", cpu_kernel)
    x = torch.tensor(rng.normal(0, 2, (50, 4)).astype(np.float32))
    ref = kernels.plain_logq(x.T.contiguous(), ops)
    launch = lambda xT: kernels._logq_launch(xT, ops.packed, ops.K, True)
    per_point = torch.func.vmap(lambda p: launch(p[:, None].contiguous())[0])(x)
    assert calls == [(4, 50)]
    torch.testing.assert_close(per_point, ref, rtol=1e-6, atol=1e-6)
    blocks = torch.func.vmap(launch, in_dims=2)(x.T.reshape(4, 5, 10).permute(0, 2, 1))
    assert calls[1:] == [(4, 50)] and blocks.shape == (5, 10)
    torch.testing.assert_close(blocks, ref.view(5, 10), rtol=1e-6, atol=1e-6)


def test_fused_rho_launch_maps_under_vmap_in_one_launch():
    """fused_rho's launch folds a vmapped batch into the particle axis as
    fused_logq's does: a per-point (or per-block) call is one launch, rho
    (K, B, N) with the batch at dim 1 and log q (B, N), as a stand-in CPU
    kernel (the plain version, counting its calls) shows."""
    rng = np.random.default_rng(18)
    _, tp = mixture(rng, 3, 4, True, dead=True, dtype=np.float32)
    ops = core._kernel_operands(tp)
    calls = []

    def cpu_kernel(xT, packed, K, student_t):
        calls.append(tuple(xT.shape))
        return kernels.plain_rho(xT, kernels.MixtureOperands(packed, K, xT.shape[0], student_t))

    kernels._rho_launch.register_kernel("cpu", cpu_kernel)
    x = torch.tensor(rng.normal(0, 2, (50, 4)).astype(np.float32))
    rho, log_q = kernels.plain_rho(x.T.contiguous(), ops)
    launch = lambda xT: kernels._rho_launch(xT, ops.packed, ops.K, True)
    per_point = torch.func.vmap(lambda p: launch(p[:, None].contiguous()))(x)
    assert calls == [(4, 50)] and per_point[0].shape == (50, 3, 1)
    torch.testing.assert_close(per_point[0][..., 0].T, rho, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(per_point[1][:, 0], log_q, rtol=1e-6, atol=1e-6)
    assert torch.all(per_point[0][:, 1] == 0)    # the dead component
    blocks = torch.func.vmap(launch, in_dims=2)(x.T.reshape(4, 5, 10).permute(0, 2, 1))
    assert calls[1:] == [(4, 50)] and blocks[0].shape == (5, 3, 10)
    torch.testing.assert_close(blocks[0], rho.view(3, 5, 10).permute(1, 0, 2),
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(blocks[1], log_q.view(5, 10), rtol=1e-6, atol=1e-6)


def test_fused_maha_launch_maps_under_vmap_in_one_launch():
    """fused_maha's launch too: a per-point (or per-block) call is one
    launch, (K, B, N) with the batch at dim 1, for lower and upper
    operands."""
    rng = np.random.default_rng(19)
    calls = []

    def cpu_kernel(xT, a, m):
        calls.append(tuple(xT.shape))
        return kernels.plain_maha(xT, a, m)

    kernels._maha_launch.register_kernel("cpu", cpu_kernel)
    x = torch.tensor(rng.normal(0, 2, (50, 4)).astype(np.float32))
    for a, m in (upper_operands(rng, 3, 4), (np.linalg.cholesky(spd(rng, 3, 4)).astype(
            np.float32), rng.normal(0, 2, (3, 4)).astype(np.float32))):
        a, m = torch.tensor(a), torch.tensor(m)
        ref = kernels.plain_maha(x.T.contiguous(), a, m)
        calls.clear()
        per_point = torch.func.vmap(lambda p: kernels._maha_launch(p[:, None].contiguous(),
                                                                   a, m))(x)
        assert calls == [(4, 50)] and per_point.shape == (50, 3, 1)
        torch.testing.assert_close(per_point[..., 0].T, ref, rtol=1e-6, atol=1e-6)
        blocks = torch.func.vmap(lambda b: kernels._maha_launch(b, a, m), in_dims=2)(
            x.T.reshape(4, 5, 10).permute(0, 2, 1))
        assert calls[1:] == [(4, 50)] and blocks.shape == (5, 3, 10)
        torch.testing.assert_close(blocks, ref.view(3, 5, 10).permute(1, 0, 2),
                                   rtol=1e-6, atol=1e-6)


def upper_operands(rng, K, D):
    """VB's operands: ``A_k = sqrt(nu_k) chol(W_k)^T`` (upper), means."""
    W = np.linalg.inv(spd(rng, K, D))
    nu = rng.uniform(D, D + 5, K)
    A = np.sqrt(nu)[:, None, None] * np.transpose(np.linalg.cholesky(W), (0, 2, 1))
    return A.astype(np.float32), rng.normal(0, 2, (K, D)).astype(np.float32)


@pytest.mark.parametrize("operand", ["lower", "upper"])
def test_plain_maha_matches_pallas_interpret(interpret, operand):
    """A lower (inverse Cholesky) and an upper (VB's A) operand: both are
    read whole."""
    rng = np.random.default_rng(5)
    K, D, N = 3, 5, 1500
    if operand == "lower":
        jp, tp = mixture(rng, K, D, False, dtype=np.float32)
        a, m = np.asarray(jp.inv_chol), np.asarray(jp.means)
    else:
        a, m = upper_operands(rng, K, D)
        assert np.all(np.tril(a, -1) == 0) and np.any(np.triu(a, 1) != 0)
    xT = rng.normal(0, 2, (D, N)).astype(np.float32)
    b2 = np.einsum("kid,kd->ki", a, m).reshape(K * D, 1)
    ref = np.asarray(pk.fused_maha(jnp.asarray(xT), jnp.asarray(a.reshape(K * D, D)),
                                   jnp.asarray(b2), jnp.asarray(m.mean(0)), dim=D))
    got = kernels.fused_maha(torch.tensor(xT), torch.tensor(a), torch.tensor(m)).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("student_t,dead", [(True, True), (False, False)])
def test_plain_rho_matches_pallas_interpret(interpret, student_t, dead):
    rng = np.random.default_rng(6)
    jp, tp = mixture(rng, 4, 3, student_t, dead, dtype=np.float32)
    xT = rng.normal(0, 2, (3, 1700)).astype(np.float32)
    a2, b2, ln, w, dof, center = jcore._pallas_operands(jp, "inv_chol")
    rho_ref, lq_ref = pk.fused_rho(jnp.asarray(xT), a2, b2, ln, w, dof, center, dim=3)
    rho, lq = kernels.fused_rho(torch.tensor(xT), core._kernel_operands(tp))
    np.testing.assert_allclose(rho.numpy(), np.asarray(rho_ref), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(lq.numpy(), np.asarray(lq_ref), rtol=2e-3, atol=2e-3)
    if dead:
        assert np.all(rho.numpy()[2] == 0)


# the register pass's edge shapes (csrc/reg_stats.cuh dense_plan): one
# group at K=10 and 16, two at K=17 (D=10), three row bands at D=11 and 16,
# eight groups at K=128, D=1
EDGE_SHAPES = [(10, 10), (16, 10), (17, 10), (11, 11), (8, 16), (128, 1)]


@pytest.mark.parametrize("K,D", [(3, 4)] + EDGE_SHAPES)
@pytest.mark.parametrize("zero_weights", [False, True])
def test_plain_vb_estep_matches_pallas_interpret(interpret, zero_weights, K, D):
    """Statistics per particle (divided by N), as for fused_pmc_stats; zero
    weights contribute exactly nothing."""
    rng = np.random.default_rng(7)
    N = 1999
    a, m = upper_operands(rng, K, D)
    const = rng.normal(0, 1, K).astype(np.float32)
    xT = (m[rng.integers(0, K, N)].T + rng.normal(0, 1, (D, N))).astype(np.float32)
    w = rng.exponential(1.0, N).astype(np.float32)
    if zero_weights:
        w[::3] = 0.0
    b2 = np.einsum("kid,kd->ki", a, m).reshape(K * D, 1)
    ref = pk.fused_vb_estep(jnp.asarray(xT), jnp.asarray(w), jnp.asarray(a.reshape(K * D, D)),
                            jnp.asarray(b2), jnp.asarray(const.reshape(K, 1)), dim=D)
    args = [torch.tensor(v) for v in (xT, w, a, m, const)]
    got = kernels.fused_vb_estep(*args)
    for name, g, r in zip(("N_comp", "sd", "g", "log_q_Z"), got, ref):
        np.testing.assert_allclose(g.numpy() / N, np.asarray(r) / N, rtol=2e-3, atol=2e-3,
                                   err_msg=name)
    if zero_weights:
        # in float64, dropping the zero-weight particles changes only the
        # order of the sums
        keep = w > 0
        full = kernels.fused_vb_estep(*[t.double() for t in args])
        sub = kernels.fused_vb_estep(torch.tensor(xT[:, keep]).double(),
                                     torch.tensor(w[keep]).double(),
                                     *[t.double() for t in args[2:]])
        for g, s in zip(full, sub):
            torch.testing.assert_close(g, s, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("K,D", EDGE_SHAPES)
def test_plain_is_pmc_step_statistics_match_pallas_interpret(interpret, K, D):
    """fused_is_pmc_step's weights and statistics on its own particles: the
    JAX kernel's (interpret mode, its own draw, a proposal with a dead
    component) against the plain version's on the same particles, per
    particle as for fused_pmc_stats."""
    import jax

    rng = np.random.default_rng(K + D)
    student_t = K % 2 == 0
    jp, tp = mixture(rng, K, D, student_t, dead=True, dtype=np.float32)
    jt, tt = mixture(rng, 2, D, not student_t, dtype=np.float32)
    n = 2048
    a2, b2, ln, wk, dof_col, center = jcore._pallas_operands(jp, "inv_chol")
    psi_c = (jax.scipy.special.digamma(0.5 * (D + jp.dof)).reshape(K, 1).astype(jnp.float32)
             if student_t else None)
    xT, latent, w, ref = pk.fused_is_pmc_step(
        jnp.array([3, 4], dtype=jnp.int32), jnp.cumsum(jp.weights).reshape(K, 1),
        jp.chol.reshape(K * D, D), jp.means.T, None if jp.dof is None else jp.dof.reshape(1, K),
        a2, b2, ln, wk, dof_col, center, psi_c, jcore._pallas_operands(jt, "inv_chol"),
        n=n, dim=D, dof_stats=student_t)
    assert not np.any(np.asarray(latent) == K // 2)
    x, wt = torch.tensor(np.asarray(xT)), torch.tensor(np.asarray(w))
    ops, tops = core._kernel_operands(tp), core._kernel_operands(tt)
    np.testing.assert_allclose(
        wt.numpy(), torch.exp(kernels.plain_logq(x, tops) - kernels.plain_logq(x, ops)).numpy(),
        rtol=2e-3, atol=1e-30)
    got = kernels.plain_pmc_stats(x, wt, ops, student_t, n_sw=3)
    assert float(got["s0"][K // 2]) == 0.0
    for key in ("s0", "s0c", "sd", "g", "sw", "t1"):
        np.testing.assert_allclose(got[key].numpy() / n, np.asarray(ref[key]) / n,
                                   rtol=2e-3, atol=2e-3, err_msg=key)
