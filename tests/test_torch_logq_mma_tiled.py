"""fused_logq's and fused_rho's tensor-core kernels past D = 64
(``csrc/mma_tiled.cuh``'s walk on U's lower triangle: ``logq_mma_tiled_kernel``
and ``rho_mma_tiled_kernel`` after ``mma_split_kernel<true>``) on the CPU: a
numpy mirror of the walk's control flow, whose skipped (n-tile, depth step)
blocks are exactly those of U's split that are all zero; the arithmetic's
mirror (fused_maha's past D = 64, ``test_torch_maha_mma_tiled.py``, on U's
lower triangle: skipping blocks of zeros adds nothing), then the epilogue's
(``tiled.cuh`` ``LogqEpi`` and ``RhoEpi``: component_logpdf, the weighted
log-sum-exp k ascending with a dead component left out, rho read back)
against the float64 plain versions under ``chip_smoke.TOL["log"]`` and
``["rho"]`` at D = 65-200, K = 1 and the JAX rule's largest K; a
one-product (1xTF32) mirror misses ``TOL["log"]`` at D = 200; the plan,
the split scratch and the election in ``ops/_build.py`` and ``ops/kernels.py``
against the CUDA sources.  The kernels run only on the card
(``chip_smoke.py`` ``tiled_case``, ``evaluation_nonfinite_case``)."""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import chip_smoke
import pypmc_tpu_torch
from pypmc_tpu_torch.density import core
from pypmc_tpu_torch.ops import _build, kernels

from test_torch_maha_mma_tiled import LARGEST_K, N_SMALL, mirror_maha_tiled

torch.set_num_threads(1)

CSRC = Path(_build.__file__).resolve().parent.parent / "csrc"


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless the CPU is asked for: ask for it;
    numpy's BLAS on one thread (the mirror's many small products)."""
    with pypmc_tpu_torch.using_device("cpu"), threadpool_limits(1):
        yield


def walk_blocks(D):
    """The (row block, column block) pairs of 8 x 8 the tensor-core walk
    computes with TRI for one component, as mma_tiled.cuh's loops run:
    row tiles of 128 rows below D padded to 8 (Dp), the panels
    mma_tile_panels gives each, four depth steps a panel (a step at or past
    Dp, or past the warp's 32 rows, ends the panel for that warp), and each
    warp's four n-tiles of 8 rows (one at or past Dp, or whose last row is
    left of the step's first column, skipped)."""
    P, M, KD = _build.mma_tiled_plan()[:3]
    Dp = -(-D // 8) * 8
    done = set()
    for rt in range(-(-Dp // M)):
        for p in range(_build.mma_tile_panels(rt, D, True)):
            for wr in range(4):
                row0 = rt * M + 32 * wr
                if row0 >= Dp:
                    continue
                for st in range(KD // 8):
                    j0 = p * KD + 8 * st
                    if j0 >= Dp or j0 >= row0 + 32:
                        break
                    for nt in range(4):
                        i0 = row0 + 8 * nt
                        if i0 < Dp and j0 < i0 + 8:
                            done.add((i0, j0))
    return done


@pytest.mark.parametrize("D", [65, 96, 127, 128, 129, 200, 256, 1000])
def test_the_skipped_blocks_are_exactly_the_zero_ones(D):
    """Every 8 x 8 block of the split U that holds a nonzero (U's lower
    triangle, below D) is computed, once; every block skipped is all zero
    (above the diagonal or past D).  At D = 200 the walk runs 325 of 625
    blocks a component, 52% of fused_maha's."""
    rng = np.random.default_rng(D)
    Dp = -(-D // 8) * 8
    U = np.zeros((Dp, Dp))
    U[:D, :D] = np.tril(rng.normal(0, 1, (D, D)) + 5 * np.eye(D))
    nonzero = {(i0, j0) for i0 in range(0, Dp, 8) for j0 in range(0, Dp, 8)
               if np.any(U[i0:i0 + 8, j0:j0 + 8] != 0)}
    done = walk_blocks(D)
    assert done == nonzero
    if D == 200:
        assert (len(done), (Dp // 8) ** 2) == (325, 625)


def test_the_panels_mirror_the_source():
    """_build.mma_tile_panels against csrc/mma_tiled.cuh mma_tile_panels:
    every panel of a general A; with TRI those at or left of the row tile's
    last row below D (tiled.cuh tile_panels' rule at the depth of 32)."""
    src = (CSRC / "mma_tiled.cuh").read_text()
    assert "if (!tri) return mma_tiled_depth(D) / kMtK;" in src
    assert "return (min(D, (rt + 1) * kMtM) - 1) / kMtK + 1;" in src
    assert re.search(r"if \(\+\+s\.p < mma_tile_panels\(s\.rt, D, TRI\)\) return true;", src)
    assert "if (j0 >= Dp || (TRI && j0 >= row0 + 32)) break;" in src
    assert "(!TRI || j0 < row0 + 8 * nt + 8)" in src
    assert [_build.mma_tile_panels(rt, 200, True) for rt in (0, 1)] == [4, 7]
    assert [_build.mma_tile_panels(rt, 200, False) for rt in (0, 1)] == [7, 7]
    assert _build.mma_tile_panels(0, 65, True) == _build.mma_tile_panels(0, 65, False) == 3
    for D in (65, 96, 128, 129, 200, 1000, 2040):
        for rt in range(-(-D // 128)):
            last = min(D, 128 * (rt + 1)) - 1
            assert _build.mma_tile_panels(rt, D, True) == last // 32 + 1
    # the split of a triangular U: only its lower triangle is read
    assert "if (j < D && (!TRI || j <= i)) v0 = row[j];" in src


def mixture_problem(K, D, N, student_t, seed):
    """A float32 K-component mixture (the middle one dead where K > 1),
    packed, and N particles from it (chip_smoke.mixture_particles)."""
    rng = np.random.default_rng(seed)
    params = chip_smoke.make_params(
        chip_smoke.random_mixture(rng, K, D, student_t, K > 1), torch.device("cpu"))
    ops = core._kernel_operands(params)
    return ops, chip_smoke.mixture_particles(ops, N, seed, torch.device("cpu"))


def component_logpdf(maha, ln, dof, D, student_t):
    """csrc/common.cuh component_logpdf in float32 (the Student-t term's
    FMA stated)."""
    f32 = np.float32
    if student_t:
        a = (f32(-0.5) * (dof + f32(D))).astype(np.float64)
        l1p = np.log1p(maha / dof[:, None]).astype(f32).astype(np.float64)
        return (a[:, None] * l1p + ln.astype(np.float64)[:, None]).astype(f32)
    return (ln[:, None] - f32(0.5) * maha).astype(f32)


def mirror_eval(ops, xT, products=3):
    """``(log q (N,), rho (K, N))`` as the tensor-core kernels compute
    them: the squared distances by the walk's arithmetic on U's lower
    triangle (mirror_maha_tiled), then LogqEpi / RhoEpi in float32: the
    component log-densities, the weighted log-sum-exp k ascending over the
    live components (test_torch_nonfinite.weighted_lse), rho_k = w_k exp(log
    q_k - log q), 0 where w_k = 0."""
    from test_torch_nonfinite import weighted_lse

    f = {k: v.numpy() for k, v in ops.fields().items()}
    U = np.tril(f["U"]).astype(np.float32)
    maha = mirror_maha_tiled(xT.numpy(), U, f["mu"], products)
    ind = component_logpdf(maha, f["log_norm"], f["dof"], ops.dim, ops.student_t)
    w = f["weights"].astype(np.float32)
    log_q = weighted_lse(ind, w, skip_dead=True)
    rho = np.where(w[:, None] > 0, (np.exp(ind - log_q[None]) * w[:, None]).astype(np.float32),
                   np.float32(0))
    return log_q, rho


def errors(ops, xT, got_lq, got_rho):
    """``{kind: (max |got - float64 plain|, TOL[kind]'s bound)}``."""
    ops64 = kernels.MixtureOperands(ops.packed.double(), ops.K, ops.dim, ops.student_t)
    rho64, lq64 = (t.numpy() for t in kernels.plain_rho(xT.double(), ops64))
    out = {}
    for kind, got, ref in (("log", got_lq, lq64), ("rho", got_rho, rho64)):
        atol, rtol = chip_smoke.TOL[kind]
        out[kind] = (float(np.abs(got.astype(np.float64) - ref).max()),
                     atol + rtol * float(np.abs(ref).max()))
    return out


@pytest.mark.parametrize("student_t", [False, True])
@pytest.mark.parametrize("D,K", [(D, K) for D in (65, 96, 128, 129, 200)
                                 for K in (1, LARGEST_K[D])])
def test_three_tf32_products_are_within_the_log_and_rho_tolerances(D, K, student_t):
    """The mirror's log q and rho against the float64 plain version on the
    same float32 inputs: within TOL["log"] and TOL["rho"] (the tolerances
    the card holds the kernels to), a dead component's rho exactly 0."""
    ops, xT = mixture_problem(K, D, N_SMALL, student_t, K * 1000 + D)
    log_q, rho = mirror_eval(ops, xT)
    for kind, (err, bound) in errors(ops, xT, log_q, rho).items():
        assert err <= bound, (kind, err, bound)
    if K > 1:
        assert (rho[K // 2] == 0).all()


def test_one_tf32_product_misses_the_log_tolerance_at_200():
    """The negative control: one TF32 product (~2^-11 of a product) puts
    log q outside TOL["log"] at D = 200 (~0.5 maha 2^-11 of absolute error,
    maha ~ D)."""
    ops, xT = mixture_problem(19, 200, N_SMALL, False, 19200)
    log_q, rho = mirror_eval(ops, xT, products=1)
    err, bound = errors(ops, xT, log_q, rho)["log"]
    assert err > 3 * bound, (err, bound)


def test_the_election_and_the_scratch_mirror_the_sources():
    """fused_logq and fused_rho elect the record kernel to D = 64 and the
    tensor-core kernel from kTiledDMin to WIDE_D_MAX (csrc/tiled.cuh
    eval_variant, as _build.eval_variant and the launchers' per-SM and
    chunk queries read it), the tiled kernel forcible at every D; past D =
    64 the wrappers allocate the split scratch (mma_scratch_floats(K, D)
    floats; the propose route's evaluations one of the larger of K and Kt
    for log q and log p in turn); every launcher that reaches fused_logq's
    kernel takes its pointer."""
    tiled = (CSRC / "tiled.cuh").read_text()
    assert "return D < kTiledDMin ? kEvalRec : kEvalMma;" in tiled
    assert "(v == kEvalMma && (maha || D > kRecDMax))" in tiled
    for kernel in ("fused_logq", "fused_rho"):
        assert [_build.eval_variant(kernel, D) for D in (1, 64, 65, 200, _build.WIDE_D_MAX)] \
            == ["rec", "rec", "mma", "mma", "mma"]
        assert kernels._eval_variants(kernel, 64) == ("rec", "tiled")
        assert kernels._eval_variants(kernel, 65) == ("tiled", "mma")
        assert _build.eval_plan(kernel, 19, 200) == (1, 3, _build.mma_tiled_plan()[5])
        assert _build.block_particles(kernel, 200) == 128
    for K, D in ((1, 65), (19, 200), (60, 65), (1, 2040)):
        got = kernels._eval_scratch(K, D, torch.device("cpu"), "mma")
        assert got.numel() == _build.mma_scratch_floats(K, D) == 2 * K * (-(-D // 8) * 8) * (
            -(-D // 32) * 32)
        assert kernels._eval_scratch(K, D, torch.device("cpu"), "tiled") is None
    assert kernels._eval_scratch(3, 64, torch.device("cpu"), "mma") is None
    assert kernels._draw_evaluations("rec", 4099, 2, 5, 96, torch.device("cpu")) == (None, 0)
    assert "_eval_scratch(max(K, Kt), D, device, elected)" in Path(kernels.__file__).read_text()
    sig = _build.signatures()
    P = ctypes.c_void_p
    assert sig["pmc_fused_logq"][:4] == [P] * 4 and sig["pmc_fused_rho"][:5] == [P] * 5
    assert sig["pmc_fused_propose_logq"][10] is P and sig["pmc_fused_propose_logq"][11] is \
        ctypes.c_longlong
    assert sig["pmc_fused_is_pmc_step"][10] is P and sig["pmc_fused_is_pmc_step"][13] is \
        ctypes.c_longlong
    assert sig["pmc_fused_pmc_stats_blocked"][5] is P
    propose = (CSRC / "propose_logq.cu").read_text()
    assert "pmc_fused_logq(xT, mix, split, log_q, N, K, D, student_t, -1, eval_blocks, s)" \
        in propose
    assert "kEvalTiled" not in propose


@pytest.mark.parametrize("D", [65, 200])
def test_every_variant_past_64_runs_the_plain_version_on_the_cpu(D):
    """On the CPU fused_logq's and fused_rho's tensor-core and tiled
    variants past D = 64 are the plain versions; the record kernel raises
    ValueError naming the plan there, and the tensor-core kernel to D =
    64."""
    ops, xT = mixture_problem(2, D, 130, True, D)
    lq, (rho, rlq) = kernels.plain_logq(xT, ops), kernels.plain_rho(xT, ops)
    for variant in (None, "mma", "tiled"):
        assert torch.equal(kernels.fused_logq(xT, ops, variant=variant), lq)
        got = kernels.fused_rho(xT, ops, variant=variant)
        assert torch.equal(got[0], rho) and torch.equal(got[1], rlq)
    for call in (kernels.fused_logq, kernels.fused_rho):
        with pytest.raises(ValueError, match="the plan"):
            call(xT, ops, variant="rec")
    ops64, x64 = mixture_problem(2, 64, 130, True, 64)
    for call in (kernels.fused_logq, kernels.fused_rho):
        with pytest.raises(ValueError, match="the plan"):
            call(x64, ops64, variant="mma")


def test_rho_and_logq_share_one_epilogue_arithmetic():
    """fused_rho's log q is fused_logq's bit for bit on the same kernel:
    LogqEpi and RhoEpi (csrc/tiled.cuh) add component_logpdf into one
    WeightedLse each in the same statements, dead components left out, and
    both tensor-core kernels walk mma_tiled_walk<true> on the same operands;
    the FP32 tiled kernels hand the same epilogues their squared distances
    through eval_maha."""
    tiled = (CSRC / "tiled.cuh").read_text()
    logq = re.search(r"struct LogqEpi \{(.*?)\n\};", tiled, re.S).group(1)
    rho = re.search(r"struct RhoEpi \{(.*?)\n\};", tiled, re.S).group(1)
    lse_add = "if (w > 0.0f)\n      lse.add(component_logpdf(maha, mix[L.ln() + k], mix[L.dof() + k], D, student_t), w);"
    assert lse_add in logq
    assert "component_logpdf(maha, mix[L.ln() + k], mix[L.dof() + k], D, student_t);" in rho
    assert "if (w > 0.0f) lse.add(ind, w);" in rho
    for name in ("logq", "rho"):
        src = (CSRC / ("%s.cu" % name)).read_text()
        epi = "LogqEpi" if name == "logq" else "RhoEpi"
        assert src.count("mma_tiled_walk<true>(reinterpret_cast<float*>(smem4), xT, mix + L.U(), "
                         "mix + L.mu(), split, N,") == 1
        assert src.count("%s epi{" % epi) == 2
        assert "epi(k, n, eval_maha(xT, mix, N, K, D, k, n, maha));" in src
