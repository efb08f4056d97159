"""fused_maha's tensor-core kernel past D = 64 (``csrc/mma_tiled.cuh``,
``maha_mma_tiled_kernel`` after ``mma_split_kernel<false>``) on the CPU: a numpy
mirror of its arithmetic -- x - m_k formed in float32, both operands split
into TF32 words (``cvt.rn``), three products a depth step of 8 coordinates
(hi hi into one float32 accumulator, hi lo and lo hi into another) in the
panels' order, y = big + small, its squares summed as the epilogue sums them
(a thread's two columns of each n-tile by FMA, the four lanes of a row group
by the reduce-scatter, the row tiles in order, then the four row groups in
order) -- against the float64 plain version under ``chip_smoke.TOL["maha"]``,
with lower, upper and full operands at D = 65, 96, 128, 129 and 200 at K = 1
and the JAX rule's largest K, and at D = 1000 and 2040 at K = 1, ragged N; a
one-product (1xTF32) mirror misses the same bound; the mirror against the
JAX package's ``fused_maha`` (Pallas, interpret mode); ``plain_maha`` against
it at D = 200; the plan's and the election's mirrors in ``ops/_build.py``
against the constants of the CUDA sources.  The kernel itself runs only on
the card (``tests/test_torch_kernels_gpu.py -k maha``, ``chip_smoke.py``)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import chip_smoke
import pypmc_tpu.ops.pallas_kernels as pk
import pypmc_tpu_torch
from pypmc_tpu_torch.ops import _build, kernels

from test_torch_maha_mma import operands, split

torch.set_num_threads(1)

CSRC = Path(_build.__file__).resolve().parent.parent / "csrc"
# the JAX rule's largest K at D (kernels.fits; chip_smoke.TILED_CASES)
LARGEST_K = {65: 60, 96: 41, 128: 30, 129: 30, 200: 19}
# ragged particle counts: not a multiple of the kernel's 128-particle tile
N_SMALL, N_WIDE = 389, 1031
# components a step of the mirror (bounds its memory at the largest K)
CHUNK = 8


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless the CPU is asked for: ask for it.
    numpy's BLAS on one thread: the mirror's many small products slow down
    tenfold when several test workers each spread them over every core."""
    with pypmc_tpu_torch.using_device("cpu"), threadpool_limits(1):
        yield


def _cuh_int(name, path):
    """The value of ``constexpr int name = ...;`` in a CUDA source."""
    return int(re.search(r"constexpr int %s = (\d+);" % name, (CSRC / path).read_text()).group(1))


def _fma32(a, b, c):
    """fmaf(a, b, c) on float32 arrays: the exact product, one rounding."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def mirror_maha_tiled(xT, A, m, products=3):
    """``(K, N)`` as ``maha_mma_tiled_kernel`` computes it.  D padded to 8
    (Dp) with zeros; per depth step s of 8 coordinates below Dp, ascending
    (the panels' steps in order), each m16n8k8 product's 8 exact TF32
    products summed and added to its float32 accumulator (one rounding an
    ``mma``): big = hi hi, small = hi lo, then lo hi (``products=1``: big
    alone).  Then the epilogue: rows in row tiles of 128, each of four row
    groups of 32 rows (four n-tiles of 8); lane t of a row group holds rows
    8 nt + 2 t and 8 nt + 2 t + 1 of each n-tile and sums their squares by
    FMA, nt ascending; the particle's owner lane o (the quarter of the
    warp's particles it falls in) joins the four lanes as (e_o + e_(o^2)) +
    (e_(o^1) + e_(o^3)); the row tiles' values are added in order, then the
    four row groups'.  Over chunks of :data:`CHUNK` components."""
    if A.shape[0] > CHUNK:
        return np.concatenate([mirror_maha_tiled(xT, A[k:k + CHUNK], m[k:k + CHUNK], products)
                               for k in range(0, A.shape[0], CHUNK)])
    K, D, _ = A.shape
    N = xT.shape[1]
    Dp = -(-D // 8) * 8
    M, P = _build.mma_tiled_plan()[1], _build.mma_tiled_plan()[0]
    rows = -(-Dp // M) * M
    Ap = np.zeros((K, rows, Dp), np.float32)
    Ap[:, :D, :D] = A
    d = np.zeros((K, Dp, N), np.float32)
    d[:, :D] = xT[None].astype(np.float32) - m[:, :, None].astype(np.float32)
    ah, al = split(Ap)
    dh, dl = split(d)
    big = np.zeros((K, rows, N), np.float32)
    small = np.zeros((K, rows, N), np.float32)
    for s in range(Dp // 8):
        j = slice(8 * s, 8 * s + 8)
        prod = lambda a, b: np.matmul(a[:, :, j].astype(np.float64), b[:, j].astype(np.float64))
        big = (big + prod(ah, dh)).astype(np.float32)
        if products == 3:
            small = (small + prod(ah, dl)).astype(np.float32)
            small = (small + prod(al, dh)).astype(np.float32)
    y = big + small
    # rows = rt * 128 + 32 wr + 8 nt + 2 t + c
    y = y.reshape(K, rows // M, 4, 4, 4, 2, N)
    e = np.zeros((K, rows // M, 4, 4, N), np.float32)   # (k, rt, wr, t, n)
    for nt in range(4):
        for c in range(2):
            v = y[:, :, :, nt, :, c]
            e = _fma32(v, v, e)
    # the warp's particles: P over its particle groups (warps / 4); lane t
    # of a row group owns particles t PW / 4 .. (t + 1) PW / 4 - 1 of them
    PW = P // (_build.mma_tiled_plan()[3] // 32 // 4)
    owner = (np.arange(N) % P) % PW // (PW // 4)
    lane = lambda o: np.take_along_axis(e, np.broadcast_to(o, e.shape[:3] + (1, N)), axis=3)[:, :, :, 0]
    v = (lane(owner) + lane(owner ^ 2)) + (lane(owner ^ 1) + lane(owner ^ 3))   # (k, rt, wr, n)
    part = np.zeros((K, 4, N), np.float32)
    for rt in range(rows // M):
        part = part + v[:, rt]
    return ((part[:, 0] + part[:, 1]) + part[:, 2]) + part[:, 3]


def maha_error(got, xT, A, m):
    """``(max |got - plain|, TOL["maha"]'s bound)`` against the float64
    plain version on the same float32 inputs (over chunks of :data:`CHUNK`
    components)."""
    f64 = lambda v: torch.tensor(v, dtype=torch.float64)
    ref = np.concatenate([kernels.plain_maha(f64(xT), f64(A[k:k + CHUNK]), f64(m[k:k + CHUNK])).numpy()
                          for k in range(0, A.shape[0], CHUNK)])
    atol, rtol = chip_smoke.TOL["maha"]
    return float(np.abs(got.astype(np.float64) - ref).max()), atol + rtol * float(np.abs(ref).max())


def wide_operands(K, D, kind, seed, N):
    """:func:`test_torch_maha_mma.operands` (lower, upper or full; particles
    about the centres), N particles; the full operand's entries over
    sqrt(D), so that its outputs stay the size of the others'."""
    xT, A, m = operands(K, D, kind, seed)
    if kind == "full":
        A = (A / np.sqrt(D)).astype(np.float32)
    return np.ascontiguousarray(xT[:, :N]), A, m


CASES = [(D, K) for D in (65, 96, 128, 129, 200) for K in (1, LARGEST_K[D])] + [(1000, 1),
                                                                                (2040, 1)]


def test_the_largest_k_is_the_rules():
    """LARGEST_K is the JAX rule's largest K at each D (kernels.fits), as
    chip_smoke.TILED_CASES takes it."""
    for D, K in LARGEST_K.items():
        assert kernels.fits("fused_maha", K, D) and not kernels.fits("fused_maha", K + 1, D)
        assert (K, D) in [(k, d) for k, d, _, _ in chip_smoke.TILED_CASES]


@pytest.mark.parametrize("kind", ["lower", "upper", "full"])
@pytest.mark.parametrize("D,K", CASES)
def test_three_tf32_products_are_within_the_maha_tolerance_past_64(D, K, kind):
    """The tiled kernel's 3xTF32 arithmetic, in its panels' and epilogue's
    order, is within TOL["maha"] of float64 with a margin of 4: the dropped
    lo lo term and the splits' roundings are ~2^-21 of a product."""
    assert chip_smoke.TOL["maha"] == (1e-5, 1e-5)
    N = N_SMALL if D >= 1000 or K > 1 else N_WIDE
    xT, A, m = wide_operands(K, D, kind, K * 100 + D, N)
    if kind == "lower":
        assert np.all(np.triu(A, 1) == 0)
    err, bound = maha_error(mirror_maha_tiled(xT, A, m), xT, A, m)
    assert err <= bound / 4, (err, bound)


@pytest.mark.parametrize("D,K", [(65, 60), (128, 1), (200, 19), (1000, 1)])
def test_one_tf32_product_misses_the_maha_tolerance_past_64(D, K):
    """The negative control: one TF32 product (~2^-11 of a product) is
    outside the same bound, by more than 10x."""
    xT, A, m = wide_operands(K, D, "upper", K * 100 + D, N_SMALL)
    err, bound = maha_error(mirror_maha_tiled(xT, A, m, products=1), xT, A, m)
    assert err > 10 * bound, (err, bound)


def test_the_epilogue_differs_from_the_d64_mirror_by_rounding_only():
    """The products are those of the kernel to D = 64 (its mirror in
    tests/test_torch_maha_mma.py); the two mirrors differ only in the order
    in which the squares are summed: within float32 rounding of each other
    (1e-6 relative)."""
    from test_torch_maha_mma import mirror_maha

    xT, A, m = wide_operands(3, 65, "upper", 5, N_WIDE)
    a, b = mirror_maha_tiled(xT, A, m), mirror_maha(xT, A, m)
    assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()


def test_the_mirror_matches_the_pallas_kernel_past_64(monkeypatch):
    """The mirror against the JAX package's fused_maha (its Pallas kernel
    in interpret mode, three split bf16 products) on the same inputs at K=3,
    D=65, N=257, within TOL["maha"]'s bound of each other."""
    monkeypatch.setattr(pk, "INTERPRET", True)
    K, D, N = 3, 65, 257
    xT, A, m = wide_operands(K, D, "upper", 7, N)
    ref = np.asarray(pk.fused_maha(jnp.asarray(xT), jnp.asarray(A.reshape(K * D, D)),
                                   jnp.asarray(np.einsum("kij,kj->ki", A, m).reshape(K * D, 1)),
                                   jnp.asarray(m.mean(0)), dim=D))
    got = mirror_maha_tiled(xT, A, m)
    atol, rtol = chip_smoke.TOL["maha"]
    assert np.abs(got - ref).max() <= atol + rtol * np.abs(ref).max()


def test_the_plain_version_matches_the_pallas_kernel_at_d200(monkeypatch):
    """plain_maha (float32 and float64) against the JAX package's fused_maha
    (Pallas, interpret mode) at K=2, D=200, N=300, lower and upper operands:
    within TOL["maha"]'s bound of each other."""
    monkeypatch.setattr(pk, "INTERPRET", True)
    K, D, N = 2, 200, 300
    atol, rtol = chip_smoke.TOL["maha"]
    for kind in ("lower", "upper"):
        xT, A, m = wide_operands(K, D, kind, 11, N)
        ref = np.asarray(pk.fused_maha(jnp.asarray(xT), jnp.asarray(A.reshape(K * D, D)),
                                       jnp.asarray(np.einsum("kij,kj->ki", A, m).reshape(K * D, 1)),
                                       jnp.asarray(m.mean(0)), dim=D))
        bound = atol + rtol * np.abs(ref).max()
        for dtype in (torch.float32, torch.float64):
            got = kernels.plain_maha(torch.tensor(xT, dtype=dtype), torch.tensor(A, dtype=dtype),
                                     torch.tensor(m, dtype=dtype)).numpy()
            assert np.abs(got - ref).max() <= bound, (kind, dtype)


def test_the_plan_mirrors_the_cuda_source():
    """_build.mma_tiled_plan and mma_scratch_floats against the constants of
    csrc/mma_tiled.cuh: 128 particles x 128 rows a block, 32-deep panels,
    256 threads, three step buffers of an A panel (rows 20 float4s apart,
    4 mod 8), an X panel (rows 136 floats apart) and an m panel, then the four
    row groups' partials: 177,536 B, one block an SM; the split operand 8 K
    Dp Dd bytes."""
    src = "mma_tiled.cuh"
    plan = _build.mma_tiled_plan()
    assert plan[:5] == (_cuh_int("kMtP", src), _cuh_int("kMtM", src), _cuh_int("kMtK", src),
                        32 * _cuh_int("kMtWarps", src), _cuh_int("kMtStages", src))
    assert "constexpr int kMtThreads = 32 * kMtWarps;" in (CSRC / src).read_text()
    assert plan == (128, 128, 32, 256, 3, 177_536)
    text = (CSRC / src).read_text()
    assert "constexpr int kMtXStride = kMtP + 8;" in text and _build._MT_X_STRIDE == 136
    assert "constexpr int kMtARow4 = kMtK / 2 + 4;" in text and _build._MT_A_ROW4 == 20
    assert _build._MT_A_ROW4 % 8 == 4
    stage = 4 * 128 * 20 + 32 * 136 + 32
    assert plan[5] == 4 * (3 * stage + 4 * 128) <= _build.SMEM_LIMIT
    assert plan[5] > _build._HALF_SMEM    # one block an SM
    assert "2LL * K * mma_dpad(D) * mma_tiled_depth(D)" in text
    for K, D, want in ((1, 65, 2 * 72 * 96), (19, 200, 2 * 19 * 200 * 224),
                       (1, 2040, 2 * 2040 * 2048), (3, 129, 2 * 3 * 136 * 160)):
        assert _build.mma_scratch_floats(K, D) == want
    # past D = 64 the wrapper's plan: a component at a time, 128 particles a
    # block, 256 threads; the tiled kernel's beside it
    for K, D in ((1, 65), (60, 65), (19, 200), (1, 2040), (2, 4096)):
        assert _build.eval_plan("fused_maha", K, D) == (1, 3, plan[5]) == (
            1, 3, _build.smem_bytes("fused_maha", K, D))
        assert _build.eval_plan("fused_maha", K, D, "tiled") == (1, 2, _build.tiled_plan()[4])
        assert _build.eval_threads(D, "mma") == 256 and _build.block_particles("fused_maha", D) == 128
        _build.check_limits("fused_maha", K, D)


def test_the_election_past_64_mirrors_the_cuda_source():
    """Past D = 64 fused_maha elects its tensor-core kernel at every D to
    WIDE_D_MAX, as csrc/tiled.cuh maha_variant does (from kMahaMmaDMin, no
    upper bound); the launcher takes the split operand there
    (csrc/tiled.cuh eval_mma_tiled, launch_mma_tiled), and the wrapper
    allocates it."""
    assert all(_build.eval_variant("fused_maha", D) == "mma"
               for D in (65, 96, 128, 129, 200, 1000, 2040, _build.WIDE_D_MAX))
    tiled = (CSRC / "tiled.cuh").read_text()
    assert "inline int maha_variant(int D) { return D >= kMahaMmaDMin ? kEvalMma : " \
           "eval_variant(D); }" in tiled
    maha = (CSRC / "maha.cu").read_text()
    assert "if (eval_mma_tiled(D, variant, true))" in maha
    assert "return launch_mma_tiled<false>(maha_mma_tiled_kernel, ops, scratch, K, D, n_blocks" \
        in maha
    assert "return D > kRecDMax && (variant >= 0 ? variant : maha ? maha_variant(D) : " \
        "eval_variant(D)) ==" in tiled
    assert _build._REC_D_MAX == 64
    assert kernels._eval_variants("fused_maha", 65) == ("tiled", "mma")
    assert kernels._eval_variants("fused_logq", 65) == ("tiled", "mma")
    assert _build.signatures()["pmc_fused_maha"][2] is __import__("ctypes").c_void_p


@pytest.mark.parametrize("D", [65, 200])
def test_the_mma_variant_past_64_runs_the_plain_version_on_the_cpu(D):
    """On the CPU every variant fused_maha has at D (the tensor-core and the
    tiled kernel past 64) is the plain version; the record kernel raises
    ValueError naming the plan, as every variant a shape lacks does."""
    rng = np.random.default_rng(D)
    xT = torch.tensor(rng.normal(0, 1, (D, 130)), dtype=torch.float32)
    a = torch.tensor(rng.normal(0, 1, (2, D, D)) / np.sqrt(D), dtype=torch.float32)
    m = torch.tensor(rng.normal(0, 1, (2, D)), dtype=torch.float32)
    ref = kernels.plain_maha(xT, a, m)
    for variant in (None, "mma", "tiled"):
        assert torch.equal(kernels.fused_maha(xT, a, m, variant=variant), ref)
    with pytest.raises(ValueError, match="the plan"):
        kernels.fused_maha(xT, a, m, variant="rec")


def test_the_split_masks_are_the_sources():
    """chip_smoke.MAHA_OFF (``--maha-split``) names csrc/mma_tiled.cuh's
    MahaOff bits, each alone and the two its rows combine; the library is
    built with none (PMC_MAHA_OFF 0)."""
    text = (CSRC / "mma_tiled.cuh").read_text()
    bits = {name: int(v) for name, v in re.findall(r"(kMahaOff\w+) = (\d+),", text)}
    assert bits == {"kMahaOffSplit": 1, "kMahaOffSmall": 2, "kMahaOffCopies": 4, "kMahaOffMma": 8}
    assert "#define PMC_MAHA_OFF 0" in text
    assert sorted(chip_smoke.MAHA_OFF.values()) == [0, 1, 2, 3, 4, 8]
    assert chip_smoke.MAHA_OFF["big only, no split"] == bits["kMahaOffSmall"] | bits["kMahaOffSplit"]
    assert "-DPMC_MAHA_OFF" not in " ".join(_build.NVCC_FLAGS)
