"""fused_maha's tensor-core kernel (``csrc/mma.cuh``, ``maha_mma_kernel``,
D <= 64) on the CPU: a numpy mirror of its arithmetic -- x - m_k formed in
float32, both operands split into TF32 words (``cvt.rn``: round to nearest,
ties to even, on the 13 dropped mantissa bits), three products a depth step of
8 coordinates (hi hi into one float32 accumulator, hi lo and lo hi into
another), added, squared -- against the float64 plain version under
``chip_smoke.TOL["maha"]``, with lower, upper and full operands, at the
DMAX 32 and 40 and 64 instantiations' shapes and the JAX rule's largest K;
a one-product (1xTF32) mirror misses the same bound; the mirror against the
JAX package's ``fused_maha`` (Pallas, interpret mode); the plan's and the
election's mirrors in ``ops/_build.py`` against the constants of the CUDA
sources.  The kernel itself runs only on the card
(``tests/test_torch_kernels_gpu.py -k maha``, ``chip_smoke.py``)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import pypmc_tpu.ops.pallas_kernels as pk
import pypmc_tpu_torch
from pypmc_tpu_torch.density import core
from pypmc_tpu_torch.ops import _build, kernels

torch.set_num_threads(1)

CSRC = Path(_build.__file__).resolve().parent.parent / "csrc"
N = 4099   # ragged: not a multiple of the kernel's 256- or 128-particle tiles
# the JAX rule's largest K at D (kernels.fits), as chip_smoke.MAHA_TIME_SHAPES
LARGEST_K = {17: 225, 20: 193, 40: 98, 64: 62}
# components a step of the mirrors (bounds their memory at the largest K)
CHUNK = 16


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless the CPU is asked for: ask for it."""
    with pypmc_tpu_torch.using_device("cpu"):
        yield


def tf32(v):
    """``cvt.rn.tf32.f32``: float32 v with its 13 low mantissa bits rounded
    off, to nearest, ties to even (on the magnitude's bits; finite v)."""
    bits = np.ascontiguousarray(v, dtype=np.float32).view(np.uint32)
    even = (bits >> np.uint32(13)) & np.uint32(1)
    return ((bits + np.uint32(0x0FFF) + even) & np.uint32(0xFFFFE000)).view(np.float32)


def split(v):
    """v = hi + lo, both TF32 (float32 arithmetic)."""
    hi = tf32(v)
    return hi, tf32(v.astype(np.float32) - hi)


def mirror_maha(xT, A, m, products=3):
    """``(K, N)`` as ``maha_mma_kernel`` computes it: D padded to 8 with
    zeros; per depth step s of 8 coordinates, each m16n8k8 product's 8 exact
    TF32 products summed and added to its float32 accumulator (one rounding
    an ``mma``), big = hi hi, small = hi lo, then lo hi (``products=1``:
    big alone, one TF32 product); y = big + small, its squares summed in
    float32.  Over chunks of :data:`CHUNK` components."""
    if A.shape[0] > CHUNK:
        return np.concatenate([mirror_maha(xT, A[k:k + CHUNK], m[k:k + CHUNK], products)
                               for k in range(0, A.shape[0], CHUNK)])
    K, D, _ = A.shape
    Dp = -(-D // 8) * 8
    Ap = np.zeros((K, Dp, Dp), np.float32)
    Ap[:, :D, :D] = A
    d = np.zeros((K, Dp, xT.shape[1]), np.float32)
    d[:, :D] = xT[None].astype(np.float32) - m[:, :, None].astype(np.float32)
    ah, al = split(Ap)
    dh, dl = split(d)
    big = np.zeros(d.shape, np.float32)
    small = np.zeros(d.shape, np.float32)
    for s in range(Dp // 8):
        j = slice(8 * s, 8 * s + 8)
        prod = lambda a, b: np.matmul(a[:, :, j].astype(np.float64), b[:, j].astype(np.float64))
        big = (big + prod(ah, dh)).astype(np.float32)
        if products == 3:
            small = (small + prod(ah, dl)).astype(np.float32)
            small = (small + prod(al, dh)).astype(np.float32)
    y = big + small
    return np.sum(y * y, axis=1, dtype=np.float32)


def operands(K, D, kind, seed):
    """float32 ``(xT (D, N), A (K, D, D), m (K, D))``: A lower (an inverse
    Cholesky factor), upper (a VB operand, ``chol(Sigma^-1)^T``) or full
    (normal entries); particles drawn around the centres, 1.5 covariance
    widths out."""
    rng = np.random.default_rng(seed)
    B = rng.normal(0, 1, (K, D, D)) / np.sqrt(D)
    cov = B @ B.transpose(0, 2, 1) + 0.3 * np.eye(D)
    L = np.linalg.cholesky(cov)
    m = rng.normal(0, 3, (K, D))
    if kind == "lower":
        A = np.linalg.inv(L)
    elif kind == "upper":
        A = np.linalg.cholesky(np.linalg.inv(cov)).transpose(0, 2, 1)
    else:
        A = rng.normal(0, 1, (K, D, D))
    comp = rng.integers(0, K, N)
    z = rng.normal(0, 1, (N, D))
    x = np.empty((N, D))
    for k in range(K):
        at = comp == k
        x[at] = m[k] + 1.5 * z[at] @ L[k].T
    return np.ascontiguousarray(x.T, np.float32), A.astype(np.float32), m.astype(np.float32)


def maha_error(got, xT, A, m):
    """``(max |got - plain|, TOL["maha"]'s bound)`` against the float64
    plain version on the same float32 inputs (over chunks of :data:`CHUNK`
    components)."""
    f64 = lambda v: torch.tensor(v, dtype=torch.float64)
    ref = np.concatenate([kernels.plain_maha(f64(xT), f64(A[k:k + CHUNK]), f64(m[k:k + CHUNK])).numpy()
                          for k in range(0, A.shape[0], CHUNK)])
    atol, rtol = chip_smoke.TOL["maha"]
    return float(np.abs(got.astype(np.float64) - ref).max()), atol + rtol * float(np.abs(ref).max())


@pytest.mark.parametrize("kind", ["lower", "upper", "full"])
@pytest.mark.parametrize("D,K", [(D, K) for D in (17, 20, 40, 64) for K in (1, 4, LARGEST_K[D])])
def test_three_tf32_products_are_within_the_maha_tolerance(D, K, kind):
    """The kernel's 3xTF32 arithmetic is within TOL["maha"] of float64 with
    a margin: the dropped lo lo term and the splits' roundings are ~2^-21
    of a product."""
    assert chip_smoke.TOL["maha"] == (1e-5, 1e-5)
    xT, A, m = operands(K, D, kind, K * 100 + D)
    if kind == "lower":
        assert np.all(np.triu(A, 1) == 0)
    err, bound = maha_error(mirror_maha(xT, A, m), xT, A, m)
    assert err <= bound / 4, (err, bound)


@pytest.mark.parametrize("D,K", [(17, 225), (40, 32), (40, 98), (64, 62)])
def test_one_tf32_product_misses_the_maha_tolerance(D, K):
    """The negative control: one TF32 product (~2^-11 of a product) is
    outside the same bound, by more than 10x."""
    xT, A, m = operands(K, D, "upper", K * 100 + D)
    err, bound = maha_error(mirror_maha(xT, A, m, products=1), xT, A, m)
    assert err > 10 * bound, (err, bound)


def test_the_mirror_matches_the_pallas_kernel(monkeypatch):
    """The mirror against the JAX package's fused_maha (its Pallas kernel
    in interpret mode, three split bf16 products) on the same inputs,
    within TOL["maha"]'s bound of each other."""
    monkeypatch.setattr(pk, "INTERPRET", True)
    K, D = 4, 20
    xT, A, m = operands(K, D, "upper", 7)
    xT = xT[:, :1500]
    ref = np.asarray(pk.fused_maha(jnp.asarray(xT), jnp.asarray(A.reshape(K * D, D)),
                                   jnp.asarray(np.einsum("kij,kj->ki", A, m).reshape(K * D, 1)),
                                   jnp.asarray(m.mean(0)), dim=D))
    got = mirror_maha(xT, A, m)
    atol, rtol = chip_smoke.TOL["maha"]
    assert np.abs(got - ref).max() <= atol + rtol * np.abs(ref).max()


def test_tf32_rounds_to_nearest_ties_to_even():
    """cvt.rn on hand-worked words: below and above a tie, ties to the even
    word in magnitude (down, then up), a carry into the exponent,
    infinities kept."""
    words = np.array([0x3F800FFF, 0x3F801000, 0x3F801001, 0x3F803000, 0xBF803000, 0x3FFFF000,
                      0x7F800000], np.uint32)
    want = np.array([0x3F800000, 0x3F800000, 0x3F802000, 0x3F804000, 0xBF804000, 0x40000000,
                     0x7F800000], np.uint32)
    assert np.array_equal(tf32(words.view(np.float32)).view(np.uint32), want)
    v = np.float32([np.pi, -1e-30, 3e38, 1.0 / 3.0])
    hi, lo = split(v)
    assert np.all(tf32(hi) == hi) and np.all(tf32(lo) == lo)
    assert np.all(np.abs(hi.astype(np.float64) + lo - v) <= 2.0 ** -22 * np.abs(v))


def _cuh_int(name, path):
    """The value of ``constexpr int name = ...;`` in a CUDA source."""
    return int(re.search(r"constexpr int %s = (\d+);" % name, (CSRC / path).read_text()).group(1))


def test_the_election_mirrors_the_cuda_source():
    """_build.MAHA_MMA_D_MIN is csrc/mma.cuh kMahaMmaDMin, the first D of a
    record instantiation (csrc/common.cuh EvalInsts', _build's), so the
    election takes whole timed buckets; fused_maha elects the tensor-core
    kernel from it at every D (past D = 64 csrc/mma_tiled.cuh's), the record
    kernel below it, and never the tiled kernel; fused_logq and fused_rho
    elect their record kernels to D = 64 and their own tensor-core kernels
    (csrc/mma_tiled.cuh's walk on U's lower triangle) from kTiledDMin."""
    assert _build.MAHA_MMA_D_MIN == _cuh_int("kMahaMmaDMin", "mma.cuh") == 9
    assert _build.MAHA_MMA_D_MIN - 1 in _build._EVAL_DMAX
    insts = re.search(r"using EvalInsts = EvalList<(.*?)>;", (CSRC / "common.cuh").read_text(),
                      re.S).group(1)
    assert _build._EVAL_DMAX == tuple(
        int(d) if d.isdigit() else 64 for d in re.findall(r"EvalInst<(\w+),", insts))
    assert _cuh_int("kTiledDMin", "tiled.cuh") == _build.TILED_D_MIN
    below = 0
    for dmax in _build._EVAL_DMAX:
        for D in range(below + 1, dmax + 1):
            want = "mma" if D >= _build.MAHA_MMA_D_MIN else "rec"
            assert _build.eval_variant("fused_maha", D) == want, D
            assert _build.eval_variant("fused_logq", D) == _build.eval_variant("fused_rho", D) \
                == "rec"
        below = dmax
    assert all(_build.eval_variant("fused_maha", D) == "mma" for D in (65, 200, 2040, 4096))
    assert all(_build.eval_variant(k, D) == "mma" for k in ("fused_logq", "fused_rho")
               for D in (65, 200, 4096))
    # csrc/tiled.cuh maha_variant: the tensor-core kernel from kMahaMmaDMin,
    # with no upper bound on D
    assert re.search(r"inline int maha_variant\(int D\) \{ return D >= kMahaMmaDMin \? kEvalMma : "
                     r"eval_variant\(D\); \}", (CSRC / "tiled.cuh").read_text())


def test_the_plan_mirror():
    """_build.mma_plan against hand-worked plans of csrc/mma.cuh mma_plan:
    a tile of 8 warps (6 past D = 24) of two 16-particle m-tiles (one past
    D = 40); x at D padded to 8; each component its VB record and its split
    record (A's rows as Dp / 2 float4s, made 4 mod 8, and m's pairs); in
    half an SM, all components beside two x tiles where they fit, else
    chunks beside one; the rule's every K within it."""
    vb = lambda D: _build._rec_floats(D, vb=True)
    assert (vb(40), vb(17), vb(64)) == (1644, 364, 4164)
    # D=40: Dp 40, a row 20 float4s; 6 warps of 32 particles, 40 x 192 x 4 B
    # of x; 19,536 B a component: one fits beside two x tiles, 32 in chunks
    # of 4 beside one
    assert _build.mma_plan(32, 40) == (4, 8, 1, 192, 3240, 30720 + 4 * 19536)
    assert _build.mma_plan(1, 40) == (1, 1, 2, 192, 3240, 2 * 30720 + 19536)
    # D=17: Dp 24, a row 12 float4s, 8 warps; 6,160 B a component, 14 beside
    # the tile
    assert _build.mma_plan(225, 17) == (14, 17, 1, 256, 24 * 12 * 4 + 24, 24576 + 14 * 6160)
    # D=64: Dp 64, a row 36 float4s (32 is 0 mod 8), 6 warps of 16 particles
    assert _build.mma_plan(62, 64) == (1, 62, 1, 96, 64 * 36 * 4 + 64, 24576 + 53776)
    assert _build.mma_plan(1, 8) == (1, 1, 2, 256, 8 * 4 * 4 + 8, 2 * 8192 + 4 * (76 + 136))
    assert [_build.eval_threads(D, "mma") for D in (8, 24, 25, 64)] == [256, 256, 192, 192]
    for D in range(1, 65):
        K = max(K for K in range(1, 3000) if kernels.fits("fused_maha", K, D))
        for k in (1, K):
            kc, n_chunks, x_buffers, tile, _, smem = _build.mma_plan(k, D)
            assert kc * n_chunks >= k > kc * (n_chunks - 1)
            assert x_buffers == 1 or n_chunks == 1
            assert smem <= _build._HALF_SMEM
            assert tile == _build.block_particles("fused_maha", D, "mma")
            assert _build.eval_plan("fused_maha", k, D, "mma")[::2] == (kc, smem)
            _build.check_limits("fused_maha", k, D)


@pytest.mark.parametrize("kernel,D", [("fused_logq", 10), ("fused_logq", 64), ("fused_rho", 10),
                                      ("fused_rho", 40), ("fused_maha", 65),
                                      ("fused_maha", 200)])
def test_the_mma_variant_raises_where_there_is_none(kernel, D):
    """variant="mma" names fused_maha's tensor-core kernel, at every D:
    fused_logq and fused_rho have none (ValueError naming the plan, on the
    CPU too); past D = 64 fused_maha has it and the tiled kernel, and there
    its record kernel is the variant that raises, as every variant a shape
    lacks does."""
    rng = np.random.default_rng(D)
    xT = torch.tensor(rng.normal(0, 1, (D, 33)), dtype=torch.float32)
    if kernel == "fused_maha":
        a, m = torch.eye(D).expand(3, D, D).contiguous(), torch.zeros(3, D)
        assert kernels._elect(kernel, 3, D, "mma") == "mma" == kernels._elect(kernel, 3, D, None)
        assert kernels._eval_variants(kernel, D) == ("tiled", "mma")
        # the CPU computes the plain version for every variant the shape has
        for variant in ("mma", "tiled"):
            assert torch.equal(kernels.fused_maha(xT, a, m, variant=variant),
                               kernels.plain_maha(xT, a, m))
        with pytest.raises(ValueError, match="the plan"):
            kernels._elect(kernel, 3, D, "rec")
        with pytest.raises(ValueError, match="the plan"):
            kernels.fused_maha(xT, a, m, variant="rec")
        return
    with pytest.raises(ValueError, match="the plan"):
        kernels._elect(kernel, 3, D, "mma")
    if kernel != "fused_rho":
        with pytest.raises(ValueError, match="the plan"):
            params = chip_smoke.make_params(chip_smoke.random_mixture(rng, 3, D, False),
                                            torch.device("cpu"))
            kernels.fused_logq(xT, core._kernel_operands(params), variant="mma")
    assert kernels._elect("fused_maha", 3, D, "mma") == "mma"


@pytest.mark.parametrize("K,D,N_,by", [(10, 10, 1 << 22, "bytes"), (225, 17, 1 << 20, "operations"),
                                       (193, 20, 1 << 20, "operations"),
                                       (32, 40, 1 << 20, "operations")])
def test_the_tensor_core_bound_counts_the_work_at_d(K, D, N_, by):
    """chip_smoke.bound_tc: the larger of the bytes (each input read once,
    the output written once) and the three split TF32 products at D, not D
    padded to 8 (the padding's zero products are the kernel's cost); at
    K=32, D=40, 2^20, 322 GFLOP at 495 TFLOP/s, 0.65 ms."""
    shape = (K, 0, D, N_)
    _, ms, bound_by = chip_smoke.bound_tc("fused_maha", shape)
    t_bytes = 4 * (D + K) * N_ / chip_smoke.PEAK_BYTES * 1e3
    t_ops = 3 * 2 * K * D * D * N_ / 495e12 * 1e3
    assert ms == pytest.approx(max(t_bytes, t_ops), rel=1e-12) and bound_by == by
    assert ms <= chip_smoke.bound("fused_maha", shape)[1]
    if (K, D) == (32, 40):
        assert ms == pytest.approx(0.6508, abs=1e-4)
