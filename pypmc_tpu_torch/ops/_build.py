"""Build and load the CUDA kernels of ``pypmc_tpu_torch/csrc``.

The kernels are plain-C entry points compiled by ``nvcc`` for ``sm_90a``
and linked into one shared library, loaded with ``ctypes``.  Each source is
compiled by its own ``nvcc``, all started together.  The library is built
at first use into ``build/`` beside the package, under a name keyed by a
hash of the sources and flags, so a changed source is rebuilt and an
unchanged one is loaded as it is.

This module also states the CUDA kernels' own size limits, kernel by
kernel (:data:`D_MAX`).  A thread kernel keeps one particle's coordinates
in a per-thread array of at most 128 floats (registers up to D = 32, and up
to D = 64 in the record kernels of ``fused_logq``, ``fused_rho``,
``fused_maha``, ``fused_transform``, ``fused_transform_rng`` and
``fused_propose_logq``; local memory above).  The six kernels of
:data:`WIDE` take D up to :data:`WIDE_D_MAX` on the block-tiled product
engine of ``csrc/tiled.cuh`` or the tensor-core walk of
``csrc/mma_tiled.cuh``: ``fused_logq``, ``fused_maha`` and
``fused_rho`` from D = :data:`TILED_D_MIN` elect the tensor-core walk
(:func:`eval_variant`, :func:`mma_tiled_plan`, :func:`mma_tile_panels`,
:func:`mma_scratch_floats`), the tiled kernel forcible beside it
(:func:`tiled_plan`),
``fused_transform`` from D =
:data:`TRANSFORM_TILED_D_MIN` (at K > 1 after a counting sort of its
particles by component over all N and a move of z into that order, and x
moved out of it after: :func:`transform_plan`, :func:`transform_bucket_plan`,
:func:`transform_layout`, :func:`transform_tiles`,
:func:`transform_permute`), ``fused_transform_rng`` and
``fused_propose_logq`` from D = :data:`DRAW_TILED_D_MIN` with their normals
drawn in shared memory (:func:`draw_tiled_smem`; the same sort at K > 1;
``fused_propose_logq``
then evaluates with ``fused_logq``'s elected kernel).  The dense
statistics kernels keep a tile of per-particle rows and their accumulators
in shared memory, which must fit :data:`SMEM_LIMIT`: up to D = 16 the
register pass's tile of 64 columns and all K components' records
(:func:`dense_plan`); from D = 17 where K D <= 128 the Gram pass of all
three, the K components' U (VB: A) stacked, a tile of 64 particles, its
whitened differences and float64 accumulators
(:func:`gram_layout`); elsewhere the entry-table pass's tile of 128
particles, or of 64 where that does not fit (:func:`stats_tile`); the
entry-table kernels stage their mixture operands there too when they fit
beside, and otherwise read them from device memory.  The record kernels of
the draws stage each component's mean and lower triangle where they fit
half an SM (``fused_propose_logq``'s also both mixtures' evaluation
records), and otherwise read them from device memory
(:func:`transform_plan`, :func:`propose_plan`); so do those of
``fused_draw_transform`` and ``fused_draw_transform_rng``, with the K
thresholds and dofs after the records (:func:`draw_transform_plan`), which
exist to D = 64 only.  The K-blocked kernels walk the components in
chunks sized from shared memory (:func:`blocked_plan`), and so do the
record kernels up to D = 64 (:func:`eval_plan`), so only D limits them.
:func:`limit_reason` names the limit a shape breaks, and the wrappers raise
for such a shape.  Which shapes the ``"auto"`` dispatchers send to a kernel
at all is a separate question, answered by
:func:`pypmc_tpu_torch.ops.kernels.fits`.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["D_MAX", "WIDE_D_MAX", "SMEM_LIMIT", "THREADS", "EVAL_THREADS",
           "DRAW_THREADS", "TILED_D_MIN", "TRANSFORM_TILED_D_MIN", "DRAW_TILED_D_MIN",
           "draw_tiled_smem",
           "KERNELS", "BLOCKED", "WIDE", "TILED", "smem_bytes", "eval_plan", "eval_threads",
           "eval_variant", "MAHA_MMA_D_MIN", "mma_plan", "mma_tiled_plan",
           "mma_scratch_floats", "mma_tile_panels", "tiled_plan", "transform_bucket_plan",
           "transform_bucket_blocks", "transform_slots", "transform_width", "transform_layout",
           "transform_scratch_words", "transform_tiles", "transform_permute",
           "block_particles", "stats_tile", "dense_plan", "gram_layout", "transform_plan",
           "propose_plan", "draw_plan", "DRAWS", "draw_transform_plan", "pool_variant",
           "pool_smem_bytes", "blocked_plan", "draw_smem_bytes", "limit_reason",
           "check_limits", "load", "build_info", "signatures"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_THREAD_D_MAX = 128    # csrc/common.cuh kDMax: per-thread arrays of 8, 16, 32 (40, 64) or 128
WIDE_D_MAX = 4096      # csrc/common.cuh kWideDMax: the tiled kernels' largest D
SMEM_LIMIT = 232448    # csrc/common.cuh kSmemLimit: shared memory one H100 block may use
THREADS = 128          # csrc/common.cuh kThreads
EVAL_THREADS = 256     # csrc/common.cuh kEvalThreads: the record kernels' (D <= 64)
DRAW_THREADS = 256     # csrc/draw.cu kDrawThreads: the proposal inputs' draw, a thread a particle
_REC_D_MAX = 64        # csrc/common.cuh kRecDMax
_EVAL_DMAX = (8, 16, 32, 40, 64)   # csrc/common.cuh EvalInsts: the record instantiations
# csrc/tiled.cuh: the tiled kernels' particles a tile, rows a row tile, depth
# of a panel, threads a block, and A panels' row stride (kTileP, kTileM,
# kTileK, kTileThreads, kTileStride)
_TILE_P, _TILE_M, _TILE_K, _TILE_THREADS, _TILE_STRIDE = 128, 128, 16, 256, 132
# csrc/tiled.cuh kTiledDMin: the smallest D past the record kernels of
# fused_logq and fused_rho (the first past their 64, where the tiled kernel
# beat the looped kernel it replaced at D = 65, 96 and 128, PERF.md); from
# it they elect their tensor-core kernels ("mma", csrc/mma_tiled.cuh's walk
# on U's lower triangle), the tiled kernel forcible
TILED_D_MIN = 65
# csrc/mma.cuh kMahaMmaDMin: the smallest D at which fused_maha elects its
# tensor-core kernel (variant "mma"): over the record kernel to D = 64 (in
# the record instantiations from DMAX 16 its device time beat the record
# kernel's at every K timed there, in one call), over the tiled kernel past
# it (chip_smoke.py --maha-times, PERF.md)
MAHA_MMA_D_MIN = 9
# csrc/mma_tiled.cuh: fused_maha's tensor-core kernel past D = 64: particles
# a tile, rows a row tile, depth of a panel, threads a block, step buffers
# (kMtP, kMtM, kMtK, kMtThreads, kMtStages), an X panel's row stride in
# floats and an A panel's in float4s (kMtXStride, kMtARow4)
_MT_P, _MT_M, _MT_K, _MT_THREADS, _MT_STAGES = 128, 128, 32, 256, 3
_MT_X_STRIDE, _MT_A_ROW4 = 136, 20
# csrc/transform.cu kTransformTiledDMin: the smallest D at which
# fused_transform elects its tiled pair (at K > 1 the bucket pass and the
# moves into and out of bucket order around the tiled product), below it the looped kernel from D = 65 and the record kernel to
# 64: the first D past 64 at which the pair beat the looped kernel at the
# shapes timed (PERF.md)
TRANSFORM_TILED_D_MIN = 65
# csrc/tiled.cuh kDrawTiledDMin: the smallest D at which fused_transform_rng
# and fused_propose_logq elect their drawn tiled products (the looped kernel
# stays forcible to D = 128): the first past the record kernels' 64, where
# the drawn products beat the looped kernels at the shapes timed (PERF.md)
DRAW_TILED_D_MIN = 65
# csrc/tiled.cuh kDrawCachePanels: the panels of row tile 0 a drawn product
# keeps past D = 128, so that D <= 256 draws each normal once
_DRAW_CACHE_PANELS = 8
# csrc/tiled.cuh: the bucket pass's threads a block, particles a thread at
# least and blocks of a launch at most (kBucketThreads, kBucketItemsMin,
# kBucketBlocksMax); the moves' particles a tile and rows a block (kPermTile,
# kPermRows)
_BUCKET_THREADS, _BUCKET_ITEMS_MIN, _BUCKET_BLOCKS_MAX = 256, 2, 512
_PERM_TILE, _PERM_ROWS = 2048, 4

_lib = None
build_info = {}


def _eval_floats(K, D):
    """Floats of a packed mixture's evaluation part (``MixLayout::L()``)."""
    return K * D + K * D * D + 4 * K


def _full_floats(K, D):
    """Floats of a whole packed mixture (``MixLayout::size()``)."""
    return _eval_floats(K, D) + K * D * D + K


BLOCKED = ("fused_pmc_stats_blocked", "fused_vb_estep_blocked",
           "fused_is_pmc_step_blocked")
KERNELS = ("fused_logq", "fused_propose_logq", "fused_pmc_stats",
           "fused_is_pmc_step", "fused_maha", "fused_rho", "fused_vb_estep",
           "fused_transform", "fused_transform_rng", "fused_mcmc_pool") + BLOCKED
# the kernels that take D past 128, all by the tiled engine (csrc/tiled.cuh):
# those of TILED with their given operands, fused_transform_rng and
# fused_propose_logq on normals drawn in shared memory
WIDE = ("fused_logq", "fused_rho", "fused_maha", "fused_transform", "fused_transform_rng",
        "fused_propose_logq")
# the kernels with a block-tiled product kernel (csrc/tiled.cuh)
TILED = ("fused_logq", "fused_maha", "fused_rho", "fused_transform")
# the draws: a record and a looped kernel each, and a tiled product
# (fused_transform: the tiled pair on given normals; transform_plan,
# propose_plan)
DRAWS = ("fused_transform", "fused_transform_rng", "fused_propose_logq")
# each kernel's largest D: the tiled kernels' past D = 128, the thread
# kernels' elsewhere (at least the JAX package's rule's reach: D = 2,040 at
# K = 1 for the 128-particle tile, 248 for the 1024-particle one; K*D <= 128
# for the dense statistics kernels; below 128 for the K-blocked ones and
# the pool)
D_MAX = {kernel: WIDE_D_MAX if kernel in WIDE else _THREAD_D_MAX for kernel in KERNELS}
# csrc/mcmc_pool.cu: the warp variant's largest D, and pool_warp_chains, its
# largest pool by the thread variant's instantiation (the largest D of each,
# the chains): where the two variants' times cross on the H100 (pool_sweep.py)
_POOL_WARP_D_MAX = 64
_POOL_WARP_CHAINS = ((8, 0), (16, 4096), (32, 8192), (40, 32768), (_POOL_WARP_D_MAX, 1 << 62))
_HALF_SMEM = 228 * 1024 // 2 - 1024   # csrc/common.cuh kHalfSmem
# the dense statistics kernels (csrc/stats.cuh) and the largest D of their
# 64-particle tile (kNarrowTileDMax); each has a register pass, in the mode
# of csrc/reg_stats.cuh DenseMode
_STATS = ("fused_pmc_stats", "fused_is_pmc_step", "fused_vb_estep")
_DENSE = ("fused_is_pmc_step", "fused_vb_estep", "fused_pmc_stats")
_NARROW_TILE_D_MAX = 8
# csrc/reg_stats.cuh: the register statistics pass (D <= 16): its tile's
# columns, the K-blocked pass's slices (the dense kernels' fewest), the
# last row of band 0
_REG_DMAX, _REG_COLS, _REG_SLICES, _REG_SPLIT = 16, 64, 8, 10
# csrc/gram_stats.cuh: the Gram statistics pass of the three dense kernels
# (one kernel, a mode each), from D = 17 (kGramDMin) to 128 where K D <= 128
# (kGramKD, the JAX rule's bound): its particles a tile and threads a block
# (kGramP, kGramThreads)
_GRAM_D_MIN, _GRAM_KD, _GRAM_P, _GRAM_THREADS = 17, 128, 64, 256


def _pad4(n):
    return (n + 3) // 4 * 4


def _rec_floats(D, vb=False):
    """Floats of one 16-byte component record (``csrc/common.cuh``
    ``rec_floats``, ``vb_rec_floats``): mu | 4 scalars | U's rows, row i
    padded to ``_pad4(i + 1)`` (VB: m | c and 3 zeros | A's rows, each padded
    to ``_pad4(D)``)."""
    q, r = D // 4, D % 4
    rows = D * _pad4(D) if vb else 4 * (q + 1) * (2 * q + r)
    return _pad4(D) + 4 + rows


def _reg_per_group(D, S):
    """Components a group of the register pass's pairs at S slices
    (``reg_per_group``): the block's 128 / S pairs in one band (D <= 10),
    a warp's 32 / S in each of three (11 <= D <= 16)."""
    return (THREADS if D <= _REG_SPLIT else 32) // S


def _reg_stride(D, S=_REG_SLICES):
    """Tile row stride of the register pass (``reg_stride``): (D + 3) | 1
    rows a component times the stride is S (mod 32)."""
    rb = (D + 3) | 1
    inv = next(x for x in range(1, 32, 2) if rb * x % 32 == 1)
    return _REG_COLS + S * inv % 32


def _reg_region(K, D, S, groups):
    """Floats of the register pass's tile of K components and the flush's
    scratch (S slices of K P entries and the global sums' 3 x 64): one
    region where the accumulators stay in registers (one group), the two
    side by side where the scratch holds running sums."""
    P = 3 + D + D * (D + 1) // 2
    tile = K * ((D + 3) | 1) * _reg_stride(D, S)
    scratch = S * K * P + 3 * _REG_COLS
    return max(tile, scratch) if groups == 1 else tile + scratch


def _reg_bytes(kc, D, vb):
    """``reg_smem_bytes``: kc records, the tile (or, where larger, the
    flush's scratch) and the float64 accumulators."""
    P = 3 + D + D * (D + 1) // 2
    offset = (4 * (kc * _rec_floats(D, vb) + _reg_region(kc, D, _REG_SLICES, 1)) + 7) // 8 * 8
    return offset + 8 * (kc * P + 3)


def _dense_slices(K, D):
    """The register pass's column slices for K components (``dense_slices``):
    as many as leave the block's pairs one group, at least 8; one band
    takes 128 // K, at most 64, three bands 8, 16 or 32 (a warp a band)."""
    if D <= _REG_SPLIT:
        return min(max(THREADS // K, _REG_SLICES), _REG_COLS)
    S = _REG_SLICES
    while S < 32 and K <= _reg_per_group(D, 2 * S):
        S *= 2
    return S


def _dense_reg_bytes(kernel, K, Kt, D, S, groups):
    """``DenseLayout::smem`` of ``kernel``'s register pass: the records (VB's;
    the step: the proposal's, the target's and the K thresholds; the
    statistics: the proposal's), the staging of a round of 128 particles
    (D + 1 rows), the tile and scratch, the float64 accumulators."""
    P = 3 + D + D * (D + 1) // 2
    recs = K * _rec_floats(D, kernel == "fused_vb_estep")
    if kernel == "fused_is_pmc_step":
        recs += Kt * _rec_floats(D) + K
    floats = recs + (D + 1) * THREADS + _reg_region(K, D, S, groups)
    return (4 * floats + 7) // 8 * 8 + 8 * (K * P + 3)


def _blocked_floats(kernel, D):
    """Operand floats of one component in the K-blocked kernels' chunk
    layout (``csrc/blocked.cuh`` ``blocked_floats``)."""
    return D * D + D + 1 if kernel == "fused_vb_estep_blocked" else _eval_floats(1, D)


def _operand_floats(kernel, K, D, Kt):
    """Floats of the mixture operands one block of ``kernel`` reads (for a
    K-blocked kernel, one chunk's; for the record kernels of ``fused_logq``,
    ``fused_rho`` and ``fused_maha`` up to D = 64, its buffers of records)."""
    if kernel in BLOCKED:
        return blocked_plan(kernel, K, D)[0] * _blocked_floats(kernel, D)
    if kernel in ("fused_logq", "fused_rho", "fused_maha") and D <= _REC_D_MAX:
        kc, buffers, _ = eval_plan(kernel, K, D)
        return buffers * kc * _rec_floats(D, vb=kernel == "fused_maha")
    if kernel in ("fused_logq", "fused_rho", "fused_pmc_stats"):
        return _eval_floats(K, D)
    if kernel == "fused_maha":
        return K * D * D + K * D                 # A | m
    if kernel in ("fused_propose_logq", "fused_is_pmc_step"):
        return _full_floats(K, D) + _eval_floats(Kt, D)
    if kernel == "fused_vb_estep":
        return K * D * D + K * D + K             # A | m | c
    if kernel in ("fused_transform", "fused_transform_rng"):
        return K * D * (D + 1) + K               # mu | L | dof
    if kernel == "fused_mcmc_pool":
        return _eval_floats(K, D)                # the target's (K components)
    raise ValueError("unknown kernel %r" % kernel)


def _stats_bytes(K, D, params, tile=THREADS):
    """``csrc/stats.cuh`` ``stats_smem_bytes``: ``params`` operand floats,
    the tile of ``tile`` particles (rows ``tile + 1`` floats apart) and the
    accumulators with their entry table."""
    rows = K * D + 3 * K + 3
    entries = K * (3 + D + D * (D + 1) // 2) + 3
    acc_offset = (4 * (params + rows * (tile + 1)) + 7) // 8 * 8
    return acc_offset + entries * (8 + 3 * 2)


def stats_tile(K, D):
    """Particles a tile (threads a block) of the dense statistics kernels
    (``fused_pmc_stats``, ``fused_is_pmc_step``, ``fused_vb_estep``) for
    (K, D); mirrors ``csrc/stats.cuh`` ``stats_layout``: 128, or 64 where the
    128-particle tile and the accumulators alone pass :data:`SMEM_LIMIT`
    (D = 1 with K >= 109: 4K + 3 rows).  The 64-particle kernels are built
    to D = :data:`_NARROW_TILE_D_MAX` (the JAX rule sends them D = 1 only);
    :func:`limit_reason` refuses the tile past it."""
    return THREADS if _stats_bytes(K, D, 0) <= SMEM_LIMIT else THREADS // 2


def gram_layout(K, D):
    """``(slices, blocks, shared memory a block)`` of the Gram statistics
    pass for (K, D) (``csrc/gram_stats.cuh`` ``GramLayout``): D rounded up
    to 8 (Dp) rows a component, R = K Dp stacked; phase C's lower 8 x 8
    blocks of the K triangles, K n (n + 1) / 2 with n = Dp / 8, and column
    slices the largest power of two to 32 with slices x blocks <= 256;
    shared memory for U stacked and transposed (D x R floats), the means
    (R), the tile of 64 particles (D x 64), the whitened differences (64
    rows of R rounded up to 32, plus 4), the per-particle rows ((3 K + 3) x
    64), then the float64 accumulators, 72 a block (its 8 x 8 entries and,
    diagonal, 8 of sd) and 3 K + 3 scalars."""
    Dp = (D + 7) // 8 * 8
    R, n = K * Dp, Dp // 8
    blocks = K * n * (n + 1) // 2
    slices = 1
    while 2 * slices <= 32 and 2 * slices * blocks <= _GRAM_THREADS:
        slices *= 2
    dstride = (R + 31) // 32 * 32 + 4
    floats = D * R + R + D * _GRAM_P + _GRAM_P * dstride + (3 * K + 3) * _GRAM_P
    return slices, blocks, (4 * floats + 7) // 8 * 8 + 8 * (72 * blocks + 3 * K + 3)


def dense_plan(kernel, K, D, Kt=0):
    """``(pass, tile columns, column slices, component groups, shared memory
    a block)`` of ``fused_vb_estep``, ``fused_is_pmc_step`` (a Kt-component
    target) or ``fused_pmc_stats`` for (K, D); mirrors ``csrc/reg_stats.cuh``
    ``dense_plan``.  Up to D = 16, where it fits :data:`SMEM_LIMIT`,
    ``"reg"``: the register pass, 64 columns, the slices of
    :func:`_dense_slices` and as many groups as the K components need of the
    block's pairs; from D = 17 to 128 where K D <= 128 (the JAX rule's
    reach there), ``"gram"``: the Gram pass, 64 particles a tile, its
    slices and 8 x 8 blocks in place of the groups (:func:`gram_layout`);
    elsewhere ``"table"``: the entry-table pass, its tile of
    :func:`stats_tile` particles (slices and groups 0)."""
    if D <= _REG_DMAX:
        S = _dense_slices(K, D)
        groups = -(-K // _reg_per_group(D, S))
        smem = _dense_reg_bytes(kernel, K, Kt, D, S, groups)
        if smem <= SMEM_LIMIT:
            return "reg", _REG_COLS, S, groups, smem
    if _GRAM_D_MIN <= D <= _THREAD_D_MAX and K * D <= _GRAM_KD:
        slices, blocks, smem = gram_layout(K, D)
        if smem <= SMEM_LIMIT:
            return "gram", _GRAM_P, slices, blocks, smem
    return "table", stats_tile(K, D), 0, 0, _table_bytes(kernel, K, D, Kt)


def _table_bytes(kernel, K, D, Kt=0):
    """Shared memory of an entry-table kernel's block: its tile, and the
    operands in front where they fit beside."""
    tile = stats_tile(K, D)
    staged = _stats_bytes(K, D, _operand_floats(kernel, K, D, Kt), tile)
    return staged if staged <= SMEM_LIMIT else _stats_bytes(K, D, 0, tile)


def _transform_rec_floats(D):
    """Floats of one component's record in ``fused_transform``'s record
    kernel (``csrc/transform.cu`` ``transform_rec_floats``): mu | L's lower
    triangle by row, made odd, so that the components' words at one offset
    fall in distinct banks."""
    return (D + D * (D + 1) // 2) | 1


def _record_plan(D, rec_floats, ops_floats):
    """``csrc/common.cuh`` ``draw_plan``: up to D = 64 ``"rec"``, the record
    kernel, 256 threads, its ``rec_floats`` staged where they fit half an SM
    (two blocks), else read from device memory (no shared memory); past it
    ``"looped"``, the looped kernel, 128 threads, its ``ops_floats`` operands
    staged where they fit (which has a kernel to D = 128: the draws elect
    their tiled products past D = 64 first).  The record floats are 0 but in
    the record kernel."""
    if D > _REC_D_MAX:
        ops = 4 * ops_floats
        return "looped", ops <= SMEM_LIMIT, 0, THREADS, ops if ops <= SMEM_LIMIT else 0
    recs = 4 * rec_floats
    staged = recs <= _HALF_SMEM
    return "rec", staged, _transform_rec_floats(D), EVAL_THREADS, recs if staged else 0


def draw_tiled_smem(D):
    """Shared memory of a drawn product's block (``fused_transform_rng``'s
    and ``fused_propose_logq``'s tiled kernel) at D; mirrors
    ``csrc/tiled.cuh`` ``draw_tiled_smem``: the tiled engine's
    (:func:`tiled_plan`) and, past D = 128, row tile 0's panels, 8 of 16 x
    128 floats."""
    cache = 4 * _DRAW_CACHE_PANELS * _TILE_K * _TILE_P if D > _TILE_M else 0
    return tiled_plan()[4] + cache


def transform_plan(K, D, rng=False):
    """``(kernel, records staged, a record's floats, threads a block, shared
    memory a block)`` of ``fused_transform`` (``fused_transform_rng`` with
    ``rng``) for (K, D); mirrors ``csrc/transform.cu`` ``transform_plan``
    (:func:`_record_plan`): the record kernel stages each component's mean and
    lower triangle (``fused_transform_rng``'s also the K dofs), the looped
    kernel the operands ``mu | L | dof``; ``fused_transform`` from D =
    :data:`TRANSFORM_TILED_D_MIN` ``"tiled"``, its tiled pair, whose product
    kernel has the tiled engine's threads and shared memory
    (:func:`tiled_plan`; the bucket pass's and the moves',
    :func:`transform_bucket_plan`, where K > 1); ``fused_transform_rng`` from
    D = :data:`DRAW_TILED_D_MIN` ``"tiled"``, its drawn product
    (:func:`draw_tiled_smem`; the bucket pass first where K > 1)."""
    if D >= (DRAW_TILED_D_MIN if rng else TRANSFORM_TILED_D_MIN):
        return "tiled", False, 0, _TILE_THREADS, draw_tiled_smem(D) if rng else tiled_plan()[4]
    return _record_plan(D, K * (_transform_rec_floats(D) + int(rng)),
                        _operand_floats("fused_transform", K, D, 0))


def transform_bucket_plan(K):
    """``(threads a block, particles a thread at least, blocks of a launch
    at most, shared memory of its largest block)`` of the draws' bucket pass
    for K components; mirrors ``csrc/transform.cu``
    (``pmc_transform_bucket_plan``): each block counts a run of its threads'
    particles (:func:`transform_bucket_blocks`), a warp's count of each
    component and each component's total, start, first tile and first
    position in shared memory, beside the warps' partial column sums of the
    counts' table; or ``fused_transform``'s rank block (the order of its
    moves into and out of bucket order), a tile of 2,048 particles'
    positions and the tile's counts and least positions a component."""
    scatter = 4 * ((_BUCKET_THREADS // 32) * K + 4 * (K + 1) + 2 * _BUCKET_THREADS)
    rank = 4 * (_PERM_TILE + 2 * K)
    return _BUCKET_THREADS, _BUCKET_ITEMS_MIN, _BUCKET_BLOCKS_MAX, max(scatter, rank)


def _bucket_items(N):
    """Particles a thread of a bucket block (``csrc/tiled.cuh``
    ``bucket_items``): 2, or more where N needs more than 512 blocks."""
    per = _BUCKET_THREADS * _BUCKET_BLOCKS_MAX
    return max(_BUCKET_ITEMS_MIN, -(-N // per))


def transform_bucket_blocks(N):
    """The bucket pass's blocks for N particles (``bucket_blocks``): runs of
    256 threads' :func:`_bucket_items` particles, at least 512 particles a
    run and at most 512 runs."""
    run = _BUCKET_THREADS * _bucket_items(N)
    return -(-N // run)


def transform_slots(N, K):
    """The slots of the draws' tiled products for N particles at K > 1
    (``csrc/tiled.cuh`` ``bucket_slots``): a tile of up to 128 positions of
    one bucket each, at most one partial a bucket, ``ceil(N / 128) + K``;
    the product's grid walks them."""
    return 0 if N <= 0 else -(-N // _TILE_P) + K


def transform_width(N, K):
    """The positions of the bucket order (``bucket_width``): N padded to 4,
    and 4 a component, each bucket starting at a multiple of 4."""
    return -(-N // 4) * 4 + 4 * K


def transform_layout(N, K, D=0):
    """``(perm, pos, table, words, pair words, width, blocks)`` of the int32
    scratch for N particles and K components (``csrc/transform.cu``
    ``pmc_transform_layout``): the slots from word 0 (4 words each), then
    perm (:func:`transform_width`), pos (N padded to 4) and the counts'
    table (:func:`transform_bucket_blocks` x K, padded to 4), each at its
    word; the bucket pass's words; ``fused_transform``'s pair's at D, the
    scales in bucket order, its moves' rank and tpos (N each, padded to 4)
    and D rows of x in bucket order after them (``PairLayout``)."""
    width = transform_width(N, K)
    blocks = transform_bucket_blocks(N)
    perm = 4 * transform_slots(N, K)
    pos = perm + width
    table = pos + -(-N // 4) * 4
    words = table + -(-blocks * K // 4) * 4
    pair = words + width + 2 * (-(-N // 4) * 4) + D * width
    return perm, pos, table, words, pair, width, blocks


def transform_scratch_words(N, K, D):
    """int32 words of a draw's tiled product's scratch at K > 1 and D: the
    bucket pass's, then ``fused_transform``'s scales, the moves' order and x
    in bucket order (:func:`transform_layout`)."""
    return transform_layout(N, K, D)[4]


def transform_tiles(latent, K):
    """``(perm (transform_width(N, K),), slots (transform_slots(N, K), 4),
    pos (N,))``, int32 numpy arrays: what the bucket pass writes for the
    components ``latent`` (``csrc/tiled.cuh`` ``bucket_scatter_kernel``),
    mirrored.  The particles sorted by component over all N, each
    component's in their order, the components ascending, each bucket from
    a multiple of 4 positions: pos[n] is particle n's position (-1 for a
    latent outside [0, K), which is left out) and perm[pos[n]] = n (-1 at
    the pads); the slots hold the tiles ``(k, first position, length, 0)``,
    up to 128 of a bucket's positions each, the buckets ascending, then
    ``(-1, 0, 0, 0)``."""
    import numpy as np

    latent = np.asarray(latent).astype(np.int64).reshape(-1)
    N = latent.shape[0]
    ok = (latent >= 0) & (latent < K)
    counts = np.bincount(latent[ok], minlength=K)
    start = np.concatenate([[0], np.cumsum(-(-counts // 4) * 4)])
    perm = np.full(transform_width(N, K), -1, np.int32)
    pos = np.full(N, -1, np.int32)
    slots = np.zeros((transform_slots(N, K), 4), np.int32)
    slots[:, 0] = -1
    s = 0
    for k in range(K):
        members = np.flatnonzero(latent == k)
        at = start[k] + np.arange(members.shape[0])
        perm[at] = members
        pos[members] = at
        for j in range(0, int(counts[k]), _TILE_P):
            slots[s] = (k, start[k] + j, min(_TILE_P, int(counts[k]) - j), 0)
            s += 1
    return perm, slots, pos


def transform_permute(src, pos, width, inverse=False):
    """``fused_transform``'s moves (``bucket_permute_kernel``) on numpy
    rows: ``dst[:, pos[n]] = src[:, n]`` into D rows of ``width`` bucket
    positions (NaN where no particle lands), or with ``inverse`` ``dst[:, n]
    = src[:, pos[n]]`` (NaN where pos is -1), walked as the kernel walks
    them: tiles of 2,048 particles, each tile's particles in bucket order (a
    component's positions in a tile are consecutive), rows 4 a block, the
    bucket side written (or read) in that order.  Returns dst."""
    import numpy as np

    src = np.asarray(src)
    pos = np.asarray(pos)
    N = pos.shape[0]
    D = src.shape[0]
    dst = np.full((D, N if inverse else width), np.nan, src.dtype)
    for n0 in range(0, N, _PERM_TILE):
        tile = pos[n0:n0 + _PERM_TILE]
        live = np.flatnonzero(tile >= 0)
        order = live[np.argsort(tile[live], kind="stable")]
        at = tile[order]
        for j0 in range(0, D, _PERM_ROWS):
            rows = slice(j0, min(D, j0 + _PERM_ROWS))
            if inverse:
                dst[rows, n0 + order] = src[rows][:, at]
            else:
                dst[rows][:, at] = src[rows, n0 + order]
    return dst


def propose_plan(K, Kt, D):
    """The plan of ``fused_propose_logq`` for a (K, D) proposal and a
    Kt-component target (0: none), as :func:`transform_plan`'s; mirrors
    ``csrc/propose_logq.cu`` ``propose_plan`` (:func:`_record_plan`): the record
    kernel stages both mixtures' 16-byte evaluation records, the proposal's
    draw records and its K thresholds, the looped kernel the packed proposal
    and the target's evaluation part; from D = :data:`DRAW_TILED_D_MIN`
    ``"tiled"``, the tiled route (the bucket pass on the drawn components
    where K > 1, the drawn product, then ``fused_logq``'s tiled kernel for
    log q and log p), its product's threads and shared memory
    (:func:`draw_tiled_smem`)."""
    if D >= DRAW_TILED_D_MIN:
        return "tiled", False, 0, _TILE_THREADS, draw_tiled_smem(D)
    return _record_plan(D, (K + Kt) * _rec_floats(D) + K * (_transform_rec_floats(D) + 1),
                        _operand_floats("fused_propose_logq", K, D, Kt))


def draw_transform_plan(K, D):
    """The plan of ``fused_draw_transform`` and ``fused_draw_transform_rng``
    (propose_T's draw and transform in one launch) for (K, D), as
    :func:`transform_plan`'s; mirrors ``csrc/draw.cu`` ``draw_transform_plan``
    (:func:`_record_plan`): the record kernel stages each component's mean
    and lower triangle, then the K thresholds and the K dofs.  Only its
    ``"rec"`` plan (D <= 64) has a kernel."""
    return _record_plan(D, K * (_transform_rec_floats(D) + 2), 0)


def draw_plan(kernel, K, D, Kt=0):
    """The plan of one of the :data:`DRAWS` for (K, D) (and a Kt-component
    target): :func:`transform_plan` or :func:`propose_plan`."""
    if kernel == "fused_propose_logq":
        return propose_plan(K, Kt, D)
    return transform_plan(K, D, rng=kernel == "fused_transform_rng")


def pool_variant(C, D):
    """The variant of ``fused_mcmc_pool``'s kernel for C chains in D
    dimensions; mirrors ``csrc/mcmc_pool.cu`` ``pool_variant``: ``"warp"``
    (a warp a chain) up to :data:`_POOL_WARP_CHAINS` chains for D's thread
    instantiation (none to D = 8, 4096 to D = 16, 8192 to 32, 32768 to 40,
    any to 64), else ``"thread"``."""
    most = next((c for d, c in _POOL_WARP_CHAINS if D <= d), 0)
    return "warp" if C <= most else "thread"


def _eval_dmax(D):
    """The DMAX of the record instantiation for D (``csrc/common.cuh``
    ``eval_dmax_for``)."""
    return next(d for d in _EVAL_DMAX if D <= d)


def pool_smem_bytes(Kt, D, variant):
    """Shared memory of ``fused_mcmc_pool``'s block for a Kt-component
    target (``csrc/mcmc_pool.cu`` ``pmc_mcmc_pool_smem_bytes``).  The thread
    variant's record instantiation (D <= 64) stages the target's 16-byte
    records and, past DMAX 32, a column a thread for the state and one for
    the proposal; where that passes :data:`SMEM_LIMIT` (or D > 64) the
    looped kernel stages the packed evaluation operands where they fit.  The
    warp variant stages the target's records where they fit beside its three
    slices of D + 8 floats."""
    if variant == "thread":
        if D <= _REC_D_MAX:
            dmax = _eval_dmax(D)
            rec = 4 * (Kt * _rec_floats(D) + (2 * dmax * THREADS if dmax > 32 else 0))
            if rec <= SMEM_LIMIT:
                return rec
        ops = 4 * _eval_floats(Kt, D)
        return ops if ops <= SMEM_LIMIT else 0
    slices = 4 * 3 * (D + 8)
    staged = slices + 4 * Kt * _rec_floats(D)
    return staged if staged <= SMEM_LIMIT else slices


def blocked_plan(kernel, K, D):
    """``(components a chunk, operands staged in shared memory, shared
    memory a block)`` of a K-blocked kernel's statistics pass; mirrors
    ``csrc/blocked.cuh`` ``blocked_plan``.  Up to D = 16 the register pass
    takes 16 components a chunk (4 past D = 10, where a component's
    accumulators are split in three row bands), its operands always staged.
    Past D = 16 a chunk is as large as lets two blocks share an SM, or one
    block where one component needs more; the chunk's operands are staged
    where one component's fit beside the tile."""
    vb = kernel == "fused_vb_estep_blocked"
    if D <= _REG_DMAX:
        kc = min(K, _reg_per_group(D, _REG_SLICES))
        return kc, True, _reg_bytes(kc, D, vb)
    per = _blocked_floats(kernel, D)
    staged = _stats_bytes(1, D, per) <= SMEM_LIMIT
    f = per if staged else 0
    budget = _HALF_SMEM if _stats_bytes(1, D, f) <= _HALF_SMEM else SMEM_LIMIT
    kc = 1
    while kc < K and _stats_bytes(kc + 1, D, (kc + 1) * f) <= budget:
        kc += 1
    return kc, staged, _stats_bytes(kc, D, kc * f)


def tiled_plan():
    """``(particles a tile, rows a row tile, depth of a panel, threads a
    block, shared memory a block)`` of the tiled kernel of ``fused_logq``,
    ``fused_rho`` and ``fused_maha`` (forced only, the yardstick of their
    tensor-core kernels); mirrors ``csrc/tiled.cuh``: two A panels of ``_TILE_K``
    rows of ``_TILE_STRIDE`` floats, two X panels of ``_TILE_K`` x
    ``_TILE_P``, two m panels of ``_TILE_K`` and the partial sums of a
    component, 16 threads a particle column.  The same at every (K, D): a
    block walks the components and the row tiles, so only the work grows
    with them."""
    smem = 4 * (2 * _TILE_K * _TILE_STRIDE + 2 * _TILE_K * _TILE_P + 2 * _TILE_K + 16 * _TILE_P)
    return _TILE_P, _TILE_M, _TILE_K, _TILE_THREADS, smem


def eval_variant(kernel, D):
    """The kernel ``fused_logq``, ``fused_maha`` or ``fused_rho`` elects at
    dimension D; mirrors ``csrc/tiled.cuh`` ``eval_variant`` and
    ``maha_variant``: ``"rec"``, the record kernel, below
    :data:`TILED_D_MIN` and the tensor-core kernel, ``"mma"``, from it
    (``csrc/mma_tiled.cuh``'s walk, on U's lower triangle for
    ``fused_logq`` and ``fused_rho``); ``fused_maha``'s from
    :data:`MAHA_MMA_D_MIN` at every D (``csrc/mma.cuh``'s to D = 64).  The
    tiled kernel (``"tiled"``) is elected nowhere, forcible at every D."""
    if kernel == "fused_maha" and D >= MAHA_MMA_D_MIN:
        return "mma"
    return "mma" if D >= TILED_D_MIN else "rec"


def _mma_warps(D):
    """Warps a block of ``fused_maha``'s tensor-core kernel
    (``csrc/mma.cuh`` ``mma_warps``): 8 to D = 24, 6 past it."""
    return 8 if D <= 24 else 6


def mma_plan(K, D):
    """``(components a chunk, chunks, x tiles, particles a block tile,
    floats of a split component, shared memory a block)`` of
    ``fused_maha``'s tensor-core kernel at (K, D <= 64); mirrors
    ``csrc/mma.cuh`` ``mma_plan``: a tile of its warps' particles (8 warps
    to D = 24, 6 past it; 32 particles a warp to D = 40, 16 past it), its x
    at D padded to 8; each component its VB record and its split record
    (A's rows as hi and lo float4s, a row 4 (mod 8) float4s, then m's
    pairs); in half an SM (two blocks an SM): all K components beside two x
    tiles where they fit, else one x tile and equal chunks of as many as
    fit."""
    Dp = -(-D // 8) * 8
    tile = _mma_warps(D) * 16 * (2 if D <= 40 else 1)
    row4 = Dp // 2 + (4 if Dp // 2 % 8 == 0 else 0)
    split = 4 * Dp * row4 + Dp
    x, comp = 4 * Dp * tile, 4 * (_rec_floats(D, vb=True) + split)
    if 2 * x + K * comp <= _HALF_SMEM:
        return K, 1, 2, tile, split, 2 * x + K * comp
    n_chunks = -(-K // ((_HALF_SMEM - x) // comp))
    kc = -(-K // n_chunks)
    return kc, n_chunks, 1, tile, split, x + kc * comp


def mma_tiled_plan():
    """``(particles a tile, rows a row tile, depth of a panel, threads a
    block, step buffers, shared memory a block)`` of the tensor-core
    kernels past D = 64 (``fused_maha``'s, ``fused_logq``'s and
    ``fused_rho``'s, one walk); mirrors ``csrc/mma_tiled.cuh``: each
    step buffer an A panel of ``_MT_M`` split rows (hi and lo, ``_MT_A_ROW4``
    float4s apart), an X panel of ``_MT_K`` rows of ``_MT_X_STRIDE`` floats
    and an m panel of ``_MT_K``; then the four row groups' partial sums of a
    component.  The same at every (K, D): a block walks the components, the
    row tiles and the panels."""
    stage = 4 * _MT_M * _MT_A_ROW4 + _MT_K * _MT_X_STRIDE + _MT_K
    smem = 4 * (_MT_STAGES * stage + 4 * _MT_P)
    return _MT_P, _MT_M, _MT_K, _MT_THREADS, _MT_STAGES, smem


def mma_scratch_floats(K, D):
    """Floats of the split operand the tensor-core kernels take past D = 64
    (``csrc/mma_tiled.cuh`` ``mma_scratch_floats``; ``fused_maha``'s A,
    ``fused_logq``'s and ``fused_rho``'s U, its upper triangle 0): K
    components of D padded to 8 rows, each of D padded to a panel hi and lo
    words."""
    return 2 * K * (-(-D // 8) * 8) * (-(-D // _MT_K) * _MT_K)


def mma_tile_panels(rt, D, tri):
    """The depth panels row tile ``rt`` of the tensor-core walk past D = 64
    computes (``csrc/mma_tiled.cuh`` ``mma_tile_panels``): every panel of a
    general A (``fused_maha``); of a lower-triangular U (``tri``:
    ``fused_logq``, ``fused_rho``) those at or left of the row tile's last
    row below D."""
    if not tri:
        return -(-D // _MT_K)
    return (min(D, (rt + 1) * _MT_M) - 1) // _MT_K + 1


def eval_plan(kernel, K, D, variant=None):
    """``(components a chunk, chunk buffers, shared memory a block)`` of
    ``fused_logq``'s, ``fused_rho``'s or ``fused_maha``'s kernel
    ``variant`` (None: :func:`eval_variant`'s); mirrors ``csrc/common.cuh``
    ``eval_plan`` and ``csrc/tiled.cuh``.  The record kernel (to D = 64)
    streams 16-byte component records (``fused_maha``'s in the VB layout):
    the whole mixture in one buffer where it fits half an SM's shared
    memory, else two buffers of the largest equal chunks that do.  The
    tiled kernel takes a component at a time, its panels in two buffers
    (:func:`tiled_plan`); ``fused_maha``'s tensor-core kernel the chunks of
    :func:`mma_plan`, a chunk's records and its split records the two
    buffers where there is more than one chunk (to D = 64); the tensor-core
    kernels of all three a component at a time in :func:`mma_tiled_plan`'s
    step buffers past it."""
    maha = kernel == "fused_maha"
    variant = eval_variant(kernel, D) if variant is None else variant
    if variant == "tiled":
        return 1, 2, tiled_plan()[4]
    if variant == "mma" and D > _REC_D_MAX:
        return 1, _MT_STAGES, mma_tiled_plan()[5]
    if variant == "mma":
        kc, n_chunks, _, _, _, smem = mma_plan(K, D)
        return kc, 1 if n_chunks == 1 else 2, smem
    rec = 4 * _rec_floats(D, vb=maha)
    if K * rec <= _HALF_SMEM:
        return K, 1, K * rec
    n_chunks = -(-K // (_HALF_SMEM // (2 * rec)))
    kc = -(-K // n_chunks)
    return kc, 2, 2 * kc * rec


def eval_threads(D, variant=None):
    """Threads of a block of the kernel ``fused_logq``, ``fused_rho`` and
    ``fused_maha`` elect for dimension D (with ``variant``, of that kernel);
    mirrors ``csrc/common.cuh`` ``kEvalThreads``, ``csrc/tiled.cuh``
    ``kTileThreads`` and, for the tensor-core kernels, ``csrc/mma.cuh``
    ``mma_threads`` (``fused_maha``'s: 256 to D = 24, 192 past it) and 256
    past D = 64 (``csrc/mma_tiled.cuh`` ``kMtThreads``)."""
    variant = eval_variant("fused_rho", D) if variant is None else variant
    mma = _MT_THREADS if D > _REC_D_MAX else 32 * _mma_warps(D)
    return {"rec": EVAL_THREADS, "mma": mma, "tiled": _TILE_THREADS}[variant]


def block_particles(kernel, D, variant=None):
    """Particles a block of ``kernel`` takes at a time in dimension D (its
    grid is one wave of blocks over N / this; ``variant``, a kernel of
    ``fused_logq``, ``fused_rho``, ``fused_maha`` or a draw other than the
    one it elects): a thread a particle, a tile of 128 in the tiled
    kernels, and of 256 (192 past D = 24, 96 past D = 40) in
    ``fused_maha``'s tensor-core kernel, of 128 in all three's past D =
    64."""
    if kernel in ("fused_logq", "fused_rho", "fused_maha"):
        variant = eval_variant(kernel, D) if variant is None else variant
        if variant == "mma":
            return _MT_P if D > _REC_D_MAX else mma_plan(1, D)[3]
        return _TILE_P if variant == "tiled" else EVAL_THREADS
    if kernel in DRAWS:
        variant = variant or draw_plan(kernel, 1, D)[0]
        return {"rec": EVAL_THREADS, "looped": THREADS, "tiled": _TILE_P}[variant]
    return THREADS


def smem_bytes(kernel, K, D, Kt=0):
    """Shared memory one block of ``kernel`` asks for; mirrors the
    launchers in ``csrc/*.cu`` (``Kt`` is the target's component count).
    The operands are staged in it when they fit beside the kernel's own
    shared memory, and read from device memory otherwise; ``fused_logq``'s
    and ``fused_maha``'s kernels up to D = 64 stage one or two chunks of
    records, their tiled kernel its panels (:func:`eval_plan`), the draw
    kernels' their plan's
    (:func:`transform_plan`, :func:`propose_plan`).  For a K-blocked kernel, its statistics
    pass's (the first launch reads the operands as ``fused_logq``,
    ``fused_propose_logq`` or like them)."""
    if kernel in BLOCKED:
        return blocked_plan(kernel, K, D)[2]
    if kernel in ("fused_logq", "fused_rho", "fused_maha"):
        return eval_plan(kernel, K, D)[2]
    if kernel in DRAWS:
        return draw_plan(kernel, K, D, Kt)[4]
    if kernel == "fused_mcmc_pool":
        return pool_smem_bytes(K, D, "thread")
    if kernel in _DENSE:
        return dense_plan(kernel, K, D, Kt)[4]
    if kernel in _STATS:
        return _table_bytes(kernel, K, D, Kt)
    params = _operand_floats(kernel, K, D, Kt)
    return 4 * params if 4 * params <= SMEM_LIMIT else 0


def draw_smem_bytes(K, Kt, D):
    """Shared memory of ``fused_is_pmc_step_blocked``'s first launch
    (``csrc/is_pmc_step_blocked.cu`` ``pmc_step_draw_smem_bytes``): both
    mixtures' records and the proposal's thresholds where D <= 32 and they
    fit, else 0 (``fused_propose_logq``'s plan's kernel then takes that
    launch)."""
    need = 4 * ((K + Kt) * _rec_floats(D) + K)
    return need if D <= 32 and need <= SMEM_LIMIT else 0


def limit_reason(kernel, K, D, Kt=0):
    """None if the CUDA kernel takes a (K, D) mixture (with a Kt-component
    target), else the limit it breaks, named.  Depends on nothing but its
    arguments."""
    if not 1 <= D <= D_MAX[kernel]:
        return ("%s: dimension %d is outside the CUDA kernel's limit "
                "1 <= D <= %d" % (kernel, D, D_MAX[kernel]))
    need = smem_bytes(kernel, K, D, Kt)
    if need > SMEM_LIMIT:
        return ("%s: K=%d, K_target=%d, D=%d needs %d bytes of shared memory "
                "a block for its statistics tile; the limit is %d"
                % (kernel, K, Kt, D, need, SMEM_LIMIT))
    # the tiled products' bucket pass (where K > 1)
    if kernel in DRAWS and draw_plan(kernel, K, D, Kt)[0] == "tiled" and K > 1:
        need = transform_bucket_plan(K)[3]
        if need > SMEM_LIMIT:
            return ("%s: K=%d needs %d bytes of shared memory a block for the bucket "
                    "pass's counts; the limit is %d" % (kernel, K, need, SMEM_LIMIT))
    table = kernel not in _DENSE or dense_plan(kernel, K, D, Kt)[0] == "table"
    if kernel in _STATS and table and stats_tile(K, D) < THREADS and D > _NARROW_TILE_D_MAX:
        return ("%s: K=%d, D=%d needs the 64-particle statistics tile, whose "
                "kernels are built to the limit D <= %d" % (kernel, K, D, _NARROW_TILE_D_MAX))
    return None


def check_limits(kernel, K, D, Kt=0):
    """Raise ``ValueError`` naming the limit if the CUDA kernel does not
    take a (K, D) mixture (with a Kt-component target)."""
    reason = limit_reason(kernel, K, D, Kt)
    if reason is not None:
        raise ValueError(reason)


def _nvcc():
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _run_all(cmds):
    """Run the commands at once; ``(log, first failing exit code or 0)``.
    The log gives each command's output and its seconds from the start."""
    t0 = time.perf_counter()
    outs = [tempfile.TemporaryFile(mode="w+") for _ in cmds]
    procs = [subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT, text=True)
             for cmd, out in zip(cmds, outs)]
    seconds = [None] * len(cmds)
    while None in seconds:
        for i, proc in enumerate(procs):
            if seconds[i] is None and proc.poll() is not None:
                seconds[i] = time.perf_counter() - t0
        time.sleep(0.05)
    log, rc = "", 0
    for cmd, proc, out, sec in zip(cmds, procs, outs, seconds):
        out.seek(0)
        log += "%s\n[%.1f s]\n%s" % (" ".join(cmd), sec, out.read())
        out.close()
        rc = rc or proc.returncode
    return log, rc


def _build():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    lib_path = BUILD_DIR / ("libpypmc_kernels_%s.so" % h.hexdigest()[:16])
    build_info.update(path=str(lib_path), built=False, seconds=0.0)
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in sorted(CSRC.glob("*.cu"))]
        log, rc = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                            for obj, src in zip(objs, sorted(CSRC.glob("*.cu")))])
        if rc == 0:
            so = os.path.join(tmp, "lib.so")
            link_log, rc = _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", so, *objs]])
            log += link_log
        lib_path.with_suffix(".log").write_text(log)
        if rc != 0:
            raise RuntimeError("nvcc failed (exit %d):\n%s" % (rc, log))
        os.replace(so, lib_path)   # atomic: a concurrent build never sees a partial file
    build_info.update(built=True, seconds=time.perf_counter() - t0, log=log)
    return lib_path


def signatures():
    """``{name: argtypes}`` of the library's launchers, each returning an
    int (0 or a CUDA error code)."""
    P, I, L, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
    return {
        # xT, mix, scratch (mma_scratch_floats(K, D) floats where the
        # variant is the tensor-core kernel past D = 64, else null), out, N,
        # K, D, student_t, variant (-1 the elected kernel, 1 the record, 2
        # the tiled, 3 the tensor-core kernel), n_blocks, stream
        "pmc_fused_logq": [P, P, P, P, L, I, I, I, I, I, P],
        # s0, s1, seed_words (null: s0, s1; else two int64 on the card, read
        # in the kernel), mix, tmix, xT, latent, log_q, log_p, scratch (the
        # tiled route's transform_scratch_words(N, K, D) at K > 1; else
        # null), split (the tiled route's evaluations' scratch,
        # mma_scratch_floats(max(K, Kt), D); else null), N, K, Kt, D,
        # student_t, t_student_t, variant (-1 the plan's, 0 the looped
        # kernel, 1 the record kernel, 2 the tiled route), n_blocks (<= 0:
        # one wave of the record or looped kernel, sized by the launcher),
        # eval_blocks (the tiled route's evaluations), stream
        "pmc_fused_propose_logq": [U, U, P, P, P, P, P, P, P, P, P, L, I, I, I, I,
                                   I, I, I, I, P],
        # xT, w, mix, partial, stats, N, K, D, student_t, dof_stats,
        # variant (-1 the plan's, 0 the entry table, 1 the register pass, 2
        # the Gram pass), n_blocks, stream
        "pmc_fused_pmc_stats": [P, P, P, P, P, L, I, I, I, I, I, I, P],
        # s0, s1, seed_words, mix, tmix, xT, latent, w, log_q, log_p (the
        # Gram route's (N,) scratch, else null), split (its draw's split,
        # as pmc_fused_propose_logq's), partial, stats, N, K, Kt, D,
        # student_t, t_student_t, dof_stats, variant (as
        # pmc_fused_pmc_stats'), draw_blocks, eval_blocks (the Gram route's
        # draw: fused_propose_logq's n_blocks and eval_blocks), n_blocks,
        # stream
        "pmc_fused_is_pmc_step": [U, U, P, P, P, P, P, P, P, P, P, P, P, L, I, I,
                                  I, I, I, I, I, I, I, I, P],
        # xT, ops, scratch (mma_scratch_floats(K, D) floats where the
        # variant is the tensor-core kernel past D = 64, else null), out, N,
        # K, D, variant (-1 the elected kernel, 1 the record, 2 the tiled, 3
        # the tensor-core kernel), n_blocks, stream
        "pmc_fused_maha": [P, P, P, P, L, I, I, I, I, P],
        # xT, mix, scratch (as pmc_fused_logq's), rho, log_q, N, K, D,
        # student_t, variant (as pmc_fused_logq's), n_blocks, stream
        "pmc_fused_rho": [P, P, P, P, P, L, I, I, I, I, I, P],
        # xT, w, ops, partial, stats, N, K, D, variant, n_blocks, stream
        "pmc_fused_vb_estep": [P, P, P, P, P, L, I, I, I, I, P],
        # zT, latent, scale, ops, scratch (the tiled pair's int32
        # transform_scratch_words(N, K, D) at K > 1; else null), xT (D x
        # transform_width(N, K) floats there), N, K, D, variant (-1 the
        # plan's, 0 the looped kernel, 1 the record kernel, 2 the tiled
        # pair), n_blocks, stream
        "pmc_fused_transform": [P, P, P, P, P, P, L, I, I, I, I, P],
        # latent, scratch, N, K, stream: the tiled products' bucket pass alone
        "pmc_transform_buckets": [P, P, L, I, P],
        # s0, s1, seed_words (as pmc_fused_propose_logq's), latent, ops,
        # scratch (the drawn product's at K > 1; else null), xT, N, K, D,
        # student_t, variant (as pmc_fused_transform's), n_blocks, stream
        "pmc_fused_transform_rng": [U, U, P, P, P, P, P, L, I, I, I, I, I, P],
        # s0, s1, x0T, e0, cholr, dof_prop, tmix, points, accepts,
        # nan_counts, xfT, ef, C, n_steps, Kt, D, student_t_prop,
        # t_student_t, variant, stream
        "pmc_fused_mcmc_pool": [U, U, P, P, P, ctypes.c_float, P, P, P, P, P, P,
                                I, I, I, I, I, I, I, P],
        # xT, w, mix, chunks, log_q, split (fused_logq's scratch past D =
        # 64, else null), partial, stats, N, K, D, kc, student_t, dof_stats,
        # n_eval_blocks, n_blocks, stream
        "pmc_fused_pmc_stats_blocked": [P, P, P, P, P, P, P, P, L, I, I, I, I, I, I,
                                        I, P],
        # xT, w, ops, chunks, lse, partial, stats, N, K, D, kc, n_eval_blocks,
        # n_blocks, stream
        "pmc_fused_vb_estep_blocked": [P, P, P, P, P, P, P, L, I, I, I, I, I, P],
        # s0, s1, seed_words, mix, tmix, chunks, xT, latent, w, log_q, log_p,
        # partial, stats, N, K, Kt, D, kc, student_t, t_student_t, dof_stats,
        # n_blocks, stream
        "pmc_fused_is_pmc_step_blocked": [U, U, P, P, P, P, P, P, P, P, P, P, P, L,
                                          I, I, I, I, I, I, I, I, P],
        # const, old_dofs, out, K, steps, mindof, maxdof, is_double, variant
        # (0 the serial kernel, 1 the warp kernel), stream
        "pmc_solve_dofs": [P, P, P, I, I, ctypes.c_double, ctypes.c_double, I, I, P],
        # s0, s1, seed_words, cumw, dof (null: Gaussian), latent, zT, scale
        # (both null: no normals), N, K, D, is_double, n_blocks, stream
        "pmc_draw_proposal_inputs": [U, U, P, P, P, P, P, P, L, I, I, I, I, P],
        # s0, s1, seed_words, mix, latent, xT, N, K, D, student_t, rng (1:
        # fused_draw_transform_rng's streams), n_blocks, stream
        "pmc_fused_draw_transform": [U, U, P, P, P, P, L, I, I, I, I, I, P],
    }


def _declare(lib):
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, argtypes in signatures().items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.pmc_stats_smem_bytes.argtypes = [I, I, I, I]     # K, Kt, D, is_step
    lib.pmc_is_pmc_step_blocked_smem_bytes.argtypes = [I, I, I]  # K, Kt, D
    lib.pmc_step_draw_smem_bytes.argtypes = [I, I, I]  # K, Kt, D
    lib.pmc_step_draw_per_sm.argtypes = [I, I, I]      # K, Kt, D -> first-launch blocks an SM
    lib.pmc_step_draw_per_sm.restype = ctypes.c_int
    # the register or Gram pass's blocks an SM (0 where the plan is the
    # entry table)
    lib.pmc_is_pmc_step_per_sm.argtypes = [I, I, I]    # K, Kt, D
    lib.pmc_is_pmc_step_per_sm.restype = ctypes.c_int
    # K, D -> the register or Gram pass's blocks an SM (0 where the plan is
    # the entry table)
    for name in ("pmc_vb_estep_per_sm", "pmc_pmc_stats_per_sm"):
        getattr(lib, name).argtypes = [I, I]
        getattr(lib, name).restype = ctypes.c_int
    # the record kernels' blocks an SM (0 where the plan takes another
    # kernel): K, D, rng (fused_transform_rng's, else fused_transform's);
    # K, Kt, D (fused_propose_logq's)
    # K, D, rng (fused_draw_transform_rng's, else fused_draw_transform's)
    for name in ("pmc_transform_per_sm", "pmc_propose_per_sm", "pmc_draw_transform_per_sm"):
        getattr(lib, name).argtypes = [I, I, I]
        getattr(lib, name).restype = ctypes.c_int
    lib.pmc_is_pmc_step_smem_bytes.argtypes = [I, I, I]   # K, Kt, D
    # K, Kt, D, mode (0 the step, 1 VB, 2 fused_pmc_stats), int out[4]
    lib.pmc_dense_plan.argtypes = [I, I, I, I, P]
    lib.pmc_transform_plan.argtypes = [I, I, I, P]     # K, D, rng, int out[4]
    lib.pmc_propose_plan.argtypes = [I, I, I, P]       # K, Kt, D, int out[4]
    lib.pmc_draw_transform_plan.argtypes = [I, I, P]   # K, D, int out[4]
    for name in BLOCKED:   # K, D -> statistics-pass blocks an SM holds
        fn = getattr(lib, "pmc_%s_per_sm" % name[len("fused_"):])
        fn.argtypes = [I, I]
        fn.restype = ctypes.c_int
    lib.pmc_blocked_chunk.argtypes = [I, I, I]   # K, D, vb
    lib.pmc_blocked_chunk.restype = ctypes.c_int
    lib.pmc_eval_chunk.argtypes = [I, I, I]      # K, D, kernel (0 logq, 1 maha, 2 rho)
    lib.pmc_eval_chunk.restype = ctypes.c_int
    lib.pmc_eval_variant.argtypes = [I]          # D -> fused_logq's and fused_rho's kernel
    lib.pmc_eval_variant.restype = ctypes.c_int
    lib.pmc_maha_variant.argtypes = [I]          # D -> fused_maha's kernel
    lib.pmc_maha_variant.restype = ctypes.c_int
    lib.pmc_maha_mma_plan.argtypes = [I, I, P]   # K, D, int out[5]
    lib.pmc_maha_mma_plan.restype = ctypes.c_longlong
    lib.pmc_maha_mma_tiled_plan.argtypes = [P]   # int out[5]
    lib.pmc_maha_mma_tiled_plan.restype = ctypes.c_longlong
    lib.pmc_maha_mma_scratch_floats.argtypes = [I, I]   # K, D
    lib.pmc_maha_mma_scratch_floats.restype = ctypes.c_longlong
    lib.pmc_tiled_plan.argtypes = [P]            # int out[4]
    lib.pmc_tiled_plan.restype = ctypes.c_longlong
    # K, D, variant -> blocks an SM holds
    for name in ("pmc_logq_per_sm", "pmc_maha_per_sm", "pmc_rho_per_sm"):
        getattr(lib, name).argtypes = [I, I, I]
        getattr(lib, name).restype = ctypes.c_int
    # fused_transform's tiled kernel: blocks an SM holds; the bucket pass's
    # plan: K, int out[3] -> shared memory
    lib.pmc_transform_tiled_per_sm.argtypes = []
    lib.pmc_transform_tiled_per_sm.restype = ctypes.c_int
    # D -> blocks an SM holds of fused_transform_rng's and
    # fused_propose_logq's drawn products
    lib.pmc_draw_tiled_per_sm.argtypes = [I]
    lib.pmc_draw_tiled_per_sm.restype = ctypes.c_int
    lib.pmc_transform_bucket_plan.argtypes = [I, P]
    lib.pmc_transform_bucket_plan.restype = ctypes.c_longlong
    # N, K, D, long long out[7]: the scratch's layout (transform_layout)
    lib.pmc_transform_layout.argtypes = [ctypes.c_longlong, I, I, P]
    lib.pmc_transform_layout.restype = None
    # K, D -> the statistics tile; C, D -> the pool's variant
    for name in ("pmc_stats_tile", "pmc_mcmc_pool_variant"):
        getattr(lib, name).argtypes = [I, I]
        getattr(lib, name).restype = ctypes.c_int
    pairs = ("pmc_logq_smem_bytes", "pmc_maha_smem_bytes", "pmc_rho_smem_bytes",
             "pmc_vb_estep_smem_bytes", "pmc_pmc_stats_smem_bytes",
             "pmc_pmc_stats_blocked_smem_bytes", "pmc_vb_estep_blocked_smem_bytes")
    for name in pairs:
        getattr(lib, name).argtypes = [I, I]
    lib.pmc_mcmc_pool_smem_bytes.argtypes = [I, I, I]   # Kt, D, variant (1: warp)
    for name in ("pmc_stats_smem_bytes",
                 "pmc_is_pmc_step_blocked_smem_bytes", "pmc_step_draw_smem_bytes",
                 "pmc_mcmc_pool_smem_bytes", "pmc_is_pmc_step_smem_bytes",
                 "pmc_dense_plan", "pmc_transform_plan", "pmc_propose_plan",
                 "pmc_draw_transform_plan") + pairs:
        getattr(lib, name).restype = ctypes.c_longlong
    return lib


def load():
    """The kernel library, built on first use.  Raises if it cannot be
    built or loaded."""
    global _lib
    if _lib is None:
        _lib = _declare(ctypes.CDLL(str(_build())))
    return _lib
