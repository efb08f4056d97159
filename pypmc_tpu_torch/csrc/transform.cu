// fused_transform and fused_transform_rng: the per-particle mixture affine
// transform x_n = mu[latent_n] + (L[latent_n] z_n) * scale_n in the
// transposed layout -> xT (D, N).
//
// Replaces the Pallas kernels pypmc_tpu/ops/pallas_kernels.py:1014
// (fused_transform, body _transform_kernel) and :881 (fused_transform_rng,
// body _transform_rng_kernel, draw _propose_tile).  fused_transform takes
// the normals z (D, N) and the scales (N,); fused_transform_rng draws the
// normals and, for a Student-t mixture, the scale sqrt(dof / chi2(dof)) in
// the kernel: it is fused_propose_logq's draw (common.cuh draw_component)
// for a given component, without the evaluation.
//
// Bound on the H100: fused_transform reads D + 2 words and writes D a
// particle (at D = 40, 328 bytes) for D (D + 1) / 2 FMAs -- memory-bound
// at D = 40 (344 MB, 0.103 ms at K = 32, N = 2^20), FMA-bound from D ~ 70
// (at D = 200, 2^16: 0.040 ms of FP32 operations against 0.032 of bytes);
// fused_transform_rng reads one word and writes D, and its Philox,
// Box-Muller and (Student-t) Marsaglia-Tsang work is SFU- and integer-bound
// rather than memory-bound (past D = 64 its drawn product does
// fused_transform's FMAs beside the draw's issue; PERF.md section 6).
//
// Both up to D = 64 (transform_rec_kernel, transform_rng_rec_kernel; the
// record kernels of common.cuh): 256 threads a block,
// one particle a thread (grid-stride, one wave of the blocks an SM holds),
// z in registers at the record instantiations' DMAX (8/16/32/40/64,
// common.cuh EvalInsts), each x_i stored as soon as it is formed (row i
// reads z_0 .. z_i), so no x array is kept.  A block stages only what it
// reads: each component's mu and the lower triangle of L packed by row
// (transform_rec_floats), at an odd stride, so that the lanes of a warp that
// read different components' words at one offset hit distinct banks (at a
// stride of D * D floats, 0 mod 32 for every D divisible by 8, they hit one
// bank: a ~20-way conflict for 32 draws among 32 components).  The records
// fit half an SM up to K = 33 at D = 40 (two blocks, 16 warps); past that
// the kernel reads mu and L from device memory through the read-only cache.
// The FMA chain is affine_transform's (j ascending, then fmaf(scale, s,
// mu_i)), so the output is the looped kernel's bit for bit.  What bounds it
// then: the 820 shared words a particle at D = 40, each feeding one FMA, at
// the SM's 128 B a clock (~0.12 ms at 2^20), beside the 0.103 ms of bytes.
// fused_transform_rng's kernel draws z into registers from the particle's
// Philox stream (draw_component's: the normals, then the chi-square), its
// dofs staged after the records, so its output is the looped kernel's bit
// for bit too; what bounds it is the draw's integer and SFU work.
//
// The looped kernels (transform_kernel, transform_rng_kernel): one thread a
// particle, the whole operand buffer mu | L | dof staged in shared memory
// where it fits (threads of a warp read different components' entries: bank
// conflicts, not a broadcast), the product as a lower-triangular FMA chain
// in registers up to D = 32 (local memory past it), the result written once
// as D coalesced rows.  Neither is elected past D = 64 (fused_transform
// below kTransformTiledDMin, fused_transform_rng below kDrawTiledDMin would
// take them); both run anywhere to D = 128, forced, as the bit-exact
// yardstick.  The TPU's one-hot selector contractions over all K components
// become one indexed read: a thread touches only its own component.  The
// Philox stream of a particle is keyed by the seed and counted by the
// particle's index, as in propose_logq.cu, so the samples do not depend on
// the launch configuration.
//
// fused_transform from D = kTransformTiledDMin and fused_transform_rng from
// D = kDrawTiledDMin run on the tiled engine (tiled.cuh), every launch
// graph-capturable (no count is read on the host).  At K = 1 each is one
// launch over the particles in order (ParticleTiles).  At K > 1 the
// bucket pass (tiled.cuh bucket_count_kernel, bucket_scatter_kernel) sorts
// the particles by component over all N, stably, in a full wave of blocks;
// its slots hold one tile of up to 128 consecutive positions of one bucket
// each, so only K tiles are partial.  fused_transform then writes each
// tile of 2,048 particles' bucket order (bucket_rank_kernel), moves z and
// the scales into bucket order (bucket_permute_kernel<true>: zb, in the
// output's own memory, D rows of bucket_width(N, K) floats), walks the
// slots on a grid of one wave (transform_tiled_kernel over RunTiles: L_k's
// panels, those above the diagonal skipped, and the tile's contiguous
// columns of zb, as the particles' own at K = 1), writes x in bucket order
// (StoreEpi's float4 stores into xb in the scratch) and moves it out
// (bucket_permute_kernel<false>): the product's reads and stores are a
// tile's consecutive columns, and the permutation is paid once in each
// direction by two streaming passes, each side coalesced, rather than by 4-byte
// gathers of z and scattered stores of x a sector each inside the product.
// Its accumulators run j ascending from 0 as affine_transform's, the zeros
// above the diagonal add fmaf(0, z, s) = s, and the last FMA is fmaf(scale_n,
// s, mu_i), so its output is the looped kernel's bit for bit (up to the
// sign of a zero) wherever both run.  What bounds it: the FMA issue of the
// tile's product, as in the evaluations (PERF.md section 6), beside the two
// moves' 4 D N floats.  fused_transform_rng's product
// (draw_tiled_kernel<0>) draws its z panels in shared memory instead
// (DrawnX: draw_component's normals, words 0 on) for each position's
// particle (perm) and each particle's Student-t scale once a tile
// (DrawnScales), stores x in bucket order as fused_transform's does, and
// only the move out follows (tiled.cuh launch_draw_tiled).
//
// PMC_TRANSFORM_OFF (chip_smoke.py --transform-split; 0 in the library) is
// a mask of fused_transform's moves left out at K > 1, its output then wrong
// by design: 1 the move of z and the scales into bucket order, 2 the move of
// x out of it.
#ifndef PMC_TRANSFORM_OFF
#define PMC_TRANSFORM_OFF 0
#endif
#include "tiled.cuh"

namespace pmc {

// the operand buffer: mu (K, D) | L (K, D, D) | dof (K)
__host__ __device__ inline size_t transform_floats(int K, int D) {
  return static_cast<size_t>(K) * D * (D + 1) + K;
}

template <int DMAX, bool OPS_SMEM>
__global__ void __launch_bounds__(kThreads)
transform_kernel(const float* __restrict__ zT, const int* __restrict__ latent,
                 const float* __restrict__ scale, const float* __restrict__ ops_src,
                 float* __restrict__ xT, long long N, int K, int D) {
  extern __shared__ float smem[];
  const float* mu = stage_operands<OPS_SMEM>(
      smem, ops_src, static_cast<int>(transform_floats(K, D)));
  __syncthreads();
  const float* L = mu + K * D;
  for (long long n = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       n < N; n += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int lat = latent[n];
    float z[DMAX], x[DMAX];
    load_particle<DMAX>(zT, N, n, D, z);
    affine_transform<DMAX>(L + lat * D * D, mu + lat * D, D, z, scale[n], x);
    store_particle<DMAX>(xT, N, n, D, x);
  }
}

template <int DMAX, bool OPS_SMEM>
__global__ void __launch_bounds__(kThreads)
transform_rng_kernel(const Seed seed, const int* __restrict__ latent,
                     const float* __restrict__ ops_src, float* __restrict__ xT,
                     long long N, int K, int D, int student_t) {
  extern __shared__ float smem[];
  const float* mu = stage_operands<OPS_SMEM>(
      smem, ops_src, static_cast<int>(transform_floats(K, D)));
  __syncthreads();
  const float* L = mu + K * D;
  const float* dof = L + K * D * D;
  for (long long n = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       n < N; n += static_cast<long long>(gridDim.x) * blockDim.x) {
    Philox rng(seed.w0(), seed.w1(), static_cast<uint64_t>(n));
    float x[DMAX];
    draw_component<DMAX>(mu, L, dof, latent[n], D, student_t != 0, rng, x);
    store_particle<DMAX>(xT, N, n, D, x);
  }
}

// the smallest D at which fused_transform takes the tiled pair
// (ops/_build.py TRANSFORM_TILED_D_MIN): the first past the record kernels'
// 64 at which it beat the looped kernel at the shapes timed (PERF.md); at
// most 129, since past D = 128 no other kernel of fused_transform's exists
constexpr int kTransformTiledDMin = 65;
static_assert(kTransformTiledDMin > kRecDMax && kTransformTiledDMin <= kDMax + 1,
              "the looped kernel to kTransformTiledDMin - 1, the tiled pair from it");

// The plan of fused_transform (rng false) or fused_transform_rng (rng true)
// for (K, D) (mirrored by ops/_build.py transform_plan): draw_plan's, the
// record kernel's records the K draw records (and fused_transform_rng's K
// dofs), the looped kernel's operands the buffer mu | L | dof;
// fused_transform's tiled pair from kTransformTiledDMin (kTileThreads, the
// tiled engine's shared memory), fused_transform_rng's drawn product from
// kDrawTiledDMin (draw_tiled_smem); ``looped`` forces the looped kernel to
// D = 128.
inline DrawPlan transform_plan(int K, int D, bool looped = false, bool rng = false) {
  if (!looped && D >= (rng ? kDrawTiledDMin : kTransformTiledDMin))
    return {kDrawTiled, false, kTileThreads, rng ? draw_tiled_smem(D) : kTiledSmem};
  return draw_plan(D, static_cast<size_t>(K) * (transform_rec_floats(D) + (rng ? 1 : 0)),
                   transform_floats(K, D), looped);
}

// ---------------------------------------------------------------------
// fused_transform's tiled pair: the bucket pass (tiled.cuh), the moves
// into and out of bucket order and the tiled product
// ---------------------------------------------------------------------

// ops: mu (K, D) | L (K, D, D) | dof (K); zT (D rows, ``ld`` floats apart)
// read at the tile columns of ``src``, x stored to the same columns of xT
// (RUN: float4 stores, StoreEpi)
template <typename Source, bool RUN>
__global__ void __launch_bounds__(kTileThreads, 2)
transform_tiled_kernel(const float* __restrict__ zT, const float* __restrict__ scale,
                       const float* __restrict__ ops, const Source src, float* __restrict__ xT,
                       long long ld, int K, int D) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  StoreEpi<GivenScales, RUN> epi{reinterpret_cast<int*>(smem + kStoreColsOffset),
                                 smem + kStoreScalesOffset, ops, xT, nullptr, ld, D, {scale}};
  tiled_walk<true, false>(smem, LoadedX{zT, ld}, ops + static_cast<long long>(K) * D, nullptr, D,
                          src, epi);
}

// The tiled pair on stream s: at K = 1 the product over the particles in
// order; else the bucket pass, z and the scales into bucket order (zb in
// xT's memory, which holds D bucket_width(N, K) floats), the product on
// n_blocks blocks into xb, and x out of bucket order; scratch
// PairLayout(N, K, D).words int32, 16-byte aligned (at K > 1).  The
// error of the first launch that fails, or cudaErrorInvalidValue past the
// limits.
int launch_transform_tiled(const float* zT, const int* latent, const float* scale,
                           const float* ops, int* scratch, float* xT, long long N, int K, int D,
                           int n_blocks, cudaStream_t s) {
  if (D < 1 || D > kWideDMax || K < 1 || n_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const auto product = [&](auto kernel, const float* z, const float* sc, const auto& src,
                           float* x, long long ld) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kTiledSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<n_blocks, kTileThreads, kTiledSmem, s>>>(z, sc, ops, src, x, ld, K, D);
    return static_cast<int>(cudaGetLastError());
  };
  if (K == 1)
    return product(transform_tiled_kernel<ParticleTiles, false>, zT, scale, ParticleTiles{N, 1},
                   xT, N);
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int err = launch_buckets(GivenLatents{latent}, scratch, N, K, s);
  if (err != 0) return err;
  const PairLayout at(N, K, D);
  const long long width = bucket_width(N, K);
  float* scale_b = reinterpret_cast<float*>(scratch + at.scale_b);
  float* xb = reinterpret_cast<float*>(scratch + at.xb);
  const int* pos = scratch + BucketLayout(N, K).pos;
  int *rank = scratch + at.rank, *tpos = scratch + at.tpos;
  err = launch_rank(latent, pos, rank, tpos, N, K, s);
  if (err != 0) return err;
  if (!(PMC_TRANSFORM_OFF & 1)) {
    err = launch_permute<true>(zT, xT, scale, scale_b, pos, rank, tpos, N, D, width, s);
    if (err != 0) return err;
  }
  err = product(transform_tiled_kernel<RunTiles, true>, xT, scale_b,
                RunTiles{reinterpret_cast<const int4*>(scratch), nullptr, bucket_slots(N, K)}, xb,
                width);
  if (err != 0 || (PMC_TRANSFORM_OFF & 2)) return err;
  return launch_permute<false>(xb, xT, nullptr, nullptr, pos, rank, tpos, N, D, width, s);
}

// ops: mu (K, D) | L (K, D, D) | dof (K), the looped kernel's buffer;
// STAGED: the records in shared memory (transform_plan)
template <int DMAX, bool STAGED>
__global__ void __launch_bounds__(kEvalThreads, eval_min_blocks(DMAX))
transform_rec_kernel(const float* __restrict__ zT, const int* __restrict__ latent,
                     const float* __restrict__ scale, const float* __restrict__ ops,
                     float* __restrict__ xT, long long N, int K, int D) {
  extern __shared__ float smem[];
  constexpr int below = eval_dmax_below(DMAX);
  __builtin_assume(D > below && D <= DMAX);   // the dispatch's
  const float* L = ops + K * D;
  if constexpr (STAGED) {
    stage_transform_records(smem, ops, L, K, D);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  for (long long n = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       n < N; n += static_cast<long long>(gridDim.x) * blockDim.x) {
    float z[DMAX];
    load_particle<DMAX>(zT, N, n, D, z);
    rec_affine<DMAX, STAGED>(z, scale[n], smem, ops, L, latent[n], D,
                             [&](int i, float v) { xT[i * N + n] = v; });
  }
}

// fused_transform_rng's record kernel: transform_rec_kernel with the
// normals and the Student-t scale drawn (draw_component's stream), the dofs
// staged after the records.  Instantiated for each form of the seed
// (SEED_PTR, common.cuh particle_stream): by value the kernel parameters key
// the streams; from a seed tensor the key is read from shared memory at
// each Philox refill (SharedKey), which only a replayed step pays.
template <int DMAX, bool STAGED, bool SEED_PTR>
__global__ void __launch_bounds__(kEvalThreads, eval_min_blocks(DMAX))
transform_rng_rec_kernel(const Seed seed, const int* __restrict__ latent,
                         const float* __restrict__ ops, float* __restrict__ xT, long long N,
                         int K, int D, int student_t) {
  extern __shared__ float smem[];
  constexpr int below = eval_dmax_below(DMAX);
  __builtin_assume(D > below && D <= DMAX);   // the dispatch's
  const float* L = ops + K * D;
  const float* dof = L + K * D * D;
  float* dof_row = smem + K * transform_rec_floats(D);
  if constexpr (SEED_PTR) {
    if (threadIdx.x == 0) store_seed_key(seed);
    if constexpr (!STAGED) __syncthreads();
  }
  if constexpr (STAGED) {
    stage_transform_records(smem, ops, L, K, D);
    stage_row_async(dof_row, dof, K);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  for (long long n = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       n < N; n += static_cast<long long>(gridDim.x) * blockDim.x) {
    auto rng = particle_stream<SEED_PTR>(seed, static_cast<uint64_t>(n));
    const int lat = latent[n];
    draw_rec<DMAX, STAGED>(
        rng, smem, ops, L, lat, D, student_t != 0,
        [&] { return STAGED ? dof_row[lat] : __ldg(dof + lat); },
        [&](int i, float v) { xT[i * N + n] = v; });
  }
}

template <bool RNG, bool SEED_PTR = false>
struct TransformRecKernels {
  template <int DMAX, bool STAGED>
  static auto get() {
    if constexpr (RNG) return &transform_rng_rec_kernel<DMAX, STAGED, SEED_PTR>;
    else return &transform_rec_kernel<DMAX, STAGED>;
  }
};

}  // namespace pmc

// the plan of fused_transform (rng 0) or fused_transform_rng (rng 1) for
// (K, D), checked against ops/_build.py transform_plan (draw_plan_out)
extern "C" long long pmc_transform_plan(int K, int D, int rng, int* out) {
  return pmc::draw_plan_out(pmc::transform_plan(K, D, false, rng != 0), D, out);
}

// the bucket pass: out = {threads of a block, particles a thread at
// least, blocks of a launch at most}; the shared memory of its largest
// block (the scatter's or, fused_transform's, the moves' rank block's),
// checked against
// ops/_build.py transform_bucket_plan
extern "C" long long pmc_transform_bucket_plan(int K, int* out) {
  using namespace pmc;
  out[0] = kBucketThreads;
  out[1] = kBucketItemsMin;
  out[2] = kBucketBlocksMax;
  const size_t scatter = bucket_smem_bytes(K), rank = rank_smem_bytes(K);
  return static_cast<long long>(scatter > rank ? scatter : rank);
}

// the scratch of N particles, K components and D rows: out = {perm, pos,
// the table (BucketLayout's offsets), the bucket pass's words, the pair's
// words (PairLayout), bucket_width, the bucket blocks}, checked
// against ops/_build.py transform_layout
extern "C" void pmc_transform_layout(long long N, int K, int D, long long* out) {
  using namespace pmc;
  const BucketLayout at(N, K);
  out[0] = at.perm;
  out[1] = at.pos;
  out[2] = at.table;
  out[3] = at.words;
  out[4] = PairLayout(N, K, D).words;
  out[5] = bucket_width(N, K);
  out[6] = bucket_blocks(N);
}

// blocks of fused_transform's tiled kernel that fit on one SM at once (the
// fewer of its two instantiations', the same at every shape), for the
// wrapper's grid; -1 on an error
extern "C" int pmc_transform_tiled_per_sm() {
  using namespace pmc;
  const auto per_sm = [&](auto kernel) {
    int n = 0;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(kTiledSmem));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kTileThreads, kTiledSmem);
    return err == cudaSuccess ? n : -1;
  };
  const int a = per_sm(transform_tiled_kernel<ParticleTiles, false>);
  const int b = per_sm(transform_tiled_kernel<RunTiles, true>);
  return a < b ? a : b;
}

// The bucket pass alone (chip_smoke.py holds its pos, perm and slots to
// ops/_build.py transform_tiles): scratch transform_scratch_words(N, K)
// int32
extern "C" int pmc_transform_buckets(const int* latent, int* scratch, long long N, int K,
                                     void* stream) {
  return pmc::launch_buckets(pmc::GivenLatents{latent}, scratch, N, K,
                             static_cast<cudaStream_t>(stream));
}

// blocks of the drawn products (fused_transform_rng's and
// fused_propose_logq's: the same shared memory, and at most 128 registers
// by their launch bounds) that fit on one SM at once at D (their shared
// memory grows past D = 128), for the wrappers' grids; -1 on an error
extern "C" int pmc_draw_tiled_per_sm(int D) { return pmc::draw_tiled_per_sm<0>(D); }

// blocks of fused_transform's (rng 0) or fused_transform_rng's (rng 1)
// record kernel for (K, D) that fit on one SM at once (0 where the plan
// takes another kernel, -1 on an error)
extern "C" int pmc_transform_per_sm(int K, int D, int rng) {
  using namespace pmc;
  const DrawPlan plan = transform_plan(K, D, false, rng != 0);
  return rng != 0 ? rec_per_sm<TransformRecKernels<true>>(plan, D)
                  : rec_per_sm<TransformRecKernels<false>>(plan, D);
}

// ops: mu (K, D) | L (K, D, D) | dof (K); zT, xT: (D, N), xT's memory D
// bucket_width(N, K) floats for the tiled pair at K > 1 (z in bucket order
// there); latent, scale: (N,); scratch: PairLayout(N, K, D).words int32
// (the tiled pair's at K > 1; may be null for the other kernels); variant:
// -1 the plan's kernel, 0 the looped kernel (D <= 128), 1 the record kernel
// (an error where the plan does not take it), 2 the tiled pair (any D to
// kWideDMax); n_blocks: the grid of the kernel (the tiled product's)
extern "C" int pmc_fused_transform(const float* zT, const int* latent,
                                   const float* scale, const float* ops, int* scratch,
                                   float* xT, long long N, int K, int D,
                                   int variant, int n_blocks, void* stream) {
  using namespace pmc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DrawPlan plan = transform_plan(K, D);
  if (takes_rec(plan, variant))
    return with_rec_kernel<TransformRecKernels<false>>(plan, D, [&](auto kernel) {
      kernel<<<n_blocks, plan.threads, plan.smem, s>>>(zT, latent, scale, ops, xT, N, K, D);
      return static_cast<int>(cudaGetLastError());
    });
  if (variant == 2 || (variant < 0 && plan.variant == kDrawTiled))
    return launch_transform_tiled(zT, latent, scale, ops, scratch, xT, N, K, D, n_blocks, s);
  if (D > kDMax) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = transform_plan(K, D, true).smem;
  PMC_DISPATCH_D(D, PMC_DISPATCH_OPS(smem > 0, {
    cudaFuncSetAttribute(transform_kernel<DMAX, OPS_SMEM>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    transform_kernel<DMAX, OPS_SMEM><<<n_blocks, kThreads, smem, s>>>(
        zT, latent, scale, ops, xT, N, K, D);
  }));
  return static_cast<int>(cudaGetLastError());
}

// seed_words: null (the words s0, s1) or two int64 on the card, read in the
// kernel (Seed); scratch: as pmc_fused_transform's (the drawn product's at
// K > 1); variant as pmc_fused_transform's, 2 the drawn product (any D to
// kWideDMax)
extern "C" int pmc_fused_transform_rng(unsigned int s0, unsigned int s1,
                                       const long long* seed_words, const int* latent,
                                       const float* ops, int* scratch, float* xT, long long N,
                                       int K, int D, int student_t, int variant, int n_blocks,
                                       void* stream) {
  using namespace pmc;
  const Seed seed{s0, s1, seed_words};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DrawPlan plan = transform_plan(K, D, false, true);
  if (takes_rec(plan, variant)) {
    const auto launch = [&](auto kernel) {
      kernel<<<n_blocks, plan.threads, plan.smem, s>>>(seed, latent, ops, xT, N, K, D,
                                                       student_t);
      return static_cast<int>(cudaGetLastError());
    };
    return seed_words == nullptr
        ? with_rec_kernel<TransformRecKernels<true, false>>(plan, D, launch)
        : with_rec_kernel<TransformRecKernels<true, true>>(plan, D, launch);
  }
  if (variant == 2 || (variant < 0 && plan.variant == kDrawTiled)) {
    const float* L = ops + static_cast<long long>(K) * D;
    return launch_draw_tiled<0>(seed, GivenLatents{latent}, latent, ops, L,
                                L + static_cast<long long>(K) * D * D, scratch, xT, nullptr, N,
                                K, D, student_t, n_blocks, s);
  }
  if (D > kDMax) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = transform_plan(K, D, true).smem;
  PMC_DISPATCH_D(D, PMC_DISPATCH_OPS(smem > 0, {
    cudaFuncSetAttribute(transform_rng_kernel<DMAX, OPS_SMEM>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    transform_rng_kernel<DMAX, OPS_SMEM><<<n_blocks, kThreads, smem, s>>>(
        seed, latent, ops, xT, N, K, D, student_t);
  }));
  return static_cast<int>(cudaGetLastError());
}
