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
// rather than memory-bound.
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
// as D coalesced rows.  fused_transform_rng takes its looped kernel from D
// = 65 to 128, fused_transform from D = 65 below kTransformTiledDMin; both
// take them anywhere to D = 128, forced, as the bit-exact yardstick.  The
// TPU's one-hot selector contractions over all K components become one
// indexed read: a thread touches only its own component.  The Philox
// stream of a particle is keyed by the seed and counted by the particle's
// index, as in propose_logq.cu, so the samples do not depend on the launch
// configuration.  Past D = 128 fused_transform_rng's warp kernel takes a
// particle a warp (warp.cuh): the normals in a slice of shared memory,
// drawn by the lanes block by block from the particle's Philox stream, so
// they are the thread path's, and the rows of L on the lanes, read from
// device memory.
//
// fused_transform from D = kTransformTiledDMin: two launches, both
// graph-capturable (no count is read on the host).  transform_bucket_kernel
// sorts the particles by component, a counting sort a chunk of
// kBucketChunk particles a block: warp w counts its 1,024 particles' latents
// a component (__match_any_sync: one shared add a group of lanes), the
// block turns the counts into each warp's first position in each bucket
// and the buckets' starts and tiles, and each particle's index goes to perm
// at its bucket's start, its warp's position and its rank among the lanes
// before it.  The order is the particles' within each (chunk, component):
// one input gives one perm.  The block also writes its chunk's slots, one
// tile of up to 128 particles of one component each ({k, start, len, 0};
// ceil(len / 128) + K slots a chunk, the tiles first and k = -1 after), so
// the slots are ceil(N / 128) + K a chunk at most and no count is needed
// before the launch.  The buckets are a chunk's because one launch has no
// barrier across its blocks, which buckets over all N particles would need
// between the counts and the scatter.  transform_tiled_kernel walks the
// slots on a grid of one wave, a block skipping the empty slots of its
// stride, on the tiled engine (tiled.cuh BucketTiles): L_k's panels (those
// above the diagonal skipped) and the gathered z panel, no m panel, and
// StoreEpi's row-tile epilogue writes x_i = fmaf(scale_n, s, mu_i) to each
// particle's own column.  Its accumulators run j ascending from 0 as
// affine_transform's, and the zeros above the diagonal add fmaf(0, z, s) =
// s, so its output is the looped kernel's bit for bit (up to the sign of a
// zero) wherever both run.  What bounds it: the FMA issue of the tile's
// product, as in the evaluations (PERF.md section 6), beside the gathers of
// z and the scattered stores of x, 4 bytes a particle-coordinate, whose
// sectors the other components' tiles share.
#include "tiled.cuh"
#include "warp.cuh"

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
constexpr int kDrawTiled = 3;   // DrawPlan::variant of fused_transform's tiled pair

// The plan of fused_transform (rng false) or fused_transform_rng (rng true)
// for (K, D) (mirrored by ops/_build.py transform_plan): draw_plan's, the
// record kernel's records the K draw records (and fused_transform_rng's K
// dofs), the looped kernel's operands the buffer mu | L | dof;
// fused_transform's tiled pair from kTransformTiledDMin (kTileThreads, the
// tiled engine's shared memory; ``looped`` forces the looped kernel to D =
// 128).
inline DrawPlan transform_plan(int K, int D, bool looped = false, bool rng = false) {
  if (!rng && !looped && D >= kTransformTiledDMin)
    return {kDrawTiled, false, kTileThreads, kTiledSmem};
  return draw_plan(D, static_cast<size_t>(K) * (transform_rec_floats(D) + (rng ? 1 : 0)),
                   transform_floats(K, D), looped);
}

// ---------------------------------------------------------------------
// fused_transform's tiled pair: the bucket kernel and the tiled product
// ---------------------------------------------------------------------
// 1,024 threads of 32 particles each.  A thread reads its latents again
// for the scatter (from L2) rather than keep them in registers: kept, they
// spilled the 64 registers a thread of 1,024 has (as 32 ints, and as 16
// two-latent words, the unrolled loads' addresses beside them), and at 512
// threads of 64 the 128 of 512
constexpr int kBucketThreads = 1024;
constexpr int kBucketItems = 32;                      // particles a thread
constexpr int kBucketChunk = kBucketThreads * kBucketItems;
constexpr int kBucketWarps = kBucketThreads / 32;

// slots of a full chunk: its tiles, at most one partial a component
__host__ __device__ constexpr long long bucket_chunk_slots(int K) {
  return kBucketChunk / kTileP + K;
}
// the slots of N particles: full chunks', then the last chunk's
// ceil(len / 128) + K
__host__ __device__ inline long long bucket_slots(long long N, int K) {
  if (N <= 0) return 0;
  const long long chunks = (N + kBucketChunk - 1) / kBucketChunk;
  const long long last = N - (chunks - 1) * kBucketChunk;
  return (chunks - 1) * bucket_chunk_slots(K) + (last + kTileP - 1) / kTileP + K;
}
// shared memory of a bucket block: a warp's count a component, then the
// buckets' starts and tiles (K + 1 each)
__host__ __device__ inline size_t bucket_smem_bytes(int K) {
  return sizeof(int) * (static_cast<size_t>(kBucketWarps) * K + 2 * (K + 1));
}
// int32 words of the scratch: perm (N, padded to 4: the slots are int4),
// then the slots
__host__ __device__ inline long long transform_scratch_words(long long N, int K) {
  return (N + 3) / 4 * 4 + 4 * bucket_slots(N, K);
}

// The counting sort of chunk blockIdx.x: perm's entries of the chunk list
// its particles by component (the chunk's bucket k at its start + the
// counts of the buckets before), each bucket's particles in their order,
// and the chunk's slots (from blockIdx.x * bucket_chunk_slots(K)) its tiles,
// bucket by bucket, then empty slots (k = -1).  A latent outside [0, K) is
// left out (its column of x is not written).
__global__ void __launch_bounds__(kBucketThreads)
transform_bucket_kernel(const int* __restrict__ latent, int* __restrict__ perm,
                        int4* __restrict__ slots, long long N, int K) {
  extern __shared__ int bsm[];
  int* hist = bsm;                          // kBucketWarps x K
  int* start = hist + kBucketWarps * K;     // K + 1: the chunk's buckets
  int* tile0 = start + K + 1;               // K + 1: their first tiles
  const long long c0 = static_cast<long long>(blockIdx.x) * kBucketChunk;
  const int len = static_cast<int>(min(static_cast<long long>(kBucketChunk), N - c0));
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  for (int i = threadIdx.x; i < kBucketWarps * K; i += kBucketThreads) hist[i] = 0;
  // warp w's particles: chunk positions (w kBucketItems + r) 32 + lane; -1
  // past the chunk or outside [0, K)
  const auto lat = [&](int r) {
    const int i = (w * kBucketItems + r) * 32 + lane;
    const int v = i < len ? __ldg(latent + c0 + i) : -1;
    return v >= 0 && v < K ? v : -1;
  };
  __syncthreads();
#pragma unroll 8
  for (int r = 0; r < kBucketItems; ++r) {
    const int k = lat(r);
    const unsigned g = __match_any_sync(0xffffffffu, k);
    if (k >= 0 && lane == __ffs(g) - 1) hist[w * K + k] += __popc(g);
    __syncwarp();
  }
  __syncthreads();
  // each bucket's warps in order: hist[w][k] becomes warp w's first
  // position in bucket k, start[k] the bucket's count
  for (int k = threadIdx.x; k < K; k += kBucketThreads) {
    int run = 0;
    for (int v = 0; v < kBucketWarps; ++v) {
      const int c = hist[v * K + k];
      hist[v * K + k] = run;
      run += c;
    }
    start[k] = run;
  }
  __syncthreads();
  // warp 0: the exclusive scans over k of the counts and of their tiles
  if (w == 0) {
    int base = 0, tbase = 0;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + lane;
      const int n = k < K ? start[k] : 0;
      const int tiles = (n + kTileP - 1) / kTileP;
      int sn = n, st = tiles;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int a = __shfl_up_sync(0xffffffffu, sn, o), b = __shfl_up_sync(0xffffffffu, st, o);
        if (lane >= o) {
          sn += a;
          st += b;
        }
      }
      if (k < K) {
        start[k] = base + sn - n;
        tile0[k] = tbase + st - tiles;
      }
      base += __shfl_sync(0xffffffffu, sn, 31);
      tbase += __shfl_sync(0xffffffffu, st, 31);
    }
    if (lane == 0) {
      start[K] = base;
      tile0[K] = tbase;
    }
  }
  __syncthreads();
  // the chunk's slots: tile j of bucket k at slot tile0[k] + j
  const long long s0 = static_cast<long long>(blockIdx.x) * bucket_chunk_slots(K);
  const int n_slots = (len + kTileP - 1) / kTileP + K;
  for (int l = threadIdx.x; l < n_slots; l += kBucketThreads) {
    int4 e = make_int4(-1, 0, 0, 0);
    if (l < tile0[K]) {
      int lo = 0, hi = K - 1;   // the last bucket whose first tile is at or before l
      while (lo < hi) {
        const int mid = (lo + hi + 1) / 2;
        if (tile0[mid] <= l) lo = mid;
        else hi = mid - 1;
      }
      const int first = start[lo] + (l - tile0[lo]) * kTileP;
      e = make_int4(lo, static_cast<int>(c0 + first), min(kTileP, start[lo + 1] - first), 0);
    }
    slots[s0 + l] = e;
  }
  // the scatter, warp w's particles in order
#pragma unroll 8
  for (int r = 0; r < kBucketItems; ++r) {
    const int k = lat(r);
    const unsigned g = __match_any_sync(0xffffffffu, k);
    int pos = 0;
    if (k >= 0) pos = start[k] + hist[w * K + k] + __popc(g & ((1u << lane) - 1u));
    __syncwarp();
    if (k >= 0) {
      perm[c0 + pos] = static_cast<int>(c0 + (w * kBucketItems + r) * 32 + lane);
      if (lane == __ffs(g) - 1) hist[w * K + k] += __popc(g);
    }
    __syncwarp();
  }
}

// fused_transform's row-tile epilogue: x_i = fmaf(scale_n, s, mu_k[i]) to
// particle n's column of xT, for the thread's rows below D and its tile
// columns that hold a particle.  The tile's particles are kept in shared
// memory (two tiles' worth, the next written while the last is computed).
struct StoreEpi {
  int* cols;   // 2 x kTileP
  const float* scale;
  const float* mu;
  float* xT;
  long long N;
  int D;
  template <typename Src, typename Tile>
  __device__ void tile(const Src& src, long long t, const Tile& tile, int q) {
    if (threadIdx.x < kTileP)
      cols[(q & 1) * kTileP + threadIdx.x] = static_cast<int>(src.col(t, tile));
  }
  template <typename Src, typename Step>
  __device__ void row_end(const Src&, const Step& s, int q, float (&acc)[8][8], int ty, int tx) {
    const int* c = cols + (q & 1) * kTileP;
    int n[8];
    float sc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      n[j] = c[tile_col(tx, j)];
      sc[j] = n[j] >= 0 ? __ldg(scale + n[j]) : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = tile_row(s.rt, ty, r);
      if (i < D) {
        const float m = __ldg(mu + static_cast<long long>(s.k) * D + i);
        float* row = xT + static_cast<long long>(i) * N;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (n[j] >= 0) row[n[j]] = fmaf(sc[j], acc[r][j], m);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[r][j] = 0.0f;
    }
  }
  template <typename Src, typename Step>
  __device__ void k_end(const Src&, const Step&, int) {}
};

// ops: mu (K, D) | L (K, D, D) | dof (K); the slots and perm of
// transform_bucket_kernel
__global__ void __launch_bounds__(kTileThreads, 2)
transform_tiled_kernel(const float* __restrict__ zT, const float* __restrict__ scale,
                       const float* __restrict__ ops, const int* __restrict__ perm,
                       const int4* __restrict__ slots, float* __restrict__ xT, long long N,
                       int K, int D, long long n_slots) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  StoreEpi epi{reinterpret_cast<int*>(smem + kTileRedOffset), scale, ops, xT, N, D};
  tiled_walk<true, false>(smem, zT, ops + static_cast<long long>(K) * D, nullptr, N, D,
                          BucketTiles{slots, perm, n_slots}, epi);
}

// The bucket kernel on stream s, a block a chunk: perm and the slots into
// scratch, transform_scratch_words(N, K) int32, 16-byte aligned (perm, then
// the slots).  Its error, or cudaErrorInvalidValue past its limits.
int launch_transform_buckets(const int* latent, int* scratch, long long N, int K,
                             cudaStream_t s) {
  const size_t bsmem = bucket_smem_bytes(K);
  if (K < 1 || N < 1 || N > 0x7fffffffLL || bsmem > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      transform_bucket_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bsmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  transform_bucket_kernel<<<static_cast<int>((N + kBucketChunk - 1) / kBucketChunk),
                            kBucketThreads, bsmem, s>>>(
      latent, scratch, reinterpret_cast<int4*>(scratch + (N + 3) / 4 * 4), N, K);
  return static_cast<int>(cudaGetLastError());
}

// The tiled pair on stream s: the bucket kernel, then the tiled kernel on
// n_blocks blocks; scratch as launch_transform_buckets'.
int launch_transform_tiled(const float* zT, const int* latent, const float* scale,
                           const float* ops, int* scratch, float* xT, long long N, int K, int D,
                           int n_blocks, cudaStream_t s) {
  if (D < 1 || D > kWideDMax) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  int err = launch_transform_buckets(latent, scratch, N, K, s);
  if (err != 0) return err;
  err = static_cast<int>(cudaFuncSetAttribute(transform_tiled_kernel,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              static_cast<int>(kTiledSmem)));
  if (err != 0) return err;
  transform_tiled_kernel<<<n_blocks, kTileThreads, kTiledSmem, s>>>(
      zT, scale, ops, scratch, reinterpret_cast<const int4*>(scratch + (N + 3) / 4 * 4), xT, N,
      K, D, bucket_slots(N, K));
  return static_cast<int>(cudaGetLastError());
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

__global__ void __launch_bounds__(kWideThreads)
transform_rng_warp_kernel(const Seed seed, const int* __restrict__ latent,
                          const float* __restrict__ ops, float* __restrict__ xT,
                          long long N, int K, int D, int student_t) {
  extern __shared__ float smem[];
  const WarpSlices sl = warp_slices(smem, D);
  const float* L = ops + static_cast<long long>(K) * D;
  const float* dof = L + static_cast<long long>(K) * D * D;
  for (long long n = warp_index(); n < N; n += warp_count()) {
    // draw_component's stream: the normals, then the Student-t scale
    warp_normals(seed.w0(), seed.w1(), static_cast<uint64_t>(n), 0, D,
                 reinterpret_cast<uint32_t*>(sl.a), sl.b);
    const int lat = latent[n];
    float scale = 1.0f;
    if (student_t != 0) {
      if (lane_id() == 0) {
        Philox rng = stream_at(seed.w0(), seed.w1(), static_cast<uint64_t>(n),
                               normal_words_end(0, D));
        scale = student_t_scale(dof[lat], rng);
      }
      scale = from_lane0(scale);
    }
    warp_affine(L + static_cast<long long>(lat) * D * D, ops + lat * D, sl.b, scale, D,
                [&](int i, float v) { xT[i * N + n] = v; });
    __syncwarp();   // the slices are rewritten next
  }
}

}  // namespace pmc

// the plan of fused_transform (rng 0) or fused_transform_rng (rng 1) for
// (K, D), checked against ops/_build.py transform_plan (draw_plan_out)
extern "C" long long pmc_transform_plan(int K, int D, int rng, int* out) {
  return pmc::draw_plan_out(pmc::transform_plan(K, D, false, rng != 0), D, out);
}

// fused_transform's tiled pair: out = {threads of a bucket block,
// particles a chunk, slots of a full chunk}; the bucket block's shared
// memory (checked against ops/_build.py transform_bucket_plan)
extern "C" long long pmc_transform_bucket_plan(int K, int* out) {
  out[0] = pmc::kBucketThreads;
  out[1] = pmc::kBucketChunk;
  out[2] = static_cast<int>(pmc::bucket_chunk_slots(K));
  return static_cast<long long>(pmc::bucket_smem_bytes(K));
}

// blocks of fused_transform's tiled kernel that fit on one SM at once (the
// same at every shape), for the wrapper's grid; -1 on an error
extern "C" int pmc_transform_tiled_per_sm() {
  using namespace pmc;
  int n = 0;
  cudaError_t err = cudaFuncSetAttribute(transform_tiled_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kTiledSmem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, transform_tiled_kernel, kTileThreads,
                                                        kTiledSmem);
  return err == cudaSuccess ? n : -1;
}

// The bucket kernel alone (chip_smoke.py holds its perm and slots to
// ops/_build.py transform_tiles): scratch as pmc_fused_transform's
extern "C" int pmc_transform_buckets(const int* latent, int* scratch, long long N, int K,
                                     void* stream) {
  return pmc::launch_transform_buckets(latent, scratch, N, K, static_cast<cudaStream_t>(stream));
}

// blocks of fused_transform's (rng 0) or fused_transform_rng's (rng 1)
// record kernel for (K, D) that fit on one SM at once (0 where the plan
// takes another kernel, -1 on an error)
extern "C" int pmc_transform_per_sm(int K, int D, int rng) {
  using namespace pmc;
  const DrawPlan plan = transform_plan(K, D, false, rng != 0);
  return rng != 0 ? rec_per_sm<TransformRecKernels<true>>(plan, D)
                  : rec_per_sm<TransformRecKernels<false>>(plan, D);
}

// ops: mu (K, D) | L (K, D, D) | dof (K); zT, xT: (D, N); latent, scale:
// (N,); scratch: transform_scratch_words(N, K) int32 (the tiled pair's; may
// be null for the other kernels); variant: -1 the plan's kernel, 0 the
// looped kernel (D <= 128), 1 the record kernel (an error where the plan
// does not take it), 2 the tiled pair (any D to kWideDMax); n_blocks: the
// grid of the kernel (the tiled pair's second)
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
  if (variant == 2 || (variant < 0 && plan.variant == kDrawTiled)) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return launch_transform_tiled(zT, latent, scale, ops, scratch, xT, N, K, D, n_blocks, s);
  }
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
// kernel (Seed); variant as pmc_fused_transform's
extern "C" int pmc_fused_transform_rng(unsigned int s0, unsigned int s1,
                                       const long long* seed_words, const int* latent,
                                       const float* ops, float* xT, long long N, int K,
                                       int D, int student_t, int variant, int n_blocks,
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
  if (D > kDMax && D <= kWideDMax) {
    if (variant == 0) return static_cast<int>(cudaErrorInvalidValue);
    return launch_warp(transform_rng_warp_kernel, D, n_blocks, s, seed, latent, ops, xT, N,
                       K, D, student_t);
  }
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
