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
// (344 MB, 0.103 ms at K = 32, D = 40, N = 2^20); fused_transform_rng reads
// one word and writes D, and its Philox, Box-Muller and (Student-t)
// Marsaglia-Tsang work is SFU- and integer-bound rather than memory-bound.
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
// as D coalesced rows.  Both take them from D = 65 to 128 (and anywhere to
// D = 128, forced, as the yardstick).  The TPU's one-hot selector contractions over all K components
// become one indexed read: a thread touches only its own component.  The
// Philox stream of a particle is keyed by the seed and counted by the
// particle's index, as in propose_logq.cu, so the samples do not depend on
// the launch configuration.  Past D = 128 (the *_warp_kernel pair) a warp
// takes a particle (warp.cuh): the normals in a slice of shared memory,
// drawn by the lanes block by block from the particle's Philox stream, so
// they are the thread path's, and the rows of L on the lanes, read from
// device memory.
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

// The plan of fused_transform (rng false) or fused_transform_rng (rng true)
// for (K, D) (mirrored by ops/_build.py transform_plan): draw_plan's, the
// record kernel's records the K draw records (and fused_transform_rng's K
// dofs), the looped kernel's operands the buffer mu | L | dof.
inline DrawPlan transform_plan(int K, int D, bool looped = false, bool rng = false) {
  return draw_plan(D, static_cast<size_t>(K) * (transform_rec_floats(D) + (rng ? 1 : 0)),
                   transform_floats(K, D), looped);
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
transform_warp_kernel(const float* __restrict__ zT, const int* __restrict__ latent,
                      const float* __restrict__ scale, const float* __restrict__ ops,
                      float* __restrict__ xT, long long N, int K, int D) {
  extern __shared__ float smem[];
  const WarpSlices sl = warp_slices(smem, D);
  const float* L = ops + static_cast<long long>(K) * D;
  for (long long n = warp_index(); n < N; n += warp_count()) {
    warp_load(zT, N, n, D, sl.a);
    const int lat = latent[n];
    warp_affine(L + static_cast<long long>(lat) * D * D, ops + lat * D, sl.a, scale[n], D,
                [&](int i, float v) { xT[i * N + n] = v; });
    __syncwarp();   // the slice is rewritten next
  }
}

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
// (N,); variant: -1 the plan's kernel, 0 the looped kernel (D <= 128), 1 the
// record kernel (an error where the plan does not take it)
extern "C" int pmc_fused_transform(const float* zT, const int* latent,
                                   const float* scale, const float* ops,
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
  if (D > kDMax && D <= kWideDMax) {
    if (variant == 0) return static_cast<int>(cudaErrorInvalidValue);
    return launch_warp(transform_warp_kernel, D, n_blocks, s, zT, latent, scale, ops, xT, N,
                       K, D);
  }
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
