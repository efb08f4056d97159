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
// fused_transform up to D = 64 (transform_rec_kernel): 256 threads a block,
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
//
// The looped kernels (transform_kernel, transform_rng_kernel): one thread a
// particle, the whole operand buffer mu | L | dof staged in shared memory
// where it fits (threads of a warp read different components' entries: bank
// conflicts, not a broadcast), the product as a lower-triangular FMA chain
// in registers up to D = 32 (local memory past it), the result written once
// as D coalesced rows.  fused_transform takes them from D = 65 to 128 (and
// anywhere, forced, as the yardstick); fused_transform_rng everywhere to D
// = 128.  The TPU's one-hot selector contractions over all K components
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
transform_rng_kernel(uint32_t s0, uint32_t s1, const int* __restrict__ latent,
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
    Philox rng(s0, s1, static_cast<uint64_t>(n));
    float x[DMAX];
    draw_component<DMAX>(mu, L, dof, latent[n], D, student_t != 0, rng, x);
    store_particle<DMAX>(xT, N, n, D, x);
  }
}

// floats of one component's record in transform_rec_kernel: mu (D) | L's
// lower triangle by row (row i at D + i (i + 1) / 2, its i + 1 entries),
// made odd (the last word of an even count is a pad, never read)
__host__ __device__ inline int transform_rec_floats(int D) { return (D + D * (D + 1) / 2) | 1; }

struct TransformPlan {
  int variant;    // 0 the looped kernel, 1 the record kernel, 2 the warp kernel
  bool staged;    // the record kernel's records in shared memory
  int threads;    // a block
  size_t smem;    // shared memory a block asks for
};

// The plan of fused_transform for (K, D) (mirrored by ops/_build.py
// transform_plan): up to D = 64 the record kernel, its records staged where
// they fit half an SM (two blocks), else read from device memory; the looped
// kernel to D = 128 (operands staged where they fit kSmemLimit); past it the
// warp kernel.  ``looped`` forces the looped kernel where D <= 128.
inline TransformPlan transform_plan(int K, int D, bool looped = false) {
  if (D > kDMax) return {2, false, kWideThreads, wide_smem_bytes(D)};
  if (D > kRecDMax || looped) {
    const size_t ops = sizeof(float) * transform_floats(K, D);
    return {0, ops <= kSmemLimit, kThreads, ops <= kSmemLimit ? ops : 0};
  }
  const size_t recs = sizeof(float) * K * transform_rec_floats(D);
  return {1, recs <= kHalfSmem, kEvalThreads, recs <= kHalfSmem ? recs : 0};
}

// The records of all K components at dst by cp.async, from mu (K, D) and L
// (K, D, D): one record row (mu, or row i of L) a warp at a time, so that
// each is read coalesced.  Commit after, and wait and __syncthreads() before
// reading.
__device__ inline void stage_transform_records(float* dst, const float* mu, const float* L,
                                               int K, int D) {
  const int F = transform_rec_floats(D), lane = threadIdx.x % 32;
  for (int row = threadIdx.x / 32; row < K * (D + 1); row += blockDim.x / 32) {
    const int k = row / (D + 1), i = row - k * (D + 1) - 1;
    const int len = i < 0 ? D : i + 1;
    float* out = dst + k * F + (i < 0 ? 0 : D + i * (i + 1) / 2);
    const float* src = i < 0 ? mu + k * D : L + (static_cast<long long>(k) * D + i) * D;
    for (int t = lane; t < len; t += 32) cp_async_f32(out + t, src + t, true);
  }
}

// x = mu + scale * (L z) for one component, row i emitted as emit(i, x_i) as
// soon as it is formed, in affine_transform's FMA order; mu(i) and l(i, j)
// read the component's operands
template <int DMAX, typename Mu, typename Lij, typename Emit>
__device__ __forceinline__ void lower_affine(const float (&z)[DMAX], float scale, int D,
                                             Mu&& mu, Lij&& l, Emit&& emit) {
#pragma unroll
  for (int i = 0; i < DMAX; ++i) {
    if (i < D) {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j <= i; ++j) s = fmaf(l(i, j), z[j], s);
      emit(i, fmaf(scale, s, mu(i)));
    }
  }
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
  const int F = transform_rec_floats(D);
  for (long long n = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       n < N; n += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int lat = latent[n];
    float z[DMAX];
    load_particle<DMAX>(zT, N, n, D, z);
    const float sc = scale[n];
    const auto emit = [&](int i, float v) { xT[i * N + n] = v; };
    if constexpr (STAGED) {
      const float* rec = smem + lat * F;
      const float* tri = rec + D;
      lower_affine<DMAX>(
          z, sc, D, [&](int i) { return rec[i]; },
          [&](int i, int j) { return tri[i * (i + 1) / 2 + j]; }, emit);
    } else {
      const float* mu = ops + lat * D;
      const float* Lk = L + static_cast<long long>(lat) * D * D;
      lower_affine<DMAX>(
          z, sc, D, [&](int i) { return __ldg(mu + i); },
          [&](int i, int j) { return __ldg(Lk + i * D + j); }, emit);
    }
  }
}

// Call body(kernel, plan) with the record kernel for (K, D) and its plan,
// the shared memory set first as the kernel's limit; body's result, or the
// error of the dispatch or of setting the limit.
template <typename Body>
int with_transform_rec_kernel(int K, int D, Body&& body) {
  const TransformPlan plan = transform_plan(K, D);
  if (plan.variant != 1) return static_cast<int>(cudaErrorInvalidValue);
  auto each = [&](auto dmax, auto) {
    constexpr int DMAX = decltype(dmax)::value;
    const auto kernel =
        plan.staged ? &transform_rec_kernel<DMAX, true> : &transform_rec_kernel<DMAX, false>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(plan.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    return body(kernel, plan);
  };
  return dispatch_records(D, each, EvalInsts());
}

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
transform_rng_warp_kernel(uint32_t s0, uint32_t s1, const int* __restrict__ latent,
                          const float* __restrict__ ops, float* __restrict__ xT,
                          long long N, int K, int D, int student_t) {
  extern __shared__ float smem[];
  const WarpSlices sl = warp_slices(smem, D);
  const float* L = ops + static_cast<long long>(K) * D;
  const float* dof = L + static_cast<long long>(K) * D * D;
  for (long long n = warp_index(); n < N; n += warp_count()) {
    // draw_component's stream: the normals, then the Student-t scale
    warp_normals(s0, s1, static_cast<uint64_t>(n), 0, D, reinterpret_cast<uint32_t*>(sl.a),
                 sl.b);
    const int lat = latent[n];
    float scale = 1.0f;
    if (student_t != 0) {
      if (lane_id() == 0) {
        Philox rng = stream_at(s0, s1, static_cast<uint64_t>(n), normal_words_end(0, D));
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

// shared memory of fused_transform_rng's launcher, and of fused_transform's
// looped kernel (checked against ops/_build.py): the operands if they fit,
// else none; past D = 128 the warp kernels' slices
extern "C" long long pmc_transform_smem_bytes(int K, int D) {
  return static_cast<long long>(pmc::transform_plan(K, D, true).smem);
}

// fused_transform's plan for (K, D), checked against ops/_build.py
// transform_plan: out = {variant (0 looped, 1 record, 2 warp), records
// staged, a record's floats (the record kernel; else 0), threads a block};
// the shared memory a block
extern "C" long long pmc_transform_plan(int K, int D, int* out) {
  const pmc::TransformPlan plan = pmc::transform_plan(K, D);
  out[0] = plan.variant;
  out[1] = plan.staged ? 1 : 0;
  out[2] = plan.variant == 1 ? pmc::transform_rec_floats(D) : 0;
  out[3] = plan.threads;
  return static_cast<long long>(plan.smem);
}

// blocks of fused_transform's record kernel for (K, D) that fit on one SM at
// once (0 where the plan takes another kernel, -1 on an error)
extern "C" int pmc_transform_per_sm(int K, int D) {
  using namespace pmc;
  if (transform_plan(K, D).variant != 1) return 0;
  int n = 0;
  const int err = with_transform_rec_kernel(K, D, [&](auto kernel, const TransformPlan& plan) {
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, plan.threads, plan.smem));
  });
  return err == 0 ? n : -1;
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
  const TransformPlan plan = transform_plan(K, D);
  if (variant == 1 || (variant < 0 && plan.variant == 1)) {
    const int bad = with_transform_rec_kernel(K, D, [&](auto kernel, const TransformPlan& p) {
      kernel<<<n_blocks, p.threads, p.smem, s>>>(zT, latent, scale, ops, xT, N, K, D);
      return 0;
    });
    if (bad != 0) return bad;
    return static_cast<int>(cudaGetLastError());
  }
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

extern "C" int pmc_fused_transform_rng(unsigned int s0, unsigned int s1,
                                       const int* latent, const float* ops,
                                       float* xT, long long N, int K, int D,
                                       int student_t, int n_blocks, void* stream) {
  using namespace pmc;
  const size_t smem = transform_plan(K, D, true).smem;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D > kDMax && D <= kWideDMax)
    return launch_warp(transform_rng_warp_kernel, D, n_blocks, s, s0, s1, latent, ops, xT, N,
                       K, D, student_t);
  PMC_DISPATCH_D(D, PMC_DISPATCH_OPS(smem > 0, {
    cudaFuncSetAttribute(transform_rng_kernel<DMAX, OPS_SMEM>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    transform_rng_kernel<DMAX, OPS_SMEM><<<n_blocks, kThreads, smem, s>>>(
        s0, s1, latent, ops, xT, N, K, D, student_t);
  }));
  return static_cast<int>(cudaGetLastError());
}
