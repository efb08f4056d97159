// fused_logq: mixture log-density of transposed particles xT (D, N) -> (N,).
//
// Replaces the Pallas kernel pypmc_tpu/ops/pallas_kernels.py:788
// (fused_logq, body _logq_kernel).
//
// Bound on the H100: per particle it reads D floats and writes one, and
// does K (D (D + 1) / 2 + 1) FMAs plus K exp/log1p -- at K = 10, D = 10
// about 560 FMAs for 44 bytes, ~13 FMAs a byte against the card's FP32
// balance of ~10 (33.5 T FMA/s over 3.35 TB/s, published peaks): FMA-bound,
// with memory close behind; at K = 32, D = 40 ~26,000 FMAs a particle.
// No tensor cores: the products are one particle's, in FP32.
// Design, D <= 64 (logq_kernel): 256 threads a block, one particle a
// thread, its coordinates and x - mu in registers (DMAX 8 to 64), the
// components as 16-byte records (common.cuh rec_floats: U's rows padded to
// float4s) read by broadcast LDS.128 in whiten's FMA order, and a streaming
// weighted log-sum-exp carried across the component chunks, k ascending, so
// no (K, N) intermediate exists and one chunk or many give the same result.
// The records stream through shared memory (common.cuh eval_plan,
// stream_records): the whole mixture where it fits an SM's half (K = 200,
// D = 10: 70,400 B, 3 blocks an SM), else chunks in two buffers filled by
// cp.async while the other is read (K = 32, D = 40: 11 components a chunk,
// 2 blocks an SM).  What holds it (measured on one H100): a broadcast
// LDS.128 takes ~4 clocks of the SM's 128 B a clock of shared-memory data
// path, so each U word read feeds one FMA, ~1/4 of the FP32 peak.  Past D =
// 64 (logq_looped_kernel) the looped DMAX = 128 instantiation reads the
// packed operands, staged whole where they fit; past D = 128
// (logq_warp_kernel) a warp takes a particle (warp.cuh), the operands read
// from device memory.
#include "warp.cuh"

namespace pmc {

template <int DMAX>
__global__ void __launch_bounds__(kEvalThreads, eval_min_blocks(DMAX))
logq_kernel(const float* __restrict__ xT, const float* __restrict__ mix,
            float* __restrict__ out, long long N, int K, int D, int student_t) {
  extern __shared__ float4 smem4[];
  constexpr int below = eval_dmax_below(DMAX);
  __builtin_assume(D > below && D <= DMAX);   // dispatch_eval's
  const MixLayout L{K, D};
  WeightedLse acc;
  stream_records<DMAX>(
      reinterpret_cast<float*>(smem4), xT, N, K, D, rec_floats(D), eval_plan(K, D, false),
      [&](float* dst, int k0, int kc) {
        stage_records_async(dst, mix + L.mu(), mix + L.U(), mix + L.ln(), 3, K, k0, kc, D, true);
      },
      [&](const float* recs, int k0, int kc, const float (&x)[DMAX], long long n) {
        if (k0 == 0) acc = WeightedLse();
        records_lse<DMAX>(acc, recs, kc, D, student_t != 0, x);
        if (k0 + kc == K && n < N) out[n] = acc.value();
      });
}

template <bool OPS_SMEM>
__global__ void __launch_bounds__(kThreads)
logq_looped_kernel(const float* __restrict__ xT, const float* __restrict__ mix_src,
                 float* __restrict__ out, long long N, int K, int D, int student_t) {
  extern __shared__ float smem[];
  const float* mix = stage_operands<OPS_SMEM>(smem, mix_src, MixLayout{K, D}.eval_size());
  __syncthreads();
  for (long long n = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       n < N; n += static_cast<long long>(gridDim.x) * blockDim.x) {
    float x[kDMax];
    load_particle<kDMax>(xT, N, n, D, x);
    out[n] = mixture_logpdf<kDMax>(mix, K, D, student_t != 0, x);
  }
}

__global__ void __launch_bounds__(kWideThreads)
logq_warp_kernel(const float* __restrict__ xT, const float* __restrict__ mix,
                 float* __restrict__ out, long long N, int K, int D, int student_t) {
  extern __shared__ float smem[];
  const WarpSlices sl = warp_slices(smem, D);
  for (long long n = warp_index(); n < N; n += warp_count()) {
    warp_load(xT, N, n, D, sl.a);
    const float lq = warp_mixture_logpdf(mix, K, D, student_t != 0, sl.a, sl.b);
    if (lane_id() == 0) out[n] = lq;
    __syncwarp();   // the slices are rewritten next
  }
}

// fused_logq's kernels for with_eval_kernel
struct LogqKernels {
  static constexpr bool maha = false;
  template <int DMAX, bool OPS_SMEM>
  static auto get() {
    if constexpr (DMAX <= kRecDMax) return logq_kernel<DMAX>;
    else if constexpr (DMAX <= kDMax) return logq_looped_kernel<OPS_SMEM>;
    else return logq_warp_kernel;
  }
};

}  // namespace pmc

// shared memory the launcher asks for (checked against ops/_build.py)
extern "C" long long pmc_logq_smem_bytes(int K, int D) {
  return static_cast<long long>(pmc::eval_plan(K, D, false).smem);
}

// components a chunk of fused_logq's (maha 0) or fused_maha's kernel
extern "C" int pmc_eval_chunk(int K, int D, int maha) {
  return pmc::eval_plan(K, D, maha != 0).kc;
}

// blocks that fit on one SM at once (registers, shared memory and threads),
// for the wrapper's grid; -1 on an error
extern "C" int pmc_logq_per_sm(int K, int D) {
  return pmc::eval_per_sm<pmc::LogqKernels>(K, D);
}

extern "C" int pmc_fused_logq(const float* xT, const float* mix, float* out,
                              long long N, int K, int D, int student_t,
                              int n_blocks, void* stream) {
  using namespace pmc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad = with_eval_kernel<LogqKernels>(K, D, [&](auto kernel, int threads, size_t smem) {
    kernel<<<n_blocks, threads, smem, s>>>(xT, mix, out, N, K, D, student_t);
    return 0;
  });
  if (bad != 0) return bad;
  return static_cast<int>(cudaGetLastError());
}
