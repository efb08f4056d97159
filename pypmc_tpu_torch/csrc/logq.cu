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
// To D = 64 no tensor cores: the products are one particle's, in FP32.
// Past D = 64, 3 x 2 K D (D + 1) / 2 N TF32 operations at 495 TFLOP/s: at
// K = 19, D = 200, 2^16 0.30 ms, where the FP32 bound is 0.76 ms.
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
// path, so each U word read feeds one FMA, ~1/4 of the FP32 peak.  A
// squared distance that whiten_rec gives as not finite is recomputed from
// device memory with every entry of U read (maha_fp32_body), so a particle
// with an infinite coordinate gets the XLA path's -inf or NaN.
// Design, D > 64 (logq_mma_tiled_kernel, after mma_split_kernel<true> has
// split U's lower triangle into the wrapper's scratch): the paneled
// tensor-core walk of mma_tiled.cuh, fused_maha's past D = 64 (three split
// TF32 products, 128 particles x 128 rows a block), with the panels right
// of a row tile's last row and each warp's blocks wholly above the diagonal
// skipped; at a component's end thread p holds particle p's squared
// distance (recomputed by maha_fp32 where it is not finite) and LogqEpi
// (tiled.cuh) adds component_logpdf into its WeightedLse, k ascending as in
// the other kernels (a dead component, w_k = 0, adds nothing); out[n] is
// written once.  logq_tiled_kernel, the block-tiled FP32 engine of tiled.cuh
// with the same epilogue, is forced only (variant "tiled").
#include "tiled.cuh"

namespace pmc {

template <int DMAX>
__global__ void __launch_bounds__(kEvalThreads, eval_min_blocks(DMAX))
logq_kernel(const float* __restrict__ xT, const float* __restrict__ mix,
            float* __restrict__ out, long long N, int K, int D, int student_t) {
  extern __shared__ float4 smem4[];
  constexpr int below = eval_dmax_below(DMAX);
  __builtin_assume(D > below && D <= DMAX);   // dispatch_records'
  const MixLayout L{K, D};
  WeightedLse acc;
  stream_records<DMAX>(
      reinterpret_cast<float*>(smem4), xT, N, K, D, rec_floats(D), eval_plan(K, D, false),
      [&](float* dst, int k0, int kc) {
        stage_records_async(dst, mix + L.mu(), mix + L.U(), mix + L.ln(), 3, K, k0, kc, D, true);
      },
      [&](const float* recs, int k0, int kc, const float (&x)[DMAX], long long n) {
        if (k0 == 0) acc = WeightedLse();
        records_lse<DMAX>(acc, recs, kc, D, student_t != 0, x, [](int, float) {},
                          [&](int c, float maha) {
                            return isfinite(maha) || n >= N
                                       ? maha
                                       : maha_fp32_body(mix + L.U() + (k0 + c) * D * D,
                                                        mix + L.mu() + (k0 + c) * D, xT, N, D,
                                                        n);
                          });
        if (k0 + kc == K && n < N) out[n] = acc.value();
      });
}

__global__ void __launch_bounds__(kTileThreads, 2)
logq_tiled_kernel(const float* __restrict__ xT, const float* __restrict__ mix,
                  float* __restrict__ out, long long N, int K, int D, int student_t) {
  extern __shared__ float4 smem4[];
  const MixLayout L{K, D};
  LogqEpi epi{mix, out, N, K, D, student_t != 0};
  tiled_eval<true>(reinterpret_cast<float*>(smem4), xT, mix + L.U(), mix + L.mu(), N, K, D,
                   [&](int k, long long n, float maha) {
                     epi(k, n, eval_maha(xT, mix, N, K, D, k, n, maha));
                   });
}

// split: the split U of mix (mma_split_kernel<true>); one block an SM
__global__ void __launch_bounds__(kMtThreads, 1)
logq_mma_tiled_kernel(const float* __restrict__ xT, const float* __restrict__ mix,
                      const float4* __restrict__ split, float* __restrict__ out, long long N,
                      int K, int D, int student_t) {
  extern __shared__ float4 smem4[];
  const MixLayout L{K, D};
  LogqEpi epi{mix, out, N, K, D, student_t != 0};
  mma_tiled_walk<true>(reinterpret_cast<float*>(smem4), xT, mix + L.U(), mix + L.mu(), split, N,
                       K, D, epi);
}

// fused_logq's kernels for with_eval_variant
struct LogqKernels {
  static constexpr bool maha = false;
  template <int DMAX>
  static auto rec() { return logq_kernel<DMAX>; }
  static auto tiled() { return logq_tiled_kernel; }
};

}  // namespace pmc

// shared memory the elected kernel asks for (checked against ops/_build.py)
extern "C" long long pmc_logq_smem_bytes(int K, int D) {
  return static_cast<long long>(pmc::eval_variant_smem(K, D, false));
}

// components a chunk of the elected kernel of fused_logq (kernel 0),
// fused_maha (1) or fused_rho (2, whose records are fused_logq's): 1 where
// it is the tiled one or a tensor-core kernel past D = 64 (a component at a
// time)
extern "C" int pmc_eval_chunk(int K, int D, int kernel) {
  const int v = kernel == 1 ? pmc::maha_variant(D) : pmc::eval_variant(D);
  if (v == pmc::kEvalTiled || (v == pmc::kEvalMma && D > pmc::kRecDMax)) return 1;
  return v == pmc::kEvalMma ? pmc::mma_plan(K, D).kc : pmc::eval_plan(K, D, kernel == 1).kc;
}

// the kernel fused_logq and fused_rho elect at D (1 record, 3 tensor-core;
// checked against ops/_build.py eval_variant; fused_maha's: pmc_maha_variant)
extern "C" int pmc_eval_variant(int D) { return pmc::eval_variant(D); }

// the tiled kernels' plan: out = {particles a tile, rows a row tile, depth
// of a panel, threads a block}; the shared memory a block
extern "C" long long pmc_tiled_plan(int* out) {
  out[0] = pmc::kTileP;
  out[1] = pmc::kTileM;
  out[2] = pmc::kTileK;
  out[3] = pmc::kTileThreads;
  return static_cast<long long>(pmc::kTiledSmem);
}

// blocks of variant's kernel (-1 the elected one) that fit on one SM at once
// (registers, shared memory and threads), for the wrapper's grid; -1 on an
// error
extern "C" int pmc_logq_per_sm(int K, int D, int variant) {
  using namespace pmc;
  if (eval_mma_tiled(D, variant, false)) return mma_tiled_per_sm(logq_mma_tiled_kernel);
  return eval_variant_per_sm<LogqKernels>(K, D, variant);
}

// variant: as pmc_fused_maha's (the tensor-core kernel past D = 64 only);
// scratch: mma_scratch_floats(K, D) floats, 16-byte aligned, where that is
// the kernel (else unused), U split into it first (mma_split_kernel<true>)
extern "C" int pmc_fused_logq(const float* xT, const float* mix, float* scratch, float* out,
                              long long N, int K, int D, int student_t, int variant,
                              int n_blocks, void* stream) {
  using namespace pmc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (eval_mma_tiled(D, variant, false))
    return launch_mma_tiled<true>(logq_mma_tiled_kernel, mix + MixLayout{K, D}.U(), scratch, K, D,
                                  n_blocks, s, [&](const float4* split) {
                                    logq_mma_tiled_kernel<<<n_blocks, kMtThreads, kMmaTiledSmem,
                                                            s>>>(xT, mix, split, out, N, K, D,
                                                                 student_t);
                                  });
  const int bad = with_eval_variant<LogqKernels>(K, D, variant, [&](auto kernel, int threads,
                                                                     size_t smem) {
    kernel<<<n_blocks, threads, smem, s>>>(xT, mix, out, N, K, D, student_t);
    return 0;
  });
  if (bad != 0) return bad;
  return static_cast<int>(cudaGetLastError());
}
