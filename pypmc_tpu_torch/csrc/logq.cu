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
// path, so each U word read feeds one FMA, ~1/4 of the FP32 peak.  From D =
// kTiledDMin (logq_tiled_kernel) the block-tiled product engine of tiled.cuh
// on U: the panels above the diagonal are skipped, and each component's
// squared distance goes through component_logpdf into a WeightedLse a
// particle, k ascending as in the other kernels (a dead component, w_k = 0,
// adds nothing), thread n % 128 holding particle n's; out[n] is written
// once.
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
        records_lse<DMAX>(acc, recs, kc, D, student_t != 0, x);
        if (k0 + kc == K && n < N) out[n] = acc.value();
      });
}

__global__ void __launch_bounds__(kTileThreads, 2)
logq_tiled_kernel(const float* __restrict__ xT, const float* __restrict__ mix,
                  float* __restrict__ out, long long N, int K, int D, int student_t) {
  extern __shared__ float4 smem4[];
  const MixLayout L{K, D};
  WeightedLse lse;
  tiled_eval<true>(reinterpret_cast<float*>(smem4), xT, mix + L.U(), mix + L.mu(), N, K, D,
                   [&](int k, long long n, float maha) {
                     if (k == 0) lse = WeightedLse();
                     const float w = mix[L.w() + k];
                     if (w > 0.0f)
                       lse.add(component_logpdf(maha, mix[L.ln() + k], mix[L.dof() + k], D,
                                                student_t != 0),
                               w);
                     if (k == K - 1 && n < N) out[n] = lse.value();
                   });
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

// components a chunk of the kernel of fused_logq (kernel 0), fused_maha (1)
// or fused_rho (2, whose records are fused_logq's): 1 where the elected
// kernel is the tiled one (a component at a time)
extern "C" int pmc_eval_chunk(int K, int D, int kernel) {
  if (pmc::eval_variant(D) == pmc::kEvalTiled) return 1;
  return pmc::eval_plan(K, D, kernel == 1).kc;
}

// the kernel fused_logq, fused_maha and fused_rho elect at D (1 record, 2
// tiled; checked against ops/_build.py eval_variant)
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
  return pmc::eval_variant_per_sm<pmc::LogqKernels>(K, D, variant);
}

// variant: as pmc_fused_maha's
extern "C" int pmc_fused_logq(const float* xT, const float* mix, float* out,
                              long long N, int K, int D, int student_t, int variant,
                              int n_blocks, void* stream) {
  using namespace pmc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad = with_eval_variant<LogqKernels>(K, D, variant, [&](auto kernel, int threads,
                                                                     size_t smem) {
    kernel<<<n_blocks, threads, smem, s>>>(xT, mix, out, N, K, D, student_t);
    return 0;
  });
  if (bad != 0) return bad;
  return static_cast<int>(cudaGetLastError());
}
