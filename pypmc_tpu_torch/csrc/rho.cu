// fused_rho: Rao-Blackwellized responsibilities rho (K, N), n fastest, and
// the mixture log-density log q (N,) of transposed particles xT (D, N).
//
// Replaces the Pallas kernel pypmc_tpu/ops/pallas_kernels.py:826
// (fused_rho, body _rho_kernel).  As there, the ratio is taken in log
// space, rho_k = w_k exp(log q_k - log q), which needs no tiny, and a dead
// component (w_k = 0) gets exactly 0.
//
// Bound on the H100: per particle it reads D floats, writes K + 1 and does
// the K whitened evaluations of logq.cu (K D (D + 1) / 2 FMAs) -- at K = 32,
// D = 40 ~26,000 FMAs a particle: FMA-bound, like logq.cu, with the (K, N)
// responsibilities written and read back once (~0.08 ms at K = 32, N = 2^20
// at the card's peak bandwidth) beside it.  At K = 1, D = 200, 2^16 the
// bound is 0.040 ms of FP32 operations.
//
// Both kernels are fused_logq's with a store: each log q_k goes into the
// thread's own rho entry while the weighted log-sum-exp runs, k ascending,
// and after the last component the thread reads its K entries back (its own
// writes, in order) and writes rho_k and log q.  So log q is fused_logq's
// bit for bit, no K-sized register array exists, and each (k, n) access is
// coalesced.  D <= 64 (rho_kernel): logq.cu's record kernel -- 256 threads a
// block, one particle a thread in registers (DMAX 8 to 64), the components
// as 16-byte records streamed through shared memory in one buffer or two
// chunk buffers (common.cuh eval_plan, stream_records).  From D =
// kTiledDMin (rho_tiled_kernel): logq_tiled_kernel, the block-tiled FP32
// product engine of tiled.cuh on U_k (panels above the diagonal skipped),
// thread n % 128 holding particle n's log-sum-exp; a dead component's log
// q_k is stored and skipped in the sum.  What bounds it there is the
// engine's FMA issue, as for fused_logq (PERF.md section 6): the K (N,)
// rows of rho move 4 K bytes a particle against the D (D + 1) / 2 FMAs of
// each component.
#include "tiled.cuh"

namespace pmc {

template <int DMAX>
__global__ void __launch_bounds__(kEvalThreads, eval_min_blocks(DMAX))
rho_kernel(const float* __restrict__ xT, const float* __restrict__ mix,
           float* __restrict__ rho, float* __restrict__ log_q, long long N, int K, int D,
           int student_t) {
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
        records_lse<DMAX>(acc, recs, kc, D, student_t != 0, x, [&](int c, float ind) {
          if (n < N) rho[(k0 + c) * N + n] = ind;
        });
        if (k0 + kc == K && n < N) {
          const float lq = acc.value();
          for (int k = 0; k < K; ++k) {
            const float wk = mix[L.w() + k];
            rho[k * N + n] = wk > 0.0f ? expf(rho[k * N + n] - lq) * wk : 0.0f;
          }
          log_q[n] = lq;
        }
      });
}

__global__ void __launch_bounds__(kTileThreads, 2)
rho_tiled_kernel(const float* __restrict__ xT, const float* __restrict__ mix,
                 float* __restrict__ rho, float* __restrict__ log_q, long long N, int K, int D,
                 int student_t) {
  extern __shared__ float4 smem4[];
  const MixLayout L{K, D};
  WeightedLse lse;
  tiled_eval<true>(reinterpret_cast<float*>(smem4), xT, mix + L.U(), mix + L.mu(), N, K, D,
                   [&](int k, long long n, float maha) {
                     if (k == 0) lse = WeightedLse();
                     const float w = mix[L.w() + k];
                     const float ind = component_logpdf(maha, mix[L.ln() + k], mix[L.dof() + k],
                                                        D, student_t != 0);
                     if (w > 0.0f) lse.add(ind, w);
                     if (n >= N) return;
                     rho[k * N + n] = ind;
                     if (k == K - 1) {
                       const float lq = lse.value();
                       for (int j = 0; j < K; ++j) {
                         const float wj = mix[L.w() + j];
                         rho[j * N + n] = wj > 0.0f ? expf(rho[j * N + n] - lq) * wj : 0.0f;
                       }
                       log_q[n] = lq;
                     }
                   });
}

// fused_rho's kernels for with_eval_variant (the records of fused_logq)
struct RhoKernels {
  static constexpr bool maha = false;
  template <int DMAX>
  static auto rec() { return rho_kernel<DMAX>; }
  static auto tiled() { return rho_tiled_kernel; }
};

}  // namespace pmc

// shared memory the elected kernel asks for (checked against ops/_build.py)
extern "C" long long pmc_rho_smem_bytes(int K, int D) {
  return static_cast<long long>(pmc::eval_variant_smem(K, D, false));
}

// blocks of variant's kernel (-1 the elected one) that fit on one SM at once
// (registers, shared memory and threads), for the wrapper's grid; -1 on an
// error
extern "C" int pmc_rho_per_sm(int K, int D, int variant) {
  return pmc::eval_variant_per_sm<pmc::RhoKernels>(K, D, variant);
}

// mix: the packed evaluation operands (MixLayout); rho: (K, N); log_q: (N,);
// variant: as pmc_fused_logq's (-1 the elected kernel, 1 the record, 2 the
// tiled kernel)
extern "C" int pmc_fused_rho(const float* xT, const float* mix, float* rho,
                             float* log_q, long long N, int K, int D,
                             int student_t, int variant, int n_blocks, void* stream) {
  using namespace pmc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad = with_eval_variant<RhoKernels>(K, D, variant, [&](auto kernel, int threads,
                                                                     size_t smem) {
    kernel<<<n_blocks, threads, smem, s>>>(xT, mix, rho, log_q, N, K, D, student_t);
    return 0;
  });
  if (bad != 0) return bad;
  return static_cast<int>(cudaGetLastError());
}
