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
// at the card's peak bandwidth) beside it.
// Design, D <= 64 (rho_kernel): logq.cu's record kernel -- 256 threads a
// block, one particle a thread in registers (DMAX 8 to 64), the components
// as 16-byte records streamed through shared memory in one buffer or two
// chunk buffers (common.cuh eval_plan, stream_records) -- whose per-component
// hook parks each log q_k in the thread's own rho entry while the streaming
// log-sum-exp runs; after the last chunk a second loop over k reads them
// back (the same thread's writes, in order) and writes rho.  So log q is
// fused_logq's bit for bit, no K-sized register array exists, and each
// (k, n) access is coalesced.  Past D = 64 (rho_looped_kernel) the looped
// DMAX = 128 instantiation reads the packed operands, staged whole where
// they fit; past D = 128 (rho_warp_kernel) a warp takes a particle
// (warp.cuh).
#include "warp.cuh"

namespace pmc {

template <int DMAX>
__global__ void __launch_bounds__(kEvalThreads, eval_min_blocks(DMAX))
rho_kernel(const float* __restrict__ xT, const float* __restrict__ mix,
           float* __restrict__ rho, float* __restrict__ log_q, long long N, int K, int D,
           int student_t) {
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

template <bool OPS_SMEM>
__global__ void __launch_bounds__(kThreads)
rho_looped_kernel(const float* __restrict__ xT, const float* __restrict__ mix_src,
                  float* __restrict__ rho, float* __restrict__ log_q, long long N,
                  int K, int D, int student_t) {
  extern __shared__ float smem[];
  const MixLayout L{K, D};
  const float* mix = stage_operands<OPS_SMEM>(smem, mix_src, L.eval_size());
  __syncthreads();
  for (long long n = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       n < N; n += static_cast<long long>(gridDim.x) * blockDim.x) {
    float x[kDMax], diff[kDMax];
    load_particle<kDMax>(xT, N, n, D, x);
    WeightedLse lse;
    for (int k = 0; k < K; ++k) {
      const float maha = whiten<kDMax>(mix + L.U() + k * D * D,
                                       mix + L.mu() + k * D, x, D, diff);
      const float ind = component_logpdf(maha, mix[L.ln() + k],
                                         mix[L.dof() + k], D, student_t != 0);
      rho[k * N + n] = ind;
      lse.add(ind, mix[L.w() + k]);
    }
    const float lq = lse.value();
    for (int k = 0; k < K; ++k) {
      const float wk = mix[L.w() + k];
      rho[k * N + n] = wk > 0.0f ? expf(rho[k * N + n] - lq) * wk : 0.0f;
    }
    log_q[n] = lq;
  }
}

__global__ void __launch_bounds__(kWideThreads)
rho_warp_kernel(const float* __restrict__ xT, const float* __restrict__ mix,
                float* __restrict__ rho, float* __restrict__ log_q, long long N, int K,
                int D, int student_t) {
  extern __shared__ float smem[];
  const WarpSlices sl = warp_slices(smem, D);
  const MixLayout L{K, D};
  for (long long n = warp_index(); n < N; n += warp_count()) {
    warp_load(xT, N, n, D, sl.a);
    WeightedLse acc;
    for (int k = 0; k < K; ++k) {
      const float* U = mix + L.U() + static_cast<long long>(k) * D * D;
      const float maha = warp_maha([&](int i) { return U + static_cast<long long>(i) * D; },
                                   mix + L.mu() + k * D, sl.a, sl.b, D, true);
      const float ind = component_logpdf(maha, mix[L.ln() + k], mix[L.dof() + k], D,
                                         student_t != 0);
      if (lane_id() == 0) rho[k * N + n] = ind;
      acc.add(ind, mix[L.w() + k]);
    }
    const float lq = acc.value();
    __syncwarp();   // lane 0's log q_k, read back by the lanes
    for (int k = lane_id(); k < K; k += 32) {
      const float wk = mix[L.w() + k];
      rho[k * N + n] = wk > 0.0f ? expf(rho[k * N + n] - lq) * wk : 0.0f;
    }
    if (lane_id() == 0) log_q[n] = lq;
    __syncwarp();   // the slices are rewritten next
  }
}

// fused_rho's kernels for with_eval_kernel (the records of fused_logq)
struct RhoKernels {
  static constexpr bool maha = false;
  template <int DMAX, bool OPS_SMEM>
  static auto get() {
    if constexpr (DMAX <= kRecDMax) return rho_kernel<DMAX>;
    else if constexpr (DMAX <= kDMax) return rho_looped_kernel<OPS_SMEM>;
    else return rho_warp_kernel;
  }
};

}  // namespace pmc

// shared memory the launcher asks for (checked against ops/_build.py)
extern "C" long long pmc_rho_smem_bytes(int K, int D) {
  return static_cast<long long>(pmc::eval_plan(K, D, false).smem);
}

// blocks that fit on one SM at once (registers, shared memory and threads),
// for the wrapper's grid; -1 on an error
extern "C" int pmc_rho_per_sm(int K, int D) {
  return pmc::eval_per_sm<pmc::RhoKernels>(K, D);
}

// mix: the packed evaluation operands (MixLayout); rho: (K, N); log_q: (N,)
extern "C" int pmc_fused_rho(const float* xT, const float* mix, float* rho,
                             float* log_q, long long N, int K, int D,
                             int student_t, int n_blocks, void* stream) {
  using namespace pmc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad = with_eval_kernel<RhoKernels>(K, D, [&](auto kernel, int threads, size_t smem) {
    kernel<<<n_blocks, threads, smem, s>>>(xT, mix, rho, log_q, N, K, D, student_t);
    return 0;
  });
  if (bad != 0) return bad;
  return static_cast<int>(cudaGetLastError());
}
