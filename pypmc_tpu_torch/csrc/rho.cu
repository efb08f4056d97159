// fused_rho: Rao-Blackwellized responsibilities rho (K, N), n fastest, and
// the mixture log-density log q (N,) of transposed particles xT (D, N).
//
// Replaces the Pallas kernel pypmc_tpu/ops/pallas_kernels.py:826
// (fused_rho, body _rho_kernel).  As there, the ratio is taken in log
// space, rho_k = w_k exp(log q_k - log q), which needs no tiny, and a dead
// component (w_k = 0) gets exactly 0.
//
// Bound on the H100: per particle it reads D floats, writes K + 1 and does
// the K whitened evaluations of logq.cu (K D (D + 1) / 2 FMAs): at K = 10,
// D = 10 about 560 FMAs for 44 bytes read and 44 written, bound like
// logq.cu by the shared-memory load of each FMA's operand.
// Design: logq.cu's thread per particle and operands in shared memory where
// they fit.  The first pass over the components parks each log q_k in the
// thread's own rho entries while the streaming log-sum-exp runs; the second
// pass reads them back (the same thread's writes, in order) and writes rho.
// So the kernel needs no K-sized register array and no shared memory beyond
// the operands, and each of its (K, N) writes is coalesced.
#include "common.cuh"

namespace pmc {

template <int DMAX, bool OPS_SMEM>
__global__ void __launch_bounds__(kThreads)
rho_kernel(const float* __restrict__ xT, const float* __restrict__ mix_src,
           float* __restrict__ rho, float* __restrict__ log_q, long long N,
           int K, int D, int student_t) {
  extern __shared__ float smem[];
  const MixLayout L{K, D};
  const float* mix = stage_operands<OPS_SMEM>(smem, mix_src, L.eval_size());
  __syncthreads();
  for (long long n = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       n < N; n += static_cast<long long>(gridDim.x) * blockDim.x) {
    float x[DMAX], diff[DMAX];
    load_particle<DMAX>(xT, N, n, D, x);
    WeightedLse lse;
    for (int k = 0; k < K; ++k) {
      const float maha = whiten<DMAX>(mix + L.U() + k * D * D,
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

}  // namespace pmc

// shared memory the launcher asks for (checked against ops/_build.py): the
// operands if they fit, else none
extern "C" long long pmc_rho_smem_bytes(int K, int D) {
  const size_t ops = sizeof(float) * pmc::MixLayout{K, D}.eval_size();
  return static_cast<long long>(ops <= pmc::kSmemLimit ? ops : 0);
}

// mix: the packed evaluation operands (MixLayout); rho: (K, N); log_q: (N,)
extern "C" int pmc_fused_rho(const float* xT, const float* mix, float* rho,
                             float* log_q, long long N, int K, int D,
                             int student_t, int n_blocks, void* stream) {
  using namespace pmc;
  const size_t smem = pmc_rho_smem_bytes(K, D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PMC_DISPATCH_D(D, PMC_DISPATCH_OPS(smem > 0, {
    cudaFuncSetAttribute(rho_kernel<DMAX, OPS_SMEM>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    rho_kernel<DMAX, OPS_SMEM><<<n_blocks, kThreads, smem, s>>>(
        xT, mix, rho, log_q, N, K, D, student_t);
  }));
  return static_cast<int>(cudaGetLastError());
}
