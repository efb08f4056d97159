// fused_propose_logq: draw N particles from a Gaussian or Student-t mixture
// and evaluate the proposal log-density (and optionally a mixture target's)
// on them -> xT (D, N), latent (N,), log_q (N,) [, log_p (N,)].
//
// Replaces the Pallas kernel pypmc_tpu/ops/pallas_kernels.py:924
// (fused_propose_logq, body _propose_logq_kernel, _propose_tile).
//
// Bound on the H100: it reads nothing per particle and writes D + 3 words;
// the work is the draw (Philox, Box-Muller, for Student-t a Marsaglia-Tsang
// loop: transcendentals on the SFU) plus (K + K_target) whitened
// evaluations at D (D + 1) / 2 FMAs each -- FP32-FMA- and SFU-bound, with
// the store stream far below the card's bandwidth.  No tensor cores at
// D = 10.  Design: one thread per particle with a Philox stream keyed by the
// seed and counted by the particle's global index (so the samples do not
// depend on the launch configuration), the sample kept in registers and
// evaluated there (it is written to device memory once and never re-read),
// both mixtures' operands in shared memory where they fit.
#include "common.cuh"

namespace pmc {

template <int DMAX, bool OPS_SMEM>
__global__ void __launch_bounds__(kThreads)
propose_logq_kernel(uint32_t s0, uint32_t s1, const float* __restrict__ mix_src,
                    const float* __restrict__ tmix_src, float* __restrict__ xT,
                    int* __restrict__ latent, float* __restrict__ log_q,
                    float* __restrict__ log_p, long long N, int K, int Kt, int D,
                    int student_t, int t_student_t) {
  extern __shared__ float smem[];
  const int n_mix = MixLayout{K, D}.size();
  const float* mix = stage_operands<OPS_SMEM>(smem, mix_src, n_mix);
  const float* tmix = log_p == nullptr ? nullptr
      : stage_operands<OPS_SMEM>(smem + n_mix, tmix_src, MixLayout{Kt, D}.eval_size());
  __syncthreads();
  for (long long n = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       n < N; n += static_cast<long long>(gridDim.x) * blockDim.x) {
    Philox rng(s0, s1, static_cast<uint64_t>(n));
    float x[DMAX];
    latent[n] = propose_particle<DMAX>(mix, K, D, student_t != 0, rng, x);
    store_particle<DMAX>(xT, N, n, D, x);
    log_q[n] = mixture_logpdf<DMAX>(mix, K, D, student_t != 0, x);
    if (log_p != nullptr)
      log_p[n] = mixture_logpdf<DMAX>(tmix, Kt, D, t_student_t != 0, x);
  }
}

}  // namespace pmc

// shared memory the launcher asks for (checked against ops/_build.py): both
// mixtures' operands (Kt = 0 without a target) if they fit, else none
extern "C" long long pmc_propose_logq_smem_bytes(int K, int Kt, int D) {
  const size_t ops = sizeof(float) * (pmc::MixLayout{K, D}.size() +
                                      pmc::MixLayout{Kt, D}.eval_size());
  return static_cast<long long>(ops <= pmc::kSmemLimit ? ops : 0);
}

// tmix/log_p are null without a target
extern "C" int pmc_fused_propose_logq(unsigned int s0, unsigned int s1,
                                      const float* mix, const float* tmix,
                                      float* xT, int* latent, float* log_q,
                                      float* log_p, long long N, int K, int Kt,
                                      int D, int student_t, int t_student_t,
                                      int n_blocks, void* stream) {
  using namespace pmc;
  const size_t smem = pmc_propose_logq_smem_bytes(K, log_p != nullptr ? Kt : 0, D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PMC_DISPATCH_D(D, PMC_DISPATCH_OPS(smem > 0, {
    cudaFuncSetAttribute(propose_logq_kernel<DMAX, OPS_SMEM>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    propose_logq_kernel<DMAX, OPS_SMEM><<<n_blocks, kThreads, smem, s>>>(
        s0, s1, mix, tmix, xT, latent, log_q, log_p, N, K, Kt, D, student_t,
        t_student_t);
  }));
  return static_cast<int>(cudaGetLastError());
}
