// fused_logq: mixture log-density of transposed particles xT (D, N) -> (N,).
//
// Replaces the Pallas kernel pypmc_tpu/ops/pallas_kernels.py:788
// (fused_logq, body _logq_kernel).
//
// Bound on the H100: per particle it reads D floats and writes one, and
// does K (D (D + 1) / 2 + 1) FMAs plus K exp/log1p -- at K = 10, D = 10
// about 560 FMAs for 44 bytes, ~13 FMAs a byte against the card's FP32
// balance of ~10 (33.5 T FMA/s over 3.35 TB/s, published peaks): FMA-bound,
// with memory close behind.
// No tensor cores: a D = 10 product has no tile worth a wgmma.
// Design: one thread per particle (grid-stride), the particle in
// registers, the mixture operands in shared memory where they fit (every
// thread reads the same element at the same time: a broadcast), the
// whitened difference as a lower-triangular FMA chain, and a streaming
// weighted log-sum-exp, so no (K, N) or (K D, N) intermediate ever exists.
#include "common.cuh"

namespace pmc {

template <int DMAX, bool OPS_SMEM>
__global__ void __launch_bounds__(kThreads)
logq_kernel(const float* __restrict__ xT, const float* __restrict__ mix_src,
            float* __restrict__ out, long long N, int K, int D, int student_t) {
  extern __shared__ float smem[];
  const float* mix = stage_operands<OPS_SMEM>(smem, mix_src, MixLayout{K, D}.eval_size());
  __syncthreads();
  for (long long n = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       n < N; n += static_cast<long long>(gridDim.x) * blockDim.x) {
    float x[DMAX];
    load_particle<DMAX>(xT, N, n, D, x);
    out[n] = mixture_logpdf<DMAX>(mix, K, D, student_t != 0, x);
  }
}

}  // namespace pmc

// shared memory the launcher asks for: the operands if they fit, else none
extern "C" long long pmc_logq_smem_bytes(int K, int D) {
  const size_t ops = sizeof(float) * pmc::MixLayout{K, D}.eval_size();
  return static_cast<long long>(ops <= pmc::kSmemLimit ? ops : 0);
}

extern "C" int pmc_fused_logq(const float* xT, const float* mix, float* out,
                              long long N, int K, int D, int student_t,
                              int n_blocks, void* stream) {
  using namespace pmc;
  const size_t smem = pmc_logq_smem_bytes(K, D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PMC_DISPATCH_D(D, PMC_DISPATCH_OPS(smem > 0, {
    cudaFuncSetAttribute(logq_kernel<DMAX, OPS_SMEM>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    logq_kernel<DMAX, OPS_SMEM><<<n_blocks, kThreads, smem, s>>>(
        xT, mix, out, N, K, D, student_t);
  }));
  return static_cast<int>(cudaGetLastError());
}
