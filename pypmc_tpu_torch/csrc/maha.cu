// fused_maha: ||A_k (x - m_k)||^2 of transposed particles xT (D, N) for K
// general (D, D) matrices A_k -> (K, N), n fastest.
//
// Replaces the Pallas kernel pypmc_tpu/ops/pallas_kernels.py:858
// (fused_maha, body _maha_kernel).  The TPU kernel takes b_k = A_k m_k and
// a coordinate center to keep its split-precision product accurate; here
// the difference x - m_k is formed first and multiplied in FP32 FMA, so
// there is no cancellation to guard against.
//
// Bound on the H100: per particle it reads D floats, writes K, and does
// K D^2 FMAs -- at K = 10, D = 10 a thousand FMAs for 44 bytes read and 40
// written: FMA-bound in principle, and in practice bound by the one scalar
// shared-memory load each FMA's A entry takes (see logq.cu).  A is read
// whole: the callers pass lower (inverse Cholesky factors) and upper
// (transposed Cholesky factors of Wishart scales) matrices alike.
// Design: one thread per particle (grid-stride), the particle in registers,
// the operands A | m in shared memory where they fit (a broadcast read), and
// the K results written as K coalesced rows.
#include "common.cuh"

namespace pmc {

template <int DMAX, bool OPS_SMEM>
__global__ void __launch_bounds__(kThreads)
maha_kernel(const float* __restrict__ xT, const float* __restrict__ ops_src,
            float* __restrict__ out, long long N, int K, int D) {
  extern __shared__ float smem[];
  const float* A = stage_operands<OPS_SMEM>(smem, ops_src, K * D * D + K * D);
  __syncthreads();
  const float* m = A + K * D * D;
  for (long long n = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       n < N; n += static_cast<long long>(gridDim.x) * blockDim.x) {
    float x[DMAX], diff[DMAX];
    load_particle<DMAX>(xT, N, n, D, x);
    for (int k = 0; k < K; ++k)
      out[k * N + n] = project<DMAX>(A + k * D * D, m + k * D, x, D, diff);
  }
}

}  // namespace pmc

// shared memory the launcher asks for (checked against ops/_build.py): the
// operands if they fit, else none
extern "C" long long pmc_maha_smem_bytes(int K, int D) {
  const size_t ops = sizeof(float) * (static_cast<size_t>(K) * D * D + K * D);
  return static_cast<long long>(ops <= pmc::kSmemLimit ? ops : 0);
}

// ops: A (K, D, D) row-major | m (K, D); out: (K, N)
extern "C" int pmc_fused_maha(const float* xT, const float* ops, float* out,
                              long long N, int K, int D, int n_blocks,
                              void* stream) {
  using namespace pmc;
  const size_t smem = pmc_maha_smem_bytes(K, D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PMC_DISPATCH_D(D, PMC_DISPATCH_OPS(smem > 0, {
    cudaFuncSetAttribute(maha_kernel<DMAX, OPS_SMEM>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    maha_kernel<DMAX, OPS_SMEM><<<n_blocks, kThreads, smem, s>>>(xT, ops, out,
                                                                 N, K, D);
  }));
  return static_cast<int>(cudaGetLastError());
}
