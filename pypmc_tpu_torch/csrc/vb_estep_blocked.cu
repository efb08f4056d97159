// fused_vb_estep_blocked: the statistics of one VB E-step (fused_vb_estep,
// vb_estep.cu) for mixtures past its one-tile limit -> the same float64 flat
// entry vector (N_comp, sd, lower g and, in the t1 entries, w r log r).
//
// Replaces the Pallas kernel pypmc_tpu/ops/pallas_kernels.py:1889
// (fused_vb_estep_blocked, body _vb_estep_blocked_kernel).
//
// Two launches, one call: vb_lse_kernel writes each particle's unweighted
// log-sum-exp l = log sum_k exp(c_k - |A_k (x - m_k)|^2 / 2) (one float a
// particle), then the statistics pass of blocked.cuh forms r_k = exp(c_k -
// |A_k (x - m_k)|^2 / 2 - l) chunk by chunk.  A zero weight (and a particle
// past N) contributes exactly 0.
//
// Bound on the H100: per particle it reads D + 1 floats; per (particle,
// component) it does the full projection twice (D^2 FMAs each), two exps and
// the statistics pass's shared-memory traffic -- as fused_pmc_stats_blocked.
#include "blocked.cuh"

namespace pmc {

// the unweighted log-sum-exp of the E-step's softmax, one particle a thread
template <int DMAX, bool OPS_SMEM>
__global__ void __launch_bounds__(kThreads)
vb_lse_kernel(const float* __restrict__ xT, const float* __restrict__ ops_src,
              float* __restrict__ out, long long N, int K, int D) {
  extern __shared__ float smem[];
  const float* A = stage_operands<OPS_SMEM>(smem, ops_src, K * (D * D + D + 1));
  __syncthreads();
  const float* m = A + K * D * D;
  const float* c = m + K * D;
  for (long long n = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       n < N; n += static_cast<long long>(gridDim.x) * blockDim.x) {
    float x[DMAX], diff[DMAX];
    load_particle<DMAX>(xT, N, n, D, x);
    WeightedLse lse;
    for (int k = 0; k < K; ++k)
      lse.add(c[k] - 0.5f * project<DMAX>(A + k * D * D, m + k * D, x, D, diff), 1.0f);
    out[n] = lse.value();
  }
}

}  // namespace pmc

// shared memory of the first launch: the operands if they fit, else none
static size_t vb_lse_smem(int K, int D) {
  const size_t ops = sizeof(float) * static_cast<size_t>(K) * (D * D + D + 1);
  return ops <= pmc::kSmemLimit ? ops : 0;
}

// ops: A (K, D, D) | m (K, D) | c (K); chunks: the same chunk-major
// (blocked.cuh); lse (N,) scratch; partial (n_blocks, S) float64 scratch;
// stats (S,) float64 output
extern "C" int pmc_fused_vb_estep_blocked(
    const float* xT, const float* w, const float* ops, const float* chunks,
    float* lse, double* partial, double* stats, long long N, int K, int D, int kc,
    int n_eval_blocks, int n_blocks, void* stream) {
  using namespace pmc;
  const size_t smem = vb_lse_smem(K, D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PMC_DISPATCH_D(D, PMC_DISPATCH_OPS(smem > 0, {
    cudaFuncSetAttribute(vb_lse_kernel<DMAX, OPS_SMEM>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    vb_lse_kernel<DMAX, OPS_SMEM><<<n_eval_blocks, kThreads, smem, s>>>(
        xT, ops, lse, N, K, D);
  }));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_blocked_stats<kBlockedVb, double>(
      xT, const_cast<float*>(w), lse, nullptr, chunks, partial, stats, N, K, D, kc,
      0, 0, n_blocks, s);
}

// the statistics pass's shared memory a block (checked against ops/_build.py)
extern "C" long long pmc_vb_estep_blocked_smem_bytes(int K, int D) {
  return static_cast<long long>(pmc::blocked_plan(K, D, true).smem);
}

// statistics-pass blocks that fit on one SM at once (-1 on an error)
extern "C" int pmc_vb_estep_blocked_per_sm(int K, int D) {
  return pmc::blocked_stats_per_sm<pmc::kBlockedVb>(K, D);
}
