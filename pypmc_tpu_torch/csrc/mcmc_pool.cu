// fused_mcmc_pool: C symmetric-proposal Metropolis chains, n_steps steps
// each, against a Gaussian or Student-t mixture target, in one launch ->
// points (n_steps, D, C), accepts (C,), nan_counts (C,), xf (D, C), ef (C,).
//
// Replaces the Pallas kernel pypmc_tpu/ops/pallas_kernels.py:2293
// (fused_mcmc_pool, body _mcmc_pool_kernel).  The TPU kernel carries a
// chain block's state in VMEM across a sequential step-chunk grid axis;
// here each thread owns one chain and loops over all n_steps itself, so
// nothing carries between blocks.  Per step: D Box-Muller normals, the
// proposal delta = L_c z (the chain's lower Cholesky factor), for a
// Student-t proposal delta *= sqrt(dof / chi2(dof)) with one scalar dof,
// the target's log-density at the proposal, and the accept against u drawn
// in (0, 1]: accept iff log_rho >= log u, so log_rho >= 0 always accepts; a
// NaN log_rho is counted and rejected.  The visited point (after the move)
// is written every step.
//
// Bound on the H100: the output stream, n_steps * D floats a chain (at
// C = 16384, D = 10, 500 steps: 328 MB), against the per-step work of a
// chain -- D (D + 1) / 2 FMAs of the proposal and K_target D (D + 1) / 2 of
// the target -- memory-bound at the pool's large shapes.  The pipeline's
// pool has 32 chains: one warp on one SM, whose time is the latency of
// n_steps dependent steps, not throughput.  Design: the chain state x (D)
// and its target value in registers (local memory for the DMAX = 128
// instantiation), the Cholesky factors in a chain-fastest layout, cholr
// [(d D + e) C + c], so a warp's loads coalesce and stay L1/L2-resident
// across steps, the target's operands in shared memory where they fit (a
// broadcast read), each step's point stored as one coalesced column of
// points, and the randomness from Philox keyed by the seed and counted by
// (chain, step): a chain's stream depends on neither the block size nor the
// number of chains.
#include "common.cuh"

namespace pmc {

template <int DMAX, bool OPS_SMEM>
__global__ void __launch_bounds__(kThreads)
mcmc_pool_kernel(uint32_t s0, uint32_t s1, const float* __restrict__ x0T,
                 const float* __restrict__ e0, const float* __restrict__ cholr,
                 float dof_prop, const float* __restrict__ tmix_src,
                 float* __restrict__ points, int* __restrict__ accepts,
                 int* __restrict__ nan_counts, float* __restrict__ xfT,
                 float* __restrict__ ef, int C, int n_steps, int Kt, int D,
                 int student_t_prop, int t_student_t) {
  extern __shared__ float smem[];
  const float* tmix = stage_operands<OPS_SMEM>(smem, tmix_src,
                                               MixLayout{Kt, D}.eval_size());
  __syncthreads();
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;

  float x[DMAX], prop[DMAX], z[DMAX];
  load_particle<DMAX>(x0T, C, c, D, x);
  float e = e0[c];
  int acc = 0, nans = 0;
  for (int step = 0; step < n_steps; ++step) {
    Philox rng(s0, s1, (static_cast<uint64_t>(step) << 32) | static_cast<uint32_t>(c));
    draw_normals<DMAX>(rng, D, z);
    const float scale = student_t_prop ? student_t_scale(dof_prop, rng) : 1.0f;
#pragma unroll
    for (int d = 0; d < dim_loop<DMAX>(D); ++d) {
      float s = 0.0f;
      if (d < D) {
#pragma unroll
        for (int j = 0; j <= d; ++j)
          s = fmaf(cholr[(static_cast<long long>(d) * D + j) * C + c], z[j], s);
      }
      prop[d] = d < D ? fmaf(scale, s, x[d]) : 0.0f;
    }
    const float e_prop = mixture_logpdf<DMAX>(tmix, Kt, D, t_student_t != 0, prop);
    const float log_u = logf(rng.uniform_pos());
    const float log_rho = e_prop - e;
    const bool is_nan = isnan(log_rho);
    if (!is_nan && log_rho >= log_u) {
#pragma unroll
      for (int d = 0; d < dim_loop<DMAX>(D); ++d) x[d] = prop[d];
      e = e_prop;
      ++acc;
    }
    nans += is_nan ? 1 : 0;
    store_particle<DMAX>(points + static_cast<long long>(step) * D * C, C, c, D, x);
  }
  store_particle<DMAX>(xfT, C, c, D, x);
  ef[c] = e;
  accepts[c] = acc;
  nan_counts[c] = nans;
}

}  // namespace pmc

// shared memory the launcher asks for (checked against ops/_build.py): the
// target's evaluation operands if they fit, else none
extern "C" long long pmc_mcmc_pool_smem_bytes(int Kt, int D) {
  const size_t ops = sizeof(float) * pmc::MixLayout{Kt, D}.eval_size();
  return static_cast<long long>(ops <= pmc::kSmemLimit ? ops : 0);
}

// x0T, xfT: (D, C); e0, ef, accepts, nan_counts: (C,); cholr: (D*D, C);
// points: (n_steps, D, C); tmix: the target's packed operands
extern "C" int pmc_fused_mcmc_pool(unsigned int s0, unsigned int s1,
                                   const float* x0T, const float* e0,
                                   const float* cholr, float dof_prop,
                                   const float* tmix, float* points,
                                   int* accepts, int* nan_counts, float* xfT,
                                   float* ef, int C, int n_steps, int Kt, int D,
                                   int student_t_prop, int t_student_t,
                                   void* stream) {
  using namespace pmc;
  const size_t smem = pmc_mcmc_pool_smem_bytes(Kt, D);
  const int n_blocks = (C + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PMC_DISPATCH_D(D, PMC_DISPATCH_OPS(smem > 0, {
    cudaFuncSetAttribute(mcmc_pool_kernel<DMAX, OPS_SMEM>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    mcmc_pool_kernel<DMAX, OPS_SMEM><<<n_blocks, kThreads, smem, s>>>(
        s0, s1, x0T, e0, cholr, dof_prop, tmix, points, accepts, nan_counts,
        xfT, ef, C, n_steps, Kt, D, student_t_prop, t_student_t);
  }));
  return static_cast<int>(cudaGetLastError());
}
