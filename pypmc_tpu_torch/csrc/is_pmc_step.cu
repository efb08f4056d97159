// fused_is_pmc_step: the particle work of one whole PMC step against a
// mixture target in one pass -> xT (D, N), latent (N,), w (N,) and the flat
// statistics vector of stats.cuh (sum w, sum w^2, sum w log w at its end).
//
// Replaces the Pallas kernel pypmc_tpu/ops/pallas_kernels.py:1336
// (fused_is_pmc_step, body _is_pmc_kernel).
//
// Bound on the H100: it reads nothing per particle and writes D + 2 words;
// the work is the draw (Philox, Box-Muller, Marsaglia-Tsang on the SFU),
// K + K_target whitened evaluations (D (D + 1) / 2 FMAs each) and the
// statistics phase of stats.cuh -- FP32-FMA-, SFU- and shared-memory-bound.
// No tensor cores at D = 10.  Design: the draw of propose_logq.cu
// (one thread per particle, Philox counted by the global particle index)
// feeding the statistics tile of stats.cuh while the sample is still in
// registers: samples and weights are written once and never re-read.
// Particles past N draw nothing and get weight 0, which zeroes every
// factor of every statistic they touch.
#include "stats.cuh"

namespace pmc {

template <int DMAX, bool OPS_SMEM, int TW>
__global__ void __launch_bounds__(kThreads)
is_pmc_step_kernel(uint32_t s0, uint32_t s1, const float* __restrict__ mix_src,
                   const float* __restrict__ tmix_src, float* __restrict__ xT,
                   int* __restrict__ latent, float* __restrict__ wts,
                   double* __restrict__ partial, long long N, int K, int Kt,
                   int D, int student_t, int t_student_t, int dof_stats) {
  extern __shared__ float smem[];
  const StatsLayout S{K, D, TW};   // stats_layout's tile, TW threads
  const int n_mix = MixLayout{K, D}.size();
  const int n_staged = OPS_SMEM ? n_mix + MixLayout{Kt, D}.eval_size() : 0;
  float* tile = smem + n_staged;
  double* acc = reinterpret_cast<double*>(
      reinterpret_cast<char*>(smem) + stats_acc_offset(S, n_staged));
  uint16_t* table = reinterpret_cast<uint16_t*>(acc + S.entries());
  const float* mix = stage_operands<OPS_SMEM>(smem, mix_src, n_mix);
  const float* tmix = stage_operands<OPS_SMEM>(smem + n_mix, tmix_src,
                                               MixLayout{Kt, D}.eval_size());
  stats_setup(S, tile, acc, table);
  __syncthreads();

  const int t = threadIdx.x;
  const long long n_tiles = (N + S.tw - 1) / S.tw;
  for (long long tile_i = blockIdx.x; tile_i < n_tiles; tile_i += gridDim.x) {
    const long long n = tile_i * S.tw + t;
    float x[DMAX];
#pragma unroll
    for (int i = 0; i < dim_loop<DMAX>(D); ++i) x[i] = 0.0f;
    if (n < N) {
      Philox rng(s0, s1, static_cast<uint64_t>(n));
      latent[n] = propose_particle<DMAX>(mix, K, D, student_t != 0, rng, x);
      store_particle<DMAX>(xT, N, n, D, x);
    }
    const float log_q = stats_evaluate<DMAX>(mix, S, student_t != 0, x, tile, t);
    float w = 0.0f;
    if (n < N) {
      w = expf(mixture_logpdf<DMAX>(tmix, Kt, D, t_student_t != 0, x) - log_q);
      wts[n] = w;
    }
    stats_finish(mix, S, student_t != 0, dof_stats != 0, log_q, w, tile, t);
    __syncthreads();
    stats_accumulate<TW>(S, tile, acc, table);
    __syncthreads();
  }
  stats_write_partial(S, acc, partial);
}

}  // namespace pmc

extern "C" int pmc_fused_is_pmc_step(unsigned int s0, unsigned int s1,
                                     const float* mix, const float* tmix,
                                     float* xT, int* latent, float* w,
                                     double* partial, float* stats, long long N,
                                     int K, int Kt, int D, int student_t,
                                     int t_student_t, int dof_stats,
                                     int n_blocks, void* stream) {
  using namespace pmc;
  const StatsLayout S = stats_layout(K, D);
  const int params = MixLayout{K, D}.size() + MixLayout{Kt, D}.eval_size();
  const size_t smem = stats_launch_smem(S, params);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!stats_tile_built(S, D)) return static_cast<int>(cudaErrorInvalidValue);
  const auto launch = [&](auto kernel) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    kernel<<<n_blocks, S.tw, smem, s>>>(s0, s1, mix, tmix, xT, latent, w, partial, N, K, Kt, D,
                                        student_t, t_student_t, dof_stats);
  };
  PMC_DISPATCH_D(D, PMC_DISPATCH_OPS(stats_ops_smem(S, params), {
    PMC_STATS_TILE(S, is_pmc_step_kernel, launch);
  }));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  launch_reduce(partial, stats, n_blocks, S.entries(), s);
  return static_cast<int>(cudaGetLastError());
}
