// fused_vb_estep: the sufficient statistics of one variational-Bayes
// Gaussian-mixture E-step ([Bis06] 10.46, 10.49, 10.51-10.53, 10.75) in
// one pass over weighted particles xT (D, N), w (N,).
//
// Replaces the Pallas kernel pypmc_tpu/ops/pallas_kernels.py:1493
// (fused_vb_estep, body _vb_estep_kernel).
//
// Operands, one flat float32 buffer: A (K, D, D) | m (K, D) | c (K), with
// A_k = sqrt(nu_k) chol(W_k)^T (UPPER triangular) and c_k = E[ln pi_k] +
// (E[ln |Lambda_k|] - D ln 2 pi - D / beta_k) / 2, so that log rho_k = c_k -
// |A_k (x - m_k)|^2 / 2.  Per particle: the plain (unweighted) log-sum-exp
// over k, r_k = exp(log rho_k - lse), and the entries of stats.cuh with
// these rows:
//   wrho = c = w r_k, t1 = w r_k log r_k, diff = A_k (x - m_k),
// so s0 = N_k, sd = sum w r diff (whitened first moment), g = lower
// triangle of sum w r diff diff^T (whitened second moment), and
// sum_k t1_k = sum_n w_n sum_k r log r (10.75).  The caller un-whitens with
// triangular solves.  A zero weight (and a particle past N) contributes
// exactly 0.
//
// Bound on the H100: K D (D + 1) / 2 FMAs of the projection and K (D (D + 1)
// / 2 + D) of the statistics a particle, for 4 (D + 1) bytes read: FP32-
// and shared-memory-bound.  Three designs (reg_stats.cuh dense_plan), as
// fused_pmc_stats' (pmc_stats.cu):
//   D <= 16, where it fits shared memory: reg_stats.cuh's register kernel,
//     one launch, the projection reading only A's upper triangle from
//     16-byte records (D (D + 1) / 2 FMAs, not D^2) and the statistics in
//     float32 registers, D + 3 shared reads a (particle, component);
//   D = 17 .. 128 where K D <= 128 (the JAX rule's reach there):
//     gram_stats.cuh's Gram pass in its VB mode, the K projections on
//     register micro-tiles (the coordinates reversed, so that A's upper
//     triangle is whitened as U's lower one) and the statistics as a
//     weighted SYRK, 64 FMAs for 5 shared loads;
//   elsewhere the entry-table kernel below: the tile of stats.cuh, ~3
//     shared reads for each of the K (3 + D + D (D + 1) / 2) + 3 entries a
//     particle, the projection reading all of A (project).
// Either reduces in float64 within a block and over blocks in a fixed order,
// into float64 outputs.
#include "reg_stats.cuh"

namespace pmc {

template <int DMAX, bool OPS_SMEM, int TW>
__global__ void __launch_bounds__(kThreads)
vb_estep_kernel(const float* __restrict__ xT, const float* __restrict__ wts,
                const float* __restrict__ ops, double* __restrict__ partial,
                long long N, int K, int D) {
  extern __shared__ float smem[];
  const StatsLayout S{K, D, TW};   // stats_layout's tile, TW threads
  const int n_ops = K * D * D + K * D + K;
  const int n_staged = OPS_SMEM ? n_ops : 0;
  float* tile = smem + n_staged;
  double* acc = reinterpret_cast<double*>(
      reinterpret_cast<char*>(smem) + stats_acc_offset(S, n_staged));
  uint16_t* table = reinterpret_cast<uint16_t*>(acc + S.entries());
  const float* A = stage_operands<OPS_SMEM>(smem, ops, n_ops);
  stats_setup(S, tile, acc, table);
  __syncthreads();
  const float* m = A + K * D * D;
  const float* c = m + K * D;

  const int t = threadIdx.x;
  const long long n_tiles = (N + S.tw - 1) / S.tw;
  for (long long tile_i = blockIdx.x; tile_i < n_tiles; tile_i += gridDim.x) {
    const long long n = tile_i * S.tw + t;
    float x[DMAX];
    float w = 0.0f;
    if (n < N) {
      load_particle<DMAX>(xT, N, n, D, x);
      w = wts[n];
    } else {
#pragma unroll
      for (int i = 0; i < dim_loop<DMAX>(D); ++i) x[i] = 0.0f;
    }
    // whitened differences into the tile, log rho_k parked in the wrho row
    WeightedLse lse;
    float diff[DMAX];
    for (int k = 0; k < K; ++k) {
      const float maha = project<DMAX>(A + k * D * D, m + k * D, x, D, diff);
#pragma unroll
      for (int i = 0; i < dim_loop<DMAX>(D); ++i)
        if (i < D) tile[(S.diff() + k * D + i) * S.stride() + t] = diff[i];
      const float log_rho = c[k] - 0.5f * maha;
      tile[(S.wrho() + k) * S.stride() + t] = log_rho;
      lse.add(log_rho, 1.0f);
    }
    const float l = lse.value();
    for (int k = 0; k < K; ++k) {
      const float log_r = tile[(S.wrho() + k) * S.stride() + t] - l;
      const float wr = w * expf(log_r);
      tile[(S.wrho() + k) * S.stride() + t] = wr;
      tile[(S.c() + k) * S.stride() + t] = wr;
      tile[(S.t1() + k) * S.stride() + t] = wr * log_r;
    }
    tile[S.w() * S.stride() + t] = w;
    tile[S.wlogw() * S.stride() + t] = w > 0.0f ? w * logf(w) : 0.0f;
    __syncthreads();
    stats_accumulate<TW>(S, tile, acc, table);
    __syncthreads();
  }
  stats_write_partial(S, acc, partial);
}

}  // namespace pmc

// ops: A | m | c as above; partial: (n_blocks, S) float64 scratch; stats:
// (S,) float64 output in the entry order of stats.cuh; variant: -1 the
// plan's, 0 the entry-table kernel, 1 the register kernel, 2 the Gram pass
// (an error where the plan takes neither it nor the entry table)
extern "C" int pmc_fused_vb_estep(const float* xT, const float* w, const float* ops,
                                  double* partial, double* stats, long long N, int K,
                                  int D, int variant, int n_blocks, void* stream) {
  using namespace pmc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DensePlan plan = dense_plan(K, 0, D, kDenseVb);
  const int pass = dense_pass(plan, variant);
  if (pass < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (pass == kPassGram)
    return launch_gram<kDenseVb>(xT, const_cast<float*>(w), nullptr, nullptr, ops, partial,
                                 stats, N, K, D, 0, 0, n_blocks, s);
  if (pass == kPassReg) {
    DenseArgs args{};
    args.ops = ops;
    args.xT = const_cast<float*>(xT);
    args.w = const_cast<float*>(w);
    args.partial = partial;
    args.N = N;
    args.K = K;
    args.D = D;
    return launch_dense_reg<kDenseVb>(args, plan, stats, n_blocks, s);
  }
  const StatsLayout S = stats_layout(K, D);
  const int params = K * D * D + K * D + K;
  const size_t smem = stats_launch_smem(S, params);
  if (!stats_tile_built(S, D)) return static_cast<int>(cudaErrorInvalidValue);
  const auto launch = [&](auto kernel) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    kernel<<<n_blocks, S.tw, smem, s>>>(xT, w, ops, partial, N, K, D);
  };
  PMC_DISPATCH_D(D, PMC_DISPATCH_OPS(stats_ops_smem(S, params), {
    PMC_STATS_TILE(S, vb_estep_kernel, launch);
  }));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  launch_reduce(partial, stats, n_blocks, S.entries(), s);
  return static_cast<int>(cudaGetLastError());
}

// shared memory the launcher asks for with the plan's kernel (checked
// against ops/_build.py)
extern "C" long long pmc_vb_estep_smem_bytes(int K, int D) {
  return static_cast<long long>(pmc::dense_plan(K, 0, D, pmc::kDenseVb).smem);
}

// blocks of the register kernel or the Gram pass, the plan's, for (K, D)
// that fit on one SM at once (0 where the plan takes the entry-table
// kernel, -1 on an error)
extern "C" int pmc_vb_estep_per_sm(int K, int D) {
  using namespace pmc;
  const DensePlan plan = dense_plan(K, 0, D, kDenseVb);
  return plan.pass == kPassReg    ? dense_reg_per_sm<kDenseVb>(D, plan.smem)
         : plan.pass == kPassGram ? gram_per_sm<kDenseVb>(K, D)
                                  : 0;
}
