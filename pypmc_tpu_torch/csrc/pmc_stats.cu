// fused_pmc_stats: every sufficient statistic of one PMC update in one
// pass over weighted particles xT (D, N), w (N,) -> the flat entry vector
// of stats.cuh (s0, s0c, t1, sd, lower g per component; sum w, sum w^2,
// sum w log w).
//
// Replaces the Pallas kernel pypmc_tpu/ops/pallas_kernels.py:1150
// (fused_pmc_stats, body _pmc_stats_kernel).
//
// Bound on the H100: per particle it reads D + 1 floats and does the K
// whitened evaluations (K D (D + 1) / 2 FMAs) plus, in the statistics
// phase, K (D (D + 1) / 2 + D) FMAs -- about 1,300 FMAs for 44 bytes at
// K = 10, D = 10: FP32- and shared-memory-bound, not bandwidth-bound.  No
// tensor cores: the statistics are K separate (D, D) blocks at D = 10.  The
// TPU kernel accumulated across a sequential grid and formed the whole
// (K D, K D) Gram matrix; here each block keeps float64 accumulators of only
// the K lower-triangular diagonal blocks, and a second kernel reduces the
// per-block rows in a fixed order.  Three designs
// (reg_stats.cuh dense_plan), as fused_is_pmc_step's, of which this is the
// step without the draw and the target:
//   D <= 16, where it fits shared memory: reg_stats.cuh's register kernel in
//     its statistics mode, the particles and their weights loaded as VB
//     loads them, the components evaluated on 16-byte records (whiten_rec)
//     two threads a particle, log q and the Student-t gamma and t1 bracket
//     as the step forms them, the statistics in float32 registers, D + 3
//     shared reads a (particle, component);
//   D = 17 .. 128 where K D <= 128 (the JAX rule's reach there):
//     gram_stats.cuh's Gram pass, the K components' whitening on register
//     micro-tiles and the statistics as a weighted SYRK, 64 FMAs for 5
//     shared loads;
//   elsewhere the entry-table kernel below (stats.cuh), ~3 shared reads for
//     each of the K (3 + D + D (D + 1) / 2) + 3 entries a particle.
// The passes form log q and the responsibilities with the same arithmetic
// up to the order of the whitening's sums; t1's bracket is log1p(maha / nu)
// + log(nu / 2) - psi + gamma in the register pass and log((maha + nu) / 2)
// - psi + gamma in the entry table and the Gram pass, equal up to float32
// rounding.
#include "reg_stats.cuh"

namespace pmc {

template <int DMAX, bool OPS_SMEM, int TW>
__global__ void __launch_bounds__(kThreads)
pmc_stats_kernel(const float* __restrict__ xT, const float* __restrict__ wts,
                 const float* __restrict__ mix_src, double* __restrict__ partial,
                 long long N, int K, int D, int student_t, int dof_stats) {
  extern __shared__ float smem[];
  const StatsLayout S{K, D, TW};   // stats_layout's tile, TW threads
  const int n_mix = MixLayout{K, D}.eval_size();
  const int n_staged = OPS_SMEM ? n_mix : 0;
  float* tile = smem + n_staged;
  double* acc = reinterpret_cast<double*>(
      reinterpret_cast<char*>(smem) + stats_acc_offset(S, n_staged));
  uint16_t* table = reinterpret_cast<uint16_t*>(acc + S.entries());
  const float* mix = stage_operands<OPS_SMEM>(smem, mix_src, n_mix);
  stats_setup(S, tile, acc, table);
  __syncthreads();

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
    const float log_q = stats_evaluate<DMAX>(mix, S, student_t != 0, x, tile, t);
    stats_finish(mix, S, student_t != 0, dof_stats != 0, log_q, w, tile, t);
    __syncthreads();
    stats_accumulate<TW>(S, tile, acc, table);
    __syncthreads();
  }
  stats_write_partial(S, acc, partial);
}

}  // namespace pmc

// partial: (n_blocks, S) float64 scratch; stats: (S,) float32 output;
// variant: -1 the plan's, 0 the entry-table kernel, 1 the register kernel,
// 2 the Gram pass (an error where the plan takes neither it nor the entry
// table)
extern "C" int pmc_fused_pmc_stats(const float* xT, const float* w,
                                   const float* mix, double* partial,
                                   float* stats, long long N, int K, int D,
                                   int student_t, int dof_stats, int variant, int n_blocks,
                                   void* stream) {
  using namespace pmc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DensePlan plan = dense_plan(K, 0, D, kDenseStats);
  const int pass = dense_pass(plan, variant);
  if (pass < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (pass == kPassGram)
    return launch_gram<kDenseStats>(xT, const_cast<float*>(w), nullptr, nullptr, mix, partial,
                                    stats, N, K, D, student_t, dof_stats, n_blocks, s);
  if (pass == kPassReg) {
    DenseArgs args{};
    args.ops = mix;
    args.xT = const_cast<float*>(xT);
    args.w = const_cast<float*>(w);
    args.partial = partial;
    args.N = N;
    args.K = K;
    args.D = D;
    args.student_t = student_t;
    args.dof_stats = dof_stats;
    return launch_dense_reg<kDenseStats>(args, plan, stats, n_blocks, s);
  }
  const StatsLayout S = stats_layout(K, D);
  const int params = MixLayout{K, D}.eval_size();
  const size_t smem = stats_launch_smem(S, params);
  if (!stats_tile_built(S, D)) return static_cast<int>(cudaErrorInvalidValue);
  const auto launch = [&](auto kernel) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    kernel<<<n_blocks, S.tw, smem, s>>>(xT, w, mix, partial, N, K, D, student_t, dof_stats);
  };
  PMC_DISPATCH_D(D, PMC_DISPATCH_OPS(stats_ops_smem(S, params), {
    PMC_STATS_TILE(S, pmc_stats_kernel, launch);
  }));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  launch_reduce(partial, stats, n_blocks, S.entries(), s);
  return static_cast<int>(cudaGetLastError());
}

// shared memory the launcher asks for with the plan's kernel (checked
// against ops/_build.py)
extern "C" long long pmc_pmc_stats_smem_bytes(int K, int D) {
  return static_cast<long long>(pmc::dense_plan(K, 0, D, pmc::kDenseStats).smem);
}

// blocks of the register kernel or the Gram pass, the plan's, for (K, D)
// that fit on one SM at once (0 where the plan takes the entry-table
// kernel, -1 on an error)
extern "C" int pmc_pmc_stats_per_sm(int K, int D) {
  using namespace pmc;
  const DensePlan plan = dense_plan(K, 0, D, kDenseStats);
  return plan.pass == kPassReg    ? dense_reg_per_sm<kDenseStats>(D, plan.smem)
         : plan.pass == kPassGram ? gram_per_sm<kDenseStats>(K, D)
                                  : 0;
}

// shared memory of the entry-table kernels of fused_pmc_stats and
// fused_is_pmc_step, where their plans take them (checked against
// ops/_build.py)
extern "C" long long pmc_stats_smem_bytes(int K, int Kt, int D, int is_step) {
  using namespace pmc;
  const int params = is_step ? MixLayout{K, D}.size() + MixLayout{Kt, D}.eval_size()
                             : MixLayout{K, D}.eval_size();
  return static_cast<long long>(stats_launch_smem(stats_layout(K, D), params));
}

// particles a tile (threads a block) of the dense statistics kernels for
// (K, D) (checked against ops/_build.py stats_tile)
extern "C" int pmc_stats_tile(int K, int D) { return pmc::stats_layout(K, D).tw; }
