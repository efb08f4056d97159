// fused_is_pmc_step: the particle work of one whole PMC step against a
// mixture target in one pass -> xT (D, N), latent (N,), w (N,) and the flat
// statistics vector of stats.cuh (sum w, sum w^2, sum w log w at its end).
//
// Replaces the Pallas kernel pypmc_tpu/ops/pallas_kernels.py:1336
// (fused_is_pmc_step, body _is_pmc_kernel).
//
// Bound on the H100: it reads nothing per particle and writes D + 2 words;
// the work is the draw (Philox, Box-Muller, Marsaglia-Tsang on the SFU),
// K + K_target whitened evaluations (D (D + 1) / 2 FMAs each) and the K
// (D (D + 1) / 2 + D) FMAs of the statistics -- FP32-FMA-, SFU- and
// shared-memory-bound.  No tensor cores at D = 10.  The draw is
// propose_logq.cu's (one thread a particle, Philox counted by the global
// particle index), the sample kept on chip until the statistics are
// formed: samples and weights are written once and never re-read.
// Particles past N draw nothing and get weight 0, which zeroes every factor
// of every statistic they touch.  Three designs (reg_stats.cuh dense_plan):
//   D <= 16, where it fits shared memory: reg_stats.cuh's register kernel,
//     the components as 16-byte records (whiten_rec), two threads a
//     particle in the evaluation and the statistics in float32 registers,
//     D + 3 shared reads a (particle, component);
//   D = 17 .. 128 where K D <= 128 (the JAX rule's reach there): two
//     launches or more, all graph-capturable -- fused_propose_logq's elected
//     route (its record kernel to D = 64, past it the drawn tiled product
//     and fused_logq's tiled kernel for log q and log p; K = 1 there) writes
//     x, latent, log q and log p, then gram_stats.cuh's Gram pass reads x,
//     log q and log p, writes w = exp(log p - log q) and forms the
//     statistics (log q and the responsibilities from its own whitening);
//   elsewhere the entry-table kernel below (stats.cuh), ~3 shared reads for
//     each of the K (3 + D + D (D + 1) / 2) + 3 entries a particle.
// All draw the same particles (x and latent bit for bit: Philox counted by
// the particle index, propose_particle's arithmetic).  The register kernel
// evaluates log p on the target's records, as fused_is_pmc_step_blocked's
// first launch (is_pmc_step_blocked.cu) does, so its w is that launch's bit
// for bit; the entry-table kernel's log p (mixture_logpdf) is the same
// arithmetic, so its w is too; the Gram route's w is that launch's to D =
// 64, where both take fused_propose_logq's record kernel (to D = 32 the
// first launch's own draw, the same arithmetic), and past it fused_logq's
// tensor-core kernel.
#include "reg_stats.cuh"

// fused_propose_logq's launcher (propose_logq.cu): the Gram route's draw
extern "C" int pmc_fused_propose_logq(unsigned int s0, unsigned int s1,
                                      const long long* seed_words,
                                      const float* mix, const float* tmix,
                                      float* xT, int* latent, float* log_q,
                                      float* log_p, int* scratch, float* split, long long N,
                                      int K, int Kt, int D, int student_t, int t_student_t,
                                      int variant, int n_blocks, int eval_blocks,
                                      void* stream);

namespace pmc {

template <int DMAX, bool OPS_SMEM, int TW>
__global__ void __launch_bounds__(kThreads)
is_pmc_step_kernel(const Seed seed, const float* __restrict__ mix_src,
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
      Philox rng(seed.w0(), seed.w1(), static_cast<uint64_t>(n));
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

// seed_words: null (the words s0, s1) or two int64 on the card, read in the
// kernel (Seed); variant: -1 the plan's kernel, 0 the entry-table kernel, 1
// the register kernel, 2 the Gram route (an error where the plan takes
// neither it nor the entry table); log_q, log_p: the Gram route's (N,)
// scratch (else null); split: its draw's evaluation scratch past D = 64, as
// pmc_fused_propose_logq's (else null); draw_blocks, eval_blocks: its draw's
// grids, as pmc_fused_propose_logq's n_blocks and eval_blocks; n_blocks: the
// statistics pass's
extern "C" int pmc_fused_is_pmc_step(unsigned int s0, unsigned int s1,
                                     const long long* seed_words,
                                     const float* mix, const float* tmix,
                                     float* xT, int* latent, float* w,
                                     float* log_q, float* log_p, float* split,
                                     double* partial, float* stats, long long N,
                                     int K, int Kt, int D, int student_t,
                                     int t_student_t, int dof_stats, int variant,
                                     int draw_blocks, int eval_blocks, int n_blocks,
                                     void* stream) {
  using namespace pmc;
  const Seed seed{s0, s1, seed_words};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DensePlan plan = dense_plan(K, Kt, D, kDenseStep);
  const int pass = dense_pass(plan, variant);
  if (pass < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (pass == kPassGram) {
    if (log_q == nullptr || log_p == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const int err = pmc_fused_propose_logq(s0, s1, seed_words, mix, tmix, xT, latent, log_q,
                                           log_p, nullptr, split, N, K, Kt, D, student_t,
                                           t_student_t, -1, draw_blocks, eval_blocks, stream);
    if (err != 0) return err;
    return launch_gram<kDenseStep>(xT, w, log_q, log_p, mix, partial, stats, N, K, D,
                                   student_t, dof_stats, n_blocks, s);
  }
  if (pass == kPassReg) {
    DenseArgs args{};
    args.ops = mix;
    args.tmix = tmix;
    args.xT = xT;
    args.w = w;
    args.latent = latent;
    args.partial = partial;
    args.N = N;
    args.K = K;
    args.Kt = Kt;
    args.D = D;
    args.seed = seed;
    args.student_t = student_t;
    args.t_student_t = t_student_t;
    args.dof_stats = dof_stats;
    return launch_dense_reg<kDenseStep>(args, plan, stats, n_blocks, s);
  }
  const StatsLayout S = stats_layout(K, D);
  const int params = MixLayout{K, D}.size() + MixLayout{Kt, D}.eval_size();
  const size_t smem = stats_launch_smem(S, params);
  if (!stats_tile_built(S, D)) return static_cast<int>(cudaErrorInvalidValue);
  const auto launch = [&](auto kernel) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    kernel<<<n_blocks, S.tw, smem, s>>>(seed, mix, tmix, xT, latent, w, partial, N, K, Kt, D,
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

// shared memory the launcher asks for with the plan's kernel (checked
// against ops/_build.py)
extern "C" long long pmc_is_pmc_step_smem_bytes(int K, int Kt, int D) {
  return static_cast<long long>(pmc::dense_plan(K, Kt, D, pmc::kDenseStep).smem);
}

// blocks of the register kernel or the Gram pass, the plan's, for (K, Kt,
// D) that fit on one SM at once (0 where the plan takes the entry-table
// kernel, -1 on an error)
extern "C" int pmc_is_pmc_step_per_sm(int K, int Kt, int D) {
  using namespace pmc;
  const DensePlan plan = dense_plan(K, Kt, D, kDenseStep);
  return plan.pass == kPassReg    ? dense_reg_per_sm<kDenseStep>(D, plan.smem)
         : plan.pass == kPassGram ? gram_per_sm<kDenseStep>(K, D)
                                  : 0;
}

// the plan of fused_is_pmc_step (mode 0), fused_vb_estep (1) or
// fused_pmc_stats (2) for (K, Kt, D), checked against ops/_build.py
// dense_plan: out = {the pass (DensePass: 0 the entry table, 1 the register
// kernel, 2 the Gram pass), tile columns (particles), column slices,
// component groups (the Gram pass: its 8 x 8 blocks)}; the shared memory a
// block
extern "C" long long pmc_dense_plan(int K, int Kt, int D, int mode, int* out) {
  using namespace pmc;
  const DensePlan plan = dense_plan(K, Kt, D, mode);
  out[0] = plan.pass;
  out[1] = plan.pass == kPassReg    ? kRegCols
           : plan.pass == kPassGram ? kGramP
                                    : stats_layout(K, D).tw;
  out[2] = plan.slices;
  out[3] = plan.groups;
  return static_cast<long long>(plan.smem);
}
