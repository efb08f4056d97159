// fused_propose_logq: draw N particles from a Gaussian or Student-t mixture
// and evaluate the proposal log-density (and optionally a mixture target's)
// on them -> xT (D, N), latent (N,), log_q (N,) [, log_p (N,)].
//
// Replaces the Pallas kernel pypmc_tpu/ops/pallas_kernels.py:924
// (fused_propose_logq, body _propose_logq_kernel, _propose_tile).
//
// Bound on the H100: it reads nothing per particle and writes D + 3 words;
// the work is the draw (Philox, Box-Muller, for Student-t a Marsaglia-Tsang
// loop: integer work and transcendentals on the SFU) plus (K + K_target)
// whitened evaluations at D (D + 1) / 2 FMAs each -- FP32-FMA-, SFU- and
// integer-bound, with the store stream far below the card's bandwidth.  No
// tensor cores at D = 10.  One thread a particle with a Philox stream keyed
// by the seed and counted by the particle's global index (so the samples do
// not depend on the launch configuration), the sample kept in registers and
// evaluated there (it is written to device memory once and never re-read).
//
// Up to D = 64 (propose_logq_rec_kernel, the record kernels of common.cuh):
// 256 threads a block, one wave of the blocks an SM holds, z and x in
// registers at the record instantiations' DMAX.  A block stages by cp.async
// both mixtures' evaluation records (16-byte records read by broadcast
// LDS.128 in whiten's FMA order: at K = 10, K_target = 2, D = 10 about 260
// shared loads a particle, where the packed table takes a 4-byte load a
// FMA, ~820), the proposal's draw records (mu and L's lower triangle at an
// odd stride, so that lanes that drew different components read distinct
// banks) and its thresholds; the drawn component's dof is its evaluation
// record's.  The draw is propose_particle's (the component's uniform, the
// normals, the chi-square; affine_transform's FMA order) and the
// evaluation mixture_logpdf's bit for bit, so its outputs are the looped
// kernel's.  Where the plan's records pass half an SM it reads the draw
// records' mu and L and the thresholds from device memory and evaluates
// with mixture_logpdf on the packed operands there.
//
// The looped kernel (propose_logq_kernel): 128 threads, both mixtures'
// packed operands staged in shared memory where they fit, evaluated with
// mixture_logpdf; no shape elects it, and it runs anywhere to D = 128,
// forced, as the bit-exact yardstick of the draws.
//
// From D = kDrawTiledDMin (tiled.cuh), three or four launches, all
// graph-capturable: the bucket kernel on components drawn from word 0 of
// each particle's stream against the tail-sum thresholds (DrawnLatents; no
// bucket kernel at K = 1), the drawn tiled product (draw_tiled_kernel<1>:
// the normals from word 1 on drawn in shared memory, the Student-t scale
// after them, x written and each particle's component with it), then
// fused_logq's tiled kernel on the x just written for log q and, with a
// target, for log p (pmc_fused_logq, so both are fused_logq's bit for
// bit).  x and latent are the looped kernel's bit for bit.  Re-reading x
// costs 4 D bytes a particle an evaluation (52 MB, ~0.016 ms at D = 200,
// 2^16), beside the product's and the evaluations' FP32 work.
#include "tiled.cuh"

// fused_logq's launcher (logq.cu): the evaluations of the tiled route
extern "C" int pmc_fused_logq(const float* xT, const float* mix, float* out, long long N, int K,
                              int D, int student_t, int variant, int n_blocks, void* stream);

namespace pmc {

template <int DMAX, bool OPS_SMEM>
__global__ void __launch_bounds__(kThreads)
propose_logq_kernel(const Seed seed, const float* __restrict__ mix_src,
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
    Philox rng(seed.w0(), seed.w1(), static_cast<uint64_t>(n));
    float x[DMAX];
    latent[n] = propose_particle<DMAX>(mix, K, D, student_t != 0, rng, x);
    store_particle<DMAX>(xT, N, n, D, x);
    log_q[n] = mixture_logpdf<DMAX>(mix, K, D, student_t != 0, x);
    if (log_p != nullptr)
      log_p[n] = mixture_logpdf<DMAX>(tmix, Kt, D, t_student_t != 0, x);
  }
}

// The plan of fused_propose_logq for (K, Kt, D) (mirrored by ops/_build.py
// propose_plan; Kt = 0 without a target): from kDrawTiledDMin the drawn
// product's (kTileThreads, draw_tiled_smem), else draw_plan's, the record
// kernel's records both mixtures' evaluation records, the proposal's draw
// records and its K thresholds, the looped kernel's operands the packed
// proposal and the target's evaluation part (``looped`` forces it to D =
// 128).
inline DrawPlan propose_plan(int K, int Kt, int D, bool looped = false) {
  if (!looped && D >= kDrawTiledDMin)
    return {kDrawTiled, false, kTileThreads, draw_tiled_smem(D)};
  return draw_plan(D,
                   static_cast<size_t>(K + Kt) * rec_floats(D) +
                       static_cast<size_t>(K) * (transform_rec_floats(D) + 1),
                   static_cast<size_t>(MixLayout{K, D}.size()) + MixLayout{Kt, D}.eval_size(),
                   looped);
}

// log q (log p) of x: records_logpdf on the K records at recs (STAGED),
// else mixture_logpdf on the packed operands at mix, both inlined so that x
// stays in registers
template <int DMAX, bool STAGED>
__device__ __forceinline__ float rec_kernel_logpdf(const float* recs, const float* mix, int K,
                                                   int D, bool student_t,
                                                   const float (&x)[DMAX]) {
  WeightedLse acc;
  if constexpr (STAGED) {
    records_lse<DMAX>(acc, recs, K, D, student_t, x);
  } else {
    const MixLayout L{K, D};
    float diff[DMAX];
    for (int k = 0; k < K; ++k) {
      const float maha = whiten<DMAX>(mix + L.U() + k * D * D, mix + L.mu() + k * D, x, D, diff);
      acc.add(component_logpdf(maha, mix[L.ln() + k], mix[L.dof() + k], D, student_t),
              mix[L.w() + k]);
    }
  }
  return acc.value();
}

// shared memory (STAGED): K proposal and Kt target evaluation records |
// K draw records | cumw (K); log_p null and Kt 0 without a target
template <int DMAX, bool STAGED, bool SEED_PTR>
__global__ void __launch_bounds__(kEvalThreads, eval_min_blocks(DMAX))
propose_logq_rec_kernel(const Seed seed, const float* __restrict__ mix,
                        const float* __restrict__ tmix, float* __restrict__ xT,
                        int* __restrict__ latent, float* __restrict__ log_q,
                        float* __restrict__ log_p, long long N, int K, int Kt, int D,
                        int student_t, int t_student_t) {
  extern __shared__ float4 smem4[];
  constexpr int below = eval_dmax_below(DMAX);
  __builtin_assume(D > below && D <= DMAX);   // the dispatch's
  const MixLayout L{K, D}, Lt{Kt, D};
  const int F = rec_floats(D);
  float* recs = reinterpret_cast<float*>(smem4);
  float* draws = recs + (K + Kt) * F;
  float* cumw = draws + K * transform_rec_floats(D);
  if constexpr (SEED_PTR) {
    if (threadIdx.x == 0) store_seed_key(seed);
    if constexpr (!STAGED) __syncthreads();
  }
  if constexpr (STAGED) {
    stage_records_async(recs, mix + L.mu(), mix + L.U(), mix + L.ln(), 3, K, 0, K, D, true);
    if (Kt > 0)
      stage_records_async(recs + K * F, tmix + Lt.mu(), tmix + Lt.U(), tmix + Lt.ln(), 3, Kt,
                          0, Kt, D, true);
    stage_transform_records(draws, mix + L.mu(), mix + L.L(), K, D);
    stage_row_async(cumw, mix + L.cumw(), K);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  const float* thresholds = STAGED ? cumw : mix + L.cumw();
  for (long long n = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       n < N; n += static_cast<long long>(gridDim.x) * blockDim.x) {
    // propose_particle's draw
    auto rng = particle_stream<SEED_PTR>(seed, static_cast<uint64_t>(n));
    const float u = rng.uniform();
    int lat = 0;
    for (int k = 0; k < K - 1; ++k) lat += u >= thresholds[k] ? 1 : 0;
    float x[DMAX];
#pragma unroll
    for (int i = 0; i < DMAX; ++i) x[i] = 0.0f;
    draw_rec<DMAX, STAGED>(
        rng, draws, mix + L.mu(), mix + L.L(), lat, D, student_t != 0,
        [&] { return STAGED ? recs[lat * F + pad4(D) + 2] : __ldg(mix + L.dof() + lat); },
        [&](int i, float v) {
          x[i] = v;
          xT[i * N + n] = v;
        });
    latent[n] = lat;
    log_q[n] = rec_kernel_logpdf<DMAX, STAGED>(recs, mix, K, D, student_t != 0, x);
    if (Kt > 0)
      log_p[n] = rec_kernel_logpdf<DMAX, STAGED>(recs + K * F, tmix, Kt, D, t_student_t != 0, x);
  }
}

template <bool SEED_PTR>
struct ProposeRecKernels {
  template <int DMAX, bool STAGED>
  static auto get() { return &propose_logq_rec_kernel<DMAX, STAGED, SEED_PTR>; }
};

// The tiled route on stream s: the bucket kernel on the drawn components
// (K > 1), the drawn product (n_blocks blocks), then fused_logq's tiled
// kernel for log q and, with a target, log p (eval_blocks blocks each).
int launch_propose_tiled(const Seed& seed, const float* mix, const float* tmix, float* xT,
                         int* latent, float* log_q, float* log_p, int* scratch, long long N,
                         int K, int Kt, int D, int student_t, int t_student_t, int n_blocks,
                         int eval_blocks, cudaStream_t s) {
  const MixLayout L{K, D};
  int err = launch_draw_tiled<1>(seed, DrawnLatents{seed, mix + L.cumw(), K}, mix + L.mu(),
                                 mix + L.L(), mix + L.dof(), scratch, xT, latent, N, K, D,
                                 student_t, n_blocks, s);
  if (err != 0 || N == 0) return err;
  err = pmc_fused_logq(xT, mix, log_q, N, K, D, student_t, kEvalTiled, eval_blocks, s);
  if (err != 0 || log_p == nullptr) return err;
  return pmc_fused_logq(xT, tmix, log_p, N, Kt, D, t_student_t, kEvalTiled, eval_blocks, s);
}

}  // namespace pmc

// the plan of fused_propose_logq for (K, Kt, D), checked against
// ops/_build.py propose_plan (draw_plan_out)
extern "C" long long pmc_propose_plan(int K, int Kt, int D, int* out) {
  return pmc::draw_plan_out(pmc::propose_plan(K, Kt, D), D, out);
}

// blocks of the record kernel for (K, Kt, D) that fit on one SM at once (0
// where the plan takes another kernel, -1 on an error)
extern "C" int pmc_propose_per_sm(int K, int Kt, int D) {
  return pmc::rec_per_sm<pmc::ProposeRecKernels<false>>(pmc::propose_plan(K, Kt, D), D);
}

// seed_words: null (the words s0, s1) or two int64 on the card, read in the
// kernel (Seed); tmix/log_p are null without a target; scratch: the tiled
// route's transform_scratch_words(N, K) int32 at K > 1 (else may be null);
// variant: -1 the plan's kernel, 0 the looped kernel (D <= 128), 1 the
// record kernel (an error where the plan does not take it), 2 the tiled
// route (any D to kWideDMax); n_blocks <= 0: one wave of the record or
// looped kernel's blocks, sized here (the record kernel's from its
// occupancy, the looped kernel's 16 blocks an SM); the tiled route takes
// n_blocks for its product and eval_blocks for its evaluations, both > 0
extern "C" int pmc_fused_propose_logq(unsigned int s0, unsigned int s1,
                                      const long long* seed_words,
                                      const float* mix, const float* tmix,
                                      float* xT, int* latent, float* log_q,
                                      float* log_p, int* scratch, long long N, int K, int Kt,
                                      int D, int student_t, int t_student_t,
                                      int variant, int n_blocks, int eval_blocks,
                                      void* stream) {
  using namespace pmc;
  const Seed seed{s0, s1, seed_words};
  if (log_p == nullptr) Kt = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DrawPlan plan = propose_plan(K, Kt, D);
  if (takes_rec(plan, variant)) {
    const auto launch = [&](auto kernel) {
      int blocks = n_blocks;
      if (blocks <= 0) {
        int per_sm = 0;
        const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, plan.threads, plan.smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        blocks = wave_blocks(per_sm, N, plan.threads);
      }
      kernel<<<blocks, plan.threads, plan.smem, s>>>(seed, mix, tmix, xT, latent, log_q,
                                                     log_p, N, K, Kt, D, student_t,
                                                     t_student_t);
      return static_cast<int>(cudaGetLastError());
    };
    return seed_words == nullptr ? with_rec_kernel<ProposeRecKernels<false>>(plan, D, launch)
                                 : with_rec_kernel<ProposeRecKernels<true>>(plan, D, launch);
  }
  if (variant == 2 || (variant < 0 && plan.variant == kDrawTiled)) {
    if (eval_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
    return launch_propose_tiled(seed, mix, tmix, xT, latent, log_q, log_p, scratch, N, K, Kt, D,
                                student_t, t_student_t, n_blocks, eval_blocks, s);
  }
  if (D > kDMax) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = propose_plan(K, Kt, D, true).smem;
  if (n_blocks <= 0) n_blocks = wave_blocks(16, N, kThreads);
  PMC_DISPATCH_D(D, PMC_DISPATCH_OPS(smem > 0, {
    cudaFuncSetAttribute(propose_logq_kernel<DMAX, OPS_SMEM>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    propose_logq_kernel<DMAX, OPS_SMEM><<<n_blocks, kThreads, smem, s>>>(
        seed, mix, tmix, xT, latent, log_q, log_p, N, K, Kt, D, student_t,
        t_student_t);
  }));
  return static_cast<int>(cudaGetLastError());
}
