// fused_is_pmc_step_blocked: the particle work of one PMC step against a
// mixture target (fused_is_pmc_step, is_pmc_step.cu) for mixtures past its
// one-tile limit -> xT (D, N), latent (N,), w (N,) and the flat statistics
// vector with sum w, sum w^2, sum w log w at its end.
//
// Replaces the Pallas kernel pypmc_tpu/ops/pallas_kernels.py:2067
// (fused_is_pmc_step_blocked, body _is_pmc_blocked_kernel).
//
// Two launches, one call.  step_draw_kernel draws each particle from the
// Philox stream (seed, particle index) with the component from the tail-sum
// thresholds and writes it with log q and log p; then the statistics pass of
// blocked.cuh forms w = exp(log p - log q) (0 past N), writes it, and
// reduces the statistics chunk by chunk.
//
// The draw is the dense step's (common.cuh propose_particle: the same
// counter, component choice, Box-Muller and Marsaglia-Tsang arithmetic and
// affine_transform FMA order), so a forced dense and blocked step from the
// same seed words draw the same particles bit for bit.  Shared memory holds
// only what every particle reads: both mixtures' evaluation parts as 16-byte
// component records (common.cuh stage_records; read with broadcast LDS.128,
// in whiten's FMA order) and the thresholds cumw.  The drawn component's L
// and mu are read from device memory (K D^2 floats of L, in L2), so at K =
// 200, D = 10 a block of 256 threads asks for 72 KB and two blocks (16
// warps, held there by 92 registers a thread) share an SM;
// fused_propose_logq's looped kernel, which also stages L, fitted one block
// of 4 warps there.  Past D = 32, or where the records do not fit shared
// memory, the first launch is fused_propose_logq's (propose_logq.cu: its
// plan's kernel, its grid sized by its launcher), which draws the same
// particles.
//
// Bound on the H100: nothing is read per particle and D + 2 words are
// written (D + 3 more go through device memory between the launches); the
// work is the draw (SFU), K + K_target whitened evaluations and, per
// (particle, component), a second whitened evaluation, an exp and the
// statistics pass's D + 3 shared-memory reads and D (D + 1) / 2 + D + 3 FMAs.
#include "blocked.cuh"

extern "C" int pmc_fused_propose_logq(unsigned int s0, unsigned int s1,
                                      const long long* seed_words,
                                      const float* mix, const float* tmix,
                                      float* xT, int* latent, float* log_q,
                                      float* log_p, int* scratch, float* split, long long N,
                                      int K, int Kt, int D, int student_t, int t_student_t,
                                      int variant, int n_blocks, int eval_blocks,
                                      void* stream);

namespace pmc {

constexpr int kDrawThreads = 256;

template <int DMAX>
__global__ void __launch_bounds__(kDrawThreads, 2)
step_draw_kernel(const Seed seed, const float* __restrict__ mix,
                 const float* __restrict__ tmix, float* __restrict__ xT,
                 int* __restrict__ latent, float* __restrict__ log_q,
                 float* __restrict__ log_p, long long N, int K, int Kt, int D,
                 int student_t, int t_student_t) {
  extern __shared__ float4 smem4[];
  float* recs = reinterpret_cast<float*>(smem4);
  const MixLayout L{K, D};
  const int F = rec_floats(D);
  stage_records(recs, mix, K, D);
  stage_records(recs + K * F, tmix, Kt, D);
  float* cumw = recs + (K + Kt) * F;
  load_to_shared(cumw, mix + L.cumw(), K);
  __syncthreads();
  for (long long n = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       n < N; n += static_cast<long long>(gridDim.x) * blockDim.x) {
    // propose_particle's draw, the thresholds read from shared memory
    Philox rng(seed.w0(), seed.w1(), static_cast<uint64_t>(n));
    const float u = rng.uniform();
    int lat = 0;
    for (int k = 0; k < K - 1; ++k) lat += u >= cumw[k] ? 1 : 0;
    float x[DMAX];
    draw_component<DMAX>(mix + L.mu(), mix + L.L(), mix + L.dof(), lat, D,
                         student_t != 0, rng, x);
    latent[n] = lat;
    store_particle<DMAX>(xT, N, n, D, x);
    log_q[n] = records_logpdf<DMAX>(recs, K, D, student_t != 0, x);
    log_p[n] = records_logpdf<DMAX>(recs + K * F, Kt, D, t_student_t != 0, x);
  }
}

}  // namespace pmc

// shared memory of step_draw_kernel (checked against ops/_build.py): the
// records and cumw if D <= 32 and they fit, else 0 (fused_propose_logq's
// kernel then takes the first launch)
extern "C" long long pmc_step_draw_smem_bytes(int K, int Kt, int D) {
  const size_t bytes = sizeof(float) * (static_cast<size_t>(K + Kt) * pmc::rec_floats(D) + K);
  return D <= 32 && bytes <= pmc::kSmemLimit ? static_cast<long long>(bytes) : 0;
}

// Call body(kernel) with step_draw_kernel's instantiation for D <= 32 and
// its shared memory.
template <typename Body>
static void dispatch_step_draw(int D, size_t smem, Body&& body) {
  using namespace pmc;
  const decltype(&step_draw_kernel<8>) kernel =
      D <= 8 ? &step_draw_kernel<8> : D <= 16 ? &step_draw_kernel<16> : &step_draw_kernel<32>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  body(kernel);
}

// blocks of step_draw_kernel that fit on one SM at once (0 where the first
// launch is fused_propose_logq's, -1 on an error)
extern "C" int pmc_step_draw_per_sm(int K, int Kt, int D) {
  const size_t smem = static_cast<size_t>(pmc_step_draw_smem_bytes(K, Kt, D));
  if (smem == 0) return 0;
  int n = 0;
  dispatch_step_draw(D, smem, [&](auto kernel) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, pmc::kDrawThreads, smem);
  });
  return cudaGetLastError() == cudaSuccess ? n : -1;
}

// the first launch, with as many blocks as fit on the card at once
static int launch_step_draw(unsigned int s0, unsigned int s1, const long long* seed_words,
                            const float* mix, const float* tmix, float* xT, int* latent,
                            float* log_q,
                            float* log_p, long long N, int K, int Kt, int D,
                            int student_t, int t_student_t, void* stream) {
  using namespace pmc;
  const size_t smem = static_cast<size_t>(pmc_step_draw_smem_bytes(K, Kt, D));
  // fused_propose_logq's record kernel to D = 64 and its looped kernel past
  // it (its tiled route needs a scratch this launch has none of), each
  // sizing its grid
  if (smem == 0)
    return pmc_fused_propose_logq(s0, s1, seed_words, mix, tmix, xT, latent, log_q, log_p,
                                  nullptr, nullptr, N, K, Kt, D, student_t, t_student_t,
                                  D > kRecDMax ? 0 : -1, 0, 0, stream);
  dispatch_step_draw(D, smem, [&](auto kernel) {
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kDrawThreads, smem);
    kernel<<<wave_blocks(per_sm, N, kDrawThreads), kDrawThreads, smem,
             static_cast<cudaStream_t>(stream)>>>(
        Seed{s0, s1, seed_words}, mix, tmix, xT, latent, log_q, log_p, N, K, Kt, D, student_t,
        t_student_t);
  });
  return static_cast<int>(cudaGetLastError());
}

// seed_words as pmc_fused_propose_logq's; mix, tmix: the packed proposal
// and target; chunks: the proposal's
// chunk-major operands (blocked.cuh); log_q, log_p (N,) scratch; partial
// (n_blocks, S) float64 scratch; stats (S,) float32 output
extern "C" int pmc_fused_is_pmc_step_blocked(
    unsigned int s0, unsigned int s1, const long long* seed_words, const float* mix,
    const float* tmix, const float* chunks, float* xT, int* latent, float* w, float* log_q,
    float* log_p, double* partial, float* stats, long long N, int K, int Kt,
    int D, int kc, int student_t, int t_student_t, int dof_stats, int n_blocks,
    void* stream) {
  using namespace pmc;
  int err = launch_step_draw(s0, s1, seed_words, mix, tmix, xT, latent, log_q, log_p, N, K,
                             Kt, D, student_t, t_student_t, stream);
  if (err != 0) return err;
  return launch_blocked_stats<kBlockedStep, float>(
      xT, w, log_q, log_p, chunks, partial, stats, N, K, D, kc, student_t, dof_stats,
      n_blocks, static_cast<cudaStream_t>(stream));
}

// the statistics pass's shared memory a block (checked against ops/_build.py;
// the target is evaluated in the first launch)
extern "C" long long pmc_is_pmc_step_blocked_smem_bytes(int K, int Kt, int D) {
  (void)Kt;
  return static_cast<long long>(pmc::blocked_plan(K, D, false).smem);
}

// statistics-pass blocks that fit on one SM at once (-1 on an error)
extern "C" int pmc_is_pmc_step_blocked_per_sm(int K, int D) {
  return pmc::blocked_stats_per_sm<pmc::kBlockedStep>(K, D);
}
