// fused_is_pmc_step_blocked: the particle work of one PMC step against a
// mixture target (fused_is_pmc_step, is_pmc_step.cu) for mixtures past its
// one-tile limit -> xT (D, N), latent (N,), w (N,) and the flat statistics
// vector with sum w, sum w^2, sum w log w at its end.
//
// Replaces the Pallas kernel pypmc_tpu/ops/pallas_kernels.py:2067
// (fused_is_pmc_step_blocked, body _is_pmc_blocked_kernel).
//
// Two launches, one call: propose_logq.cu's kernel draws each particle from
// the Philox stream (seed, particle index) with the component from the
// tail-sum thresholds (common.cuh propose_particle, the draw of the dense
// step), and writes it with log q and log p; then the statistics pass of
// blocked.cuh forms w = exp(log p - log q) (0 past N), writes it, and
// reduces the statistics chunk by chunk.  A forced dense and blocked step
// from the same seed words therefore draw the same particles bit for bit.
//
// Bound on the H100: nothing is read per particle and D + 2 words are
// written (D + 3 more go through device memory between the launches); the
// work is the draw (SFU), K + K_target whitened evaluations and, per
// (particle, component), a second whitened evaluation, an exp and the
// statistics phase's shared-memory reads -- at K = 200, D = 10 the
// statistics phase's ~200 shared-memory reads a component dominate.
#include "blocked.cuh"

extern "C" int pmc_fused_propose_logq(unsigned int s0, unsigned int s1,
                                      const float* mix, const float* tmix,
                                      float* xT, int* latent, float* log_q,
                                      float* log_p, long long N, int K, int Kt,
                                      int D, int student_t, int t_student_t,
                                      int n_blocks, void* stream);

// mix, tmix: the packed proposal and target; chunks: the proposal's
// chunk-major operands (blocked.cuh); log_q, log_p (N,) scratch; partial
// (n_blocks, S) float64 scratch; stats (S,) float32 output
extern "C" int pmc_fused_is_pmc_step_blocked(
    unsigned int s0, unsigned int s1, const float* mix, const float* tmix,
    const float* chunks, float* xT, int* latent, float* w, float* log_q,
    float* log_p, double* partial, float* stats, long long N, int K, int Kt,
    int D, int kc, int student_t, int t_student_t, int dof_stats,
    int n_eval_blocks, int n_blocks, void* stream) {
  using namespace pmc;
  int err = pmc_fused_propose_logq(s0, s1, mix, tmix, xT, latent, log_q, log_p, N, K,
                                   Kt, D, student_t, t_student_t, n_eval_blocks, stream);
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
