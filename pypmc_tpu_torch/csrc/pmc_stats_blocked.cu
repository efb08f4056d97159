// fused_pmc_stats_blocked: the statistics of fused_pmc_stats (pmc_stats.cu)
// for mixtures past its one-tile limit -> the same flat entry vector.
//
// Replaces the Pallas kernel pypmc_tpu/ops/pallas_kernels.py:1779
// (fused_pmc_stats_blocked, body _pmc_stats_blocked_kernel: the streaming
// weighted log-sum-exp _streaming_weighted_lse and the statistics pass
// _blocked_stats_pass).
//
// Two launches, one call: logq.cu's kernel writes log q (N floats), then the
// statistics pass of blocked.cuh walks the components in chunks.  Where the
// TPU kernel kept 2 K per-lane rows in VMEM between its two block passes and
// accumulated (kb D, kb D) Gram panels, here log q goes through device memory
// and each chunk forms only its K lower-triangular diagonal blocks.
//
// Bound on the H100: per particle it reads D + 1 floats; per (particle,
// component) it does the whitened evaluation twice (once a launch, D (D + 1)
// / 2 FMAs each), two exps (the log-sum-exp and rho), and the statistics
// pass's D + 3 tile writes and reads (blocked.cuh's register pass; ~3 (3 + D
// + D (D + 1) / 2) reads past D = 16) -- at K = 400, D = 2 the exps
// (special-function unit) and the per-pair instructions, not the FP32 FMAs
// and far from the bytes.
#include "blocked.cuh"

extern "C" int pmc_fused_logq(const float* xT, const float* mix, float* scratch, float* out,
                              long long N, int K, int D, int student_t, int variant,
                              int n_blocks, void* stream);

// mix: the packed evaluation operands (log q); chunks: the chunk-major
// operands of blocked.cuh; log_q (N,) scratch; split: fused_logq's scratch
// past D = 64 (pmc_fused_logq's; else null); partial (n_blocks, S) float64
// scratch; stats (S,) float32 output
extern "C" int pmc_fused_pmc_stats_blocked(
    const float* xT, const float* w, const float* mix, const float* chunks,
    float* log_q, float* split, double* partial, float* stats, long long N, int K, int D,
    int kc, int student_t, int dof_stats, int n_eval_blocks, int n_blocks,
    void* stream) {
  using namespace pmc;
  int err = pmc_fused_logq(xT, mix, split, log_q, N, K, D, student_t, -1, n_eval_blocks, stream);
  if (err != 0) return err;
  return launch_blocked_stats<kBlockedPmc, float>(
      xT, const_cast<float*>(w), log_q, nullptr, chunks, partial, stats, N, K, D,
      kc, student_t, dof_stats, n_blocks, static_cast<cudaStream_t>(stream));
}

// the statistics pass's shared memory a block (checked against ops/_build.py)
extern "C" long long pmc_pmc_stats_blocked_smem_bytes(int K, int D) {
  return static_cast<long long>(pmc::blocked_plan(K, D, false).smem);
}

// its components a chunk
extern "C" int pmc_blocked_chunk(int K, int D, int vb) {
  return pmc::blocked_plan(K, D, vb != 0).kc;
}

// statistics-pass blocks that fit on one SM at once (-1 on an error)
extern "C" int pmc_pmc_stats_blocked_per_sm(int K, int D) {
  return pmc::blocked_stats_per_sm<pmc::kBlockedPmc>(K, D);
}
