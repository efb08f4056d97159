// fused_propose_logq: draw N particles from a Gaussian or Student-t mixture
// and evaluate the proposal log-density (and optionally a mixture target's)
// on them -> xT (D, N), latent (N,), log_q (N,) [, log_p (N,)].
//
// Replaces the Pallas kernel pypmc_tpu/ops/pallas_kernels.py:924
// (fused_propose_logq, body _propose_logq_kernel, _propose_tile).
//
// Bound on the H100: it reads nothing per particle and writes D + 3 words;
// the work is the draw (Philox, Box-Muller, for Student-t a Marsaglia-Tsang
// loop: transcendentals on the SFU) plus (K + K_target) whitened
// evaluations at D (D + 1) / 2 FMAs each -- FP32-FMA- and SFU-bound, with
// the store stream far below the card's bandwidth.  No tensor cores at
// D = 10.  Design: one thread per particle with a Philox stream keyed by the
// seed and counted by the particle's global index (so the samples do not
// depend on the launch configuration), the sample kept in registers and
// evaluated there (it is written to device memory once and never re-read),
// both mixtures' operands in shared memory where they fit.  Past D = 128
// (propose_logq_warp_kernel) a warp takes a particle (warp.cuh): the lanes
// draw the particle's Philox stream block by block (the component's uniform,
// then the normals: the thread path's draws), the rows of L, then of each
// U, on the lanes, read from device memory.
#include "warp.cuh"

namespace pmc {

template <int DMAX, bool OPS_SMEM>
__global__ void __launch_bounds__(kThreads)
propose_logq_kernel(uint32_t s0, uint32_t s1, const float* __restrict__ mix_src,
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
    Philox rng(s0, s1, static_cast<uint64_t>(n));
    float x[DMAX];
    latent[n] = propose_particle<DMAX>(mix, K, D, student_t != 0, rng, x);
    store_particle<DMAX>(xT, N, n, D, x);
    log_q[n] = mixture_logpdf<DMAX>(mix, K, D, student_t != 0, x);
    if (log_p != nullptr)
      log_p[n] = mixture_logpdf<DMAX>(tmix, Kt, D, t_student_t != 0, x);
  }
}

__global__ void __launch_bounds__(kWideThreads)
propose_logq_warp_kernel(uint32_t s0, uint32_t s1, const float* __restrict__ mix,
                         const float* __restrict__ tmix, float* __restrict__ xT,
                         int* __restrict__ latent, float* __restrict__ log_q,
                         float* __restrict__ log_p, long long N, int K, int Kt, int D,
                         int student_t, int t_student_t) {
  extern __shared__ float smem[];
  const WarpSlices sl = warp_slices(smem, D);
  const uint32_t* words = reinterpret_cast<const uint32_t*>(sl.a);
  const MixLayout L{K, D};
  for (long long n = warp_index(); n < N; n += warp_count()) {
    // propose_particle's stream: the component's uniform (word 0), the
    // normals, then the Student-t scale
    warp_normals(s0, s1, static_cast<uint64_t>(n), 1, D, reinterpret_cast<uint32_t*>(sl.a),
                 sl.b);
    const float u = Philox::u01(words[0]);
    int lat = 0;
    for (int k = 0; k < K - 1; ++k) lat += u >= mix[L.cumw() + k] ? 1 : 0;
    float scale = 1.0f;
    if (student_t != 0) {
      if (lane_id() == 0) {
        Philox rng = stream_at(s0, s1, static_cast<uint64_t>(n), normal_words_end(1, D));
        scale = student_t_scale(mix[L.dof() + lat], rng);
      }
      scale = from_lane0(scale);
    }
    warp_affine(mix + L.L() + static_cast<long long>(lat) * D * D, mix + L.mu() + lat * D,
                sl.b, scale, D, [&](int i, float v) {
                  sl.c[i] = v;
                  xT[i * N + n] = v;
                });
    __syncwarp();   // x is whole; the normals' slice is x - mu's from here on
    const float lq = warp_mixture_logpdf(mix, K, D, student_t != 0, sl.c, sl.b);
    const float lp = log_p == nullptr ? 0.0f
        : warp_mixture_logpdf(tmix, Kt, D, t_student_t != 0, sl.c, sl.b);
    if (lane_id() == 0) {
      latent[n] = lat;
      log_q[n] = lq;
      if (log_p != nullptr) log_p[n] = lp;
    }
    __syncwarp();   // the slices are rewritten next
  }
}

}  // namespace pmc

// shared memory the launcher asks for (checked against ops/_build.py): both
// mixtures' operands (Kt = 0 without a target) if they fit, else none; past
// D = 128 the warp kernel's slices
extern "C" long long pmc_propose_logq_smem_bytes(int K, int Kt, int D) {
  if (D > pmc::kDMax) return static_cast<long long>(pmc::wide_smem_bytes(D));
  const size_t ops = sizeof(float) * (pmc::MixLayout{K, D}.size() +
                                      pmc::MixLayout{Kt, D}.eval_size());
  return static_cast<long long>(ops <= pmc::kSmemLimit ? ops : 0);
}

// tmix/log_p are null without a target
extern "C" int pmc_fused_propose_logq(unsigned int s0, unsigned int s1,
                                      const float* mix, const float* tmix,
                                      float* xT, int* latent, float* log_q,
                                      float* log_p, long long N, int K, int Kt,
                                      int D, int student_t, int t_student_t,
                                      int n_blocks, void* stream) {
  using namespace pmc;
  const size_t smem = pmc_propose_logq_smem_bytes(K, log_p != nullptr ? Kt : 0, D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D > kDMax && D <= kWideDMax)
    return launch_warp(propose_logq_warp_kernel, D, n_blocks, s, s0, s1, mix, tmix, xT, latent,
                       log_q, log_p, N, K, Kt, D, student_t, t_student_t);
  PMC_DISPATCH_D(D, PMC_DISPATCH_OPS(smem > 0, {
    cudaFuncSetAttribute(propose_logq_kernel<DMAX, OPS_SMEM>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    propose_logq_kernel<DMAX, OPS_SMEM><<<n_blocks, kThreads, smem, s>>>(
        s0, s1, mix, tmix, xT, latent, log_q, log_p, N, K, Kt, D, student_t,
        t_student_t);
  }));
  return static_cast<int>(cudaGetLastError());
}
