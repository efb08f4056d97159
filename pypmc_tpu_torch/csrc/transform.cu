// fused_transform and fused_transform_rng: the per-particle mixture affine
// transform x_n = mu[latent_n] + (L[latent_n] z_n) * scale_n in the
// transposed layout -> xT (D, N).
//
// Replaces the Pallas kernels pypmc_tpu/ops/pallas_kernels.py:1014
// (fused_transform, body _transform_kernel) and :881 (fused_transform_rng,
// body _transform_rng_kernel, draw _propose_tile).  fused_transform takes
// the normals z (D, N) and the scales (N,); fused_transform_rng draws the
// normals and, for a Student-t mixture, the scale sqrt(dof / chi2(dof)) in
// the kernel: it is fused_propose_logq's draw (common.cuh draw_component)
// for a given component, without the evaluation.
//
// Bound on the H100: fused_transform reads D + 2 words and writes D a
// particle (at D = 10, 88 bytes) for D (D + 1) / 2 FMAs -- memory-bound;
// fused_transform_rng reads one word and writes D, and its Philox,
// Box-Muller and (Student-t) Marsaglia-Tsang work is SFU- and
// integer-bound rather than memory-bound.  Design: one thread per particle
// (grid-stride), the component's mean and lower Cholesky factor read from
// shared memory where they fit (threads of a warp read different
// components' entries: bank conflicts, not a broadcast), the product as a
// lower-triangular FMA chain in registers (local memory past D = 32), and
// the result written once as D coalesced rows.  The TPU's one-hot selector
// contractions over all K components become one indexed read: a thread
// touches only its own component.  The Philox stream of a particle is keyed
// by the seed and counted by the particle's index, as in propose_logq.cu,
// so the samples do not depend on the launch configuration.  Past D = 128
// (the *_warp_kernel pair) a warp takes a particle (warp.cuh): the normals
// in a slice of shared memory, drawn by the lanes block by block from the
// particle's Philox stream, so they are the thread path's, and the rows of
// L on the lanes, read from device memory.
#include "warp.cuh"

namespace pmc {

// the operand buffer: mu (K, D) | L (K, D, D) | dof (K)
__host__ __device__ inline size_t transform_floats(int K, int D) {
  return static_cast<size_t>(K) * D * (D + 1) + K;
}

template <int DMAX, bool OPS_SMEM>
__global__ void __launch_bounds__(kThreads)
transform_kernel(const float* __restrict__ zT, const int* __restrict__ latent,
                 const float* __restrict__ scale, const float* __restrict__ ops_src,
                 float* __restrict__ xT, long long N, int K, int D) {
  extern __shared__ float smem[];
  const float* mu = stage_operands<OPS_SMEM>(
      smem, ops_src, static_cast<int>(transform_floats(K, D)));
  __syncthreads();
  const float* L = mu + K * D;
  for (long long n = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       n < N; n += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int lat = latent[n];
    float z[DMAX], x[DMAX];
    load_particle<DMAX>(zT, N, n, D, z);
    affine_transform<DMAX>(L + lat * D * D, mu + lat * D, D, z, scale[n], x);
    store_particle<DMAX>(xT, N, n, D, x);
  }
}

template <int DMAX, bool OPS_SMEM>
__global__ void __launch_bounds__(kThreads)
transform_rng_kernel(uint32_t s0, uint32_t s1, const int* __restrict__ latent,
                     const float* __restrict__ ops_src, float* __restrict__ xT,
                     long long N, int K, int D, int student_t) {
  extern __shared__ float smem[];
  const float* mu = stage_operands<OPS_SMEM>(
      smem, ops_src, static_cast<int>(transform_floats(K, D)));
  __syncthreads();
  const float* L = mu + K * D;
  const float* dof = L + K * D * D;
  for (long long n = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       n < N; n += static_cast<long long>(gridDim.x) * blockDim.x) {
    Philox rng(s0, s1, static_cast<uint64_t>(n));
    float x[DMAX];
    draw_component<DMAX>(mu, L, dof, latent[n], D, student_t != 0, rng, x);
    store_particle<DMAX>(xT, N, n, D, x);
  }
}

__global__ void __launch_bounds__(kWideThreads)
transform_warp_kernel(const float* __restrict__ zT, const int* __restrict__ latent,
                      const float* __restrict__ scale, const float* __restrict__ ops,
                      float* __restrict__ xT, long long N, int K, int D) {
  extern __shared__ float smem[];
  const WarpSlices sl = warp_slices(smem, D);
  const float* L = ops + static_cast<long long>(K) * D;
  for (long long n = warp_index(); n < N; n += warp_count()) {
    warp_load(zT, N, n, D, sl.a);
    const int lat = latent[n];
    warp_affine(L + static_cast<long long>(lat) * D * D, ops + lat * D, sl.a, scale[n], D,
                [&](int i, float v) { xT[i * N + n] = v; });
    __syncwarp();   // the slice is rewritten next
  }
}

__global__ void __launch_bounds__(kWideThreads)
transform_rng_warp_kernel(uint32_t s0, uint32_t s1, const int* __restrict__ latent,
                          const float* __restrict__ ops, float* __restrict__ xT,
                          long long N, int K, int D, int student_t) {
  extern __shared__ float smem[];
  const WarpSlices sl = warp_slices(smem, D);
  const float* L = ops + static_cast<long long>(K) * D;
  const float* dof = L + static_cast<long long>(K) * D * D;
  for (long long n = warp_index(); n < N; n += warp_count()) {
    // draw_component's stream: the normals, then the Student-t scale
    warp_normals(s0, s1, static_cast<uint64_t>(n), 0, D, reinterpret_cast<uint32_t*>(sl.a),
                 sl.b);
    const int lat = latent[n];
    float scale = 1.0f;
    if (student_t != 0) {
      if (lane_id() == 0) {
        Philox rng = stream_at(s0, s1, static_cast<uint64_t>(n), normal_words_end(0, D));
        scale = student_t_scale(dof[lat], rng);
      }
      scale = from_lane0(scale);
    }
    warp_affine(L + static_cast<long long>(lat) * D * D, ops + lat * D, sl.b, scale, D,
                [&](int i, float v) { xT[i * N + n] = v; });
    __syncwarp();   // the slices are rewritten next
  }
}

}  // namespace pmc

// shared memory either launcher asks for (checked against ops/_build.py):
// the operands if they fit, else none; past D = 128 the warp kernels' slices
extern "C" long long pmc_transform_smem_bytes(int K, int D) {
  if (D > pmc::kDMax) return static_cast<long long>(pmc::wide_smem_bytes(D));
  const size_t ops = sizeof(float) * pmc::transform_floats(K, D);
  return static_cast<long long>(ops <= pmc::kSmemLimit ? ops : 0);
}

// ops: mu (K, D) | L (K, D, D) | dof (K); zT, xT: (D, N); latent, scale: (N,)
extern "C" int pmc_fused_transform(const float* zT, const int* latent,
                                   const float* scale, const float* ops,
                                   float* xT, long long N, int K, int D,
                                   int n_blocks, void* stream) {
  using namespace pmc;
  const size_t smem = pmc_transform_smem_bytes(K, D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D > kDMax && D <= kWideDMax)
    return launch_warp(transform_warp_kernel, D, n_blocks, s, zT, latent, scale, ops, xT, N,
                       K, D);
  PMC_DISPATCH_D(D, PMC_DISPATCH_OPS(smem > 0, {
    cudaFuncSetAttribute(transform_kernel<DMAX, OPS_SMEM>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    transform_kernel<DMAX, OPS_SMEM><<<n_blocks, kThreads, smem, s>>>(
        zT, latent, scale, ops, xT, N, K, D);
  }));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pmc_fused_transform_rng(unsigned int s0, unsigned int s1,
                                       const int* latent, const float* ops,
                                       float* xT, long long N, int K, int D,
                                       int student_t, int n_blocks, void* stream) {
  using namespace pmc;
  const size_t smem = pmc_transform_smem_bytes(K, D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D > kDMax && D <= kWideDMax)
    return launch_warp(transform_rng_warp_kernel, D, n_blocks, s, s0, s1, latent, ops, xT, N,
                       K, D, student_t);
  PMC_DISPATCH_D(D, PMC_DISPATCH_OPS(smem > 0, {
    cudaFuncSetAttribute(transform_rng_kernel<DMAX, OPS_SMEM>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    transform_rng_kernel<DMAX, OPS_SMEM><<<n_blocks, kThreads, smem, s>>>(
        s0, s1, latent, ops, xT, N, K, D, student_t);
  }));
  return static_cast<int>(cudaGetLastError());
}
