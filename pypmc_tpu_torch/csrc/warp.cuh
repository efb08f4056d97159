// Device code of the warp kernels: one warp a particle (or a chain), for
// dimensions past the thread kernels' per-thread arrays (D > 128) and for
// the warp-a-chain pool (mcmc_pool.cu).
//
// A warp keeps its particle, x - mu and the like in slices of shared memory
// of D + 8 floats (three a warp, common.cuh wide_smem_bytes).  The lanes
// take the rows of U, L or A in turn (row i on lane i % 32), each row's dot
// product a loop over a slice, j ascending as in the thread kernels' whiten,
// project and affine_transform, so that a row's value is theirs bit for
// bit; the squares of a whitening are summed by one warp reduction, whose
// order differs from the thread kernels' (float32 rounding).  The component
// operands are read where the caller keeps them: device memory (L2-resident)
// in the D > 128 kernels, 16-byte records in shared memory in the pool.
//
// Random streams: Philox is counter-based, so lane b computes block b of a
// particle's stream (counter c2 = b, the thread's b-th refill) and the warp
// draws exactly the words, normals and uniforms the thread-a-particle path
// draws from the same (seed, n).
#pragma once

#include "common.cuh"

namespace pmc {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// the sum of v over the warp, lane 0's handed to every lane (the butterfly
// gives each lane its own rounding; every lane must decide alike)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return __shfl_sync(kFullMask, v, 0);
}

// this warp's three slices of D + 8 floats (common.cuh wide_smem_bytes)
struct WarpSlices {
  float* a;
  float* b;
  float* c;
};
__device__ __forceinline__ WarpSlices warp_slices(float* smem, int D) {
  const int F = D + 8;
  float* base = smem + (threadIdx.x / 32) * 3 * F;
  return {base, base + F, base + 2 * F};
}

// the particles of a grid of warps, grid-stride
__device__ __forceinline__ long long warp_index() {
  return static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
}
__device__ __forceinline__ long long warp_count() {
  return static_cast<long long>(gridDim.x) * (blockDim.x / 32);
}

// the slice v = column n of xT (D, N)
__device__ __forceinline__ void warp_load(const float* xT, long long N, long long n, int D,
                                          float* v) {
  for (int j = lane_id(); j < D; j += 32) v[j] = xT[j * N + n];
  __syncwarp();
}

// sum over this lane's rows i = lane, lane + 32, ... < D of (row(i) . v)^2,
// row(i) the address of row i's first entry: its i + 1 entries for a lower
// triangular matrix (tri), else all D
template <typename Row>
__device__ __forceinline__ float lane_rows_sq(Row&& row, const float* v, int D, bool tri) {
  float acc = 0.0f;
  for (int i = lane_id(); i < D; i += 32) {
    const float* r = row(i);
    const int len = tri ? i + 1 : D;
    float s = 0.0f;
#pragma unroll 4
    for (int j = 0; j < len; ++j) s = fmaf(r[j], v[j], s);
    acc = fmaf(s, s, acc);
  }
  return acc;
}

// |M (x - mu)|^2 for the slice x, the rows of M given by row (lower
// triangular: whiten; full: project), with x - mu left in the slice xm
// (rewritten by the next call); every lane gets the value
template <typename Row>
__device__ __forceinline__ float warp_maha(Row&& row, const float* mu, const float* x,
                                           float* xm, int D, bool tri) {
  for (int j = lane_id(); j < D; j += 32) xm[j] = x[j] - mu[j];
  __syncwarp();
  const float m = warp_sum(lane_rows_sq(row, xm, D, tri));
  __syncwarp();
  return m;
}

// the mixture log-density of the slice x; ``mix`` the packed layout, in
// device memory; xm a slice of scratch
__device__ __forceinline__ float warp_mixture_logpdf(const float* mix, int K, int D, bool student_t,
                                            const float* x, float* xm) {
  const MixLayout L{K, D};
  WeightedLse acc;
  for (int k = 0; k < K; ++k) {
    const float* U = mix + L.U() + static_cast<long long>(k) * D * D;
    const float maha = warp_maha([&](int i) { return U + static_cast<long long>(i) * D; },
                                 mix + L.mu() + k * D, x, xm, D, true);
    acc.add(component_logpdf(maha, mix[L.ln() + k], mix[L.dof() + k], D, student_t),
            mix[L.w() + k]);
  }
  return acc.value();
}

// out(i, mu_i + scale (L z)_i) for this lane's rows i: L (D, D) row-major
// lower triangular, z a slice (affine_transform's FMA order)
template <typename Out>
__device__ __forceinline__ void warp_affine(const float* L, const float* mu, const float* z,
                                            float scale, int D, Out&& out) {
  for (int i = lane_id(); i < D; i += 32) {
    const float* r = L + static_cast<long long>(i) * D;
    float s = 0.0f;
#pragma unroll 4
    for (int j = 0; j <= i; ++j) s = fmaf(r[j], z[j], s);
    out(i, fmaf(scale, s, mu[i]));
  }
}

// The stream (s0, s1, n) from its ``word``-th word on.
__device__ __forceinline__ Philox stream_at(uint32_t s0, uint32_t s1, uint64_t n, int word) {
  Philox r(s0, s1, n);
  r.seek(word);
  return r;
}

// Words of the normals of draw_normals: Box-Muller pairs on words off + 2p,
// off + 2p + 1 of the stream, ceil(D / 2) pairs.
__host__ __device__ constexpr int normal_words_end(int off, int D) {
  return off + 2 * ((D + 1) / 2);
}

// D standard normals into the slice z: draw_normals' draws from the stream
// (s0, s1, n) after its first ``off`` words.  Lane b computes Philox block b
// into the slice ``words`` (the stream's words 0 .. normal_words_end - 1,
// rounded up to whole blocks: at most D + 5), then lane p forms pair p.
// The stream goes on at word normal_words_end(off, D) (stream_at).
__device__ __forceinline__ void warp_normals(uint32_t s0, uint32_t s1, uint64_t n, int off, int D,
                                    uint32_t* words, float* z) {
  const int end = normal_words_end(off, D);
  for (int b = lane_id(); 4 * b < end; b += 32) {
    Philox r(s0, s1, n);
    r.c2 = static_cast<uint32_t>(b);
    r.refill();
    words[4 * b] = r.b0;
    words[4 * b + 1] = r.b1;
    words[4 * b + 2] = r.b2;
    words[4 * b + 3] = r.b3;
  }
  __syncwarp();
  for (int p = lane_id(); 2 * p < D; p += 32) {
    float z0, z1;
    Philox::box_muller(words[off + 2 * p], words[off + 2 * p + 1], z0, z1);
    z[2 * p] = z0;
    if (2 * p + 1 < D) z[2 * p + 1] = z1;
  }
  __syncwarp();
}

// Launch a warp kernel of the D > 128 path (kWideThreads, its slices for D)
// on stream s; the launch's error.
template <typename Kernel, typename... Args>
int launch_warp(Kernel kernel, int D, int n_blocks, cudaStream_t s, Args... args) {
  const size_t smem = wide_smem_bytes(D);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_blocks, kWideThreads, smem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// v on lane 0, handed to every lane
template <typename T>
__device__ __forceinline__ T from_lane0(T v) {
  return __shfl_sync(kFullMask, v, 0);
}

}  // namespace pmc
