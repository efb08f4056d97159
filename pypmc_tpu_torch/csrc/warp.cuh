// Device code of the warp-a-chain pool (mcmc_pool.cu's warp variant): a
// warp's sums, the squared whitened distance of a point kept in a slice of
// shared memory, and a chain's normals drawn by the lanes.
//
// The lanes take the rows of U, L or A in turn (row i on lane i % 32), each
// row's dot product a loop over a slice, j ascending as in the thread
// kernels' whiten, project and affine_transform, so that a row's value is
// theirs bit for bit; the squares of a whitening are summed by one warp
// reduction, whose order differs from the thread kernels' (float32
// rounding).
//
// Random streams: Philox is counter-based, so lane b computes block b of a
// stream (counter c2 = b, the thread's b-th refill) and the warp draws
// exactly the words, normals and uniforms a thread draws from the same
// (seed, counter).
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

// The stream (s0, s1, n) from its ``word``-th word on.
__device__ __forceinline__ Philox stream_at(uint32_t s0, uint32_t s1, uint64_t n, int word) {
  Philox r(s0, s1, n);
  r.seek(word);
  return r;
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

// v on lane 0, handed to every lane
template <typename T>
__device__ __forceinline__ T from_lane0(T v) {
  return __shfl_sync(kFullMask, v, 0);
}

}  // namespace pmc
