// The tensor-core product of fused_maha from D = 9 to 64 (maha.cu
// maha_mma_kernel; past D = 64 mma_tiled.cuh's maha_mma_tiled_kernel, which
// shares the split, the mma and the FP32 recomputation below): out[k, n] =
// |A_k (x_n - m_k)|^2 for general (D, D) matrices A_k, lower, upper or
// full, by mma.sync in three split TF32 products (3xTF32).  ops/_build.py
// mma_plan mirrors the plan and MAHA_MMA_D_MIN the election.
//
// Replaces, where it is elected, maha_kernel (the record kernel, maha.cu)
// for the Pallas kernel pypmc_tpu/ops/pallas_kernels.py:858 (fused_maha,
// body _maha_kernel), which runs the same product on the TPU's matrix unit
// as three split bf16 passes (_dot_val, ~2^-16 relative error).  Hopper's
// counterpart is the split TF32 product: v = hi + lo, hi and lo each rounded
// to TF32, a b ~= a_hi b_hi + (a_hi b_lo + a_lo b_hi), lo lo dropped: ~2^-21
// relative error, where one TF32 product keeps ~2^-11.  The rounding is
// cvt.rn (to nearest, ties to even), one instruction on sm_90a
// (F2FP.TF32.F32.PACK_B), where cvt.rna (ties away) is emulated by three or
// four; the two differ only at exact ties.
//
// Bound on the H100: 3 x 2 K D^2 N TF32 operations (at D: the zero
// products of the padding to 8 are the kernel's cost, not the function's)
// at 495 TFLOP/s against 4 (D + K) N bytes: at K = 32, D = 40, 2^20
// particles 322 GFLOP, 0.65 ms, against 0.09 ms of bytes and the FP32
// bound of the record kernel's D^2 FMAs, 1.66 ms.
//
// Design.  The product Y_k = A_k (X - m_k) of one warp is mma.sync
// m16n8k8 tiles: M = 16 particles, N = 8 rows i of A_k, depth 8 coordinates
// j, with B[j][i] = A_k[i][j], so that A_k by rows is B in the .col layout
// (fragment layouts: CUTLASS's SM80_16x8x8_F32TF32TF32F32_TN).  A warp holds
// MT m-tiles (32 particles to D = 40, 16 past it: the accumulators take 8 MT
// Dp / 8 registers, 80 at D = 40) and all Dp / 8 n-tiles, and walks the
// depth: per 8 coordinates it forms x - m_k in FP32, in registers (as the
// record kernel does; no b_k = A_k m_k, so there is no cancellation to
// guard against), splits it, and runs three mma a tile, the big product into
// one accumulator and the two small ones into another, added at the end.
// One instantiation a Dp (8 to 64), so that the depth and the n-tiles are
// constants.  A block of 8 warps (6 past D = 24: mma_warps), two an SM,
// walks its particle tiles (grid-stride) and for each the components in
// chunks:
// - the x tile is copied by 4-byte cp.async straight into the fragment
//   order of the A operand (a thread's four words of an m-tile and depth
//   step one LDS.128), zero past D and past N; where the whole set of
//   components fits beside two x tiles, the next tile's copy is in flight
//   while this one is computed;
// - the chunk's components are copied as the record kernel's VB records
//   (stage_records_async) by cp.async, the next chunk's copy in flight
//   while this one is computed, then split once into hi and lo beside them:
//   row i of A_k as Dp / 2 float4s {hi A[i][8s + t], hi A[i][8s + t + 4],
//   lo A[i][8s + t], lo A[i][8s + t + 4]}, so that a thread's B fragment of
//   both halves is one LDS.128, the row stride a float4 count = 4 (mod 8) so
//   that the 8 rows a quarter-warp reads hit distinct banks; m_k as pairs
//   {m[8s + t], m[8s + t + 4]}.  Where the whole set fits one chunk it is
//   split once for all tiles.
// Epilogue: each thread squares its accumulators (the two columns it holds,
// all n-tiles), the four lanes of a row group are joined by a
// reduce-scatter (shfl_xor 2, then 1), and each lane writes one particle's
// value: a warp's 32 particles of a component are one 128-byte line, one
// coalesced store, no atomics, a fixed order, so one input gives one output.
// Padding is exact zeros (A past D, m past D, x past D and past N), so no
// garbage reaches a sum.  A non-finite input makes the value non-finite
// (the split's lo of an infinity is NaN), but not always as the FP32
// product does (0 x inf is NaN there); so a lane whose value is not finite
// recomputes it in the record kernel's FP32 arithmetic from device memory
// (maha_fp32: rare, the particles with a non-finite coordinate), which
// gives the record kernel's infinities and NaNs.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace pmc {

// warps a block: 8 to D = 24 (at most 128 registers a thread); 6 past it,
// where a thread takes up to 168 and two blocks still share an SM (ptxas on
// sm_90a: Dp = 32 spilled at 128; Dp = 40, two m-tiles, 80 accumulators,
// takes 164)
__host__ __device__ constexpr int mma_warps(int D) { return D <= 24 ? 8 : 6; }
__host__ __device__ constexpr int mma_threads(int D) { return 32 * mma_warps(D); }
// D padded to the mma depth: A, m and x are zero past D
__host__ __device__ constexpr int mma_dpad(int D) { return (D + 7) / 8 * 8; }
// 16-particle m-tiles a warp: two to D = 40, one past it (registers: the
// accumulators take 8 MT Dp / 8 a thread)
__host__ __device__ constexpr int mma_mtiles(int D) { return D <= 40 ? 2 : 1; }
// particles a block tile
__host__ __device__ constexpr int mma_tile(int D) { return mma_warps(D) * 16 * mma_mtiles(D); }
// float4s a row of a split A_k (two columns each), made 4 (mod 8): the 8
// rows one quarter-warp's LDS.128 reads start in distinct banks
__host__ __device__ constexpr int mma_row4(int Dp) { return Dp / 2 % 8 == 0 ? Dp / 2 + 4 : Dp / 2; }
// floats of one split component: A_k's rows, then m_k's pairs
__host__ __device__ constexpr int mma_split_floats(int D) {
  return 4 * mma_dpad(D) * mma_row4(mma_dpad(D)) + mma_dpad(D);
}

struct MmaPlan {
  int kc;          // components a chunk
  int n_chunks;    // chunks of the K components
  int x_buffers;   // x tiles in shared memory: 2 where the next one is copied ahead
  size_t smem;     // shared memory a block: x tiles, raw records, split records
};

// The plan of maha_mma_kernel at (K, D <= 64), in half an SM (two blocks
// share it): the whole set of components (raw VB record and split record
// each) beside two x tiles where it fits, else one x tile and the largest
// equal chunks of components that fit beside it (D = 64: a tile and one
// component take 78,352 B).
__host__ __device__ inline MmaPlan mma_plan(int K, int D) {
  const size_t x = sizeof(float) * mma_dpad(D) * mma_tile(D);
  const size_t comp = sizeof(float) * (vb_rec_floats(D) + mma_split_floats(D));
  if (2 * x + K * comp <= kHalfSmem) return {K, 1, 2, 2 * x + K * comp};
  const int most = static_cast<int>((kHalfSmem - x) / comp);
  const int n_chunks = (K + most - 1) / most;
  const int kc = (K + n_chunks - 1) / n_chunks;
  return {kc, n_chunks, 1, x + kc * comp};
}

// the smallest D at which fused_maha elects its tensor-core kernel
// (ops/_build.py MAHA_MMA_D_MIN): maha_mma_kernel over maha_kernel to D =
// 64, the first D past the record kernel's DMAX 8 bucket; in the buckets 16,
// 32, 40 and 64 its device time beat the record kernel's at every K timed
// there, in one call, and at DMAX 8, K = 1 it lost by 12%; past D = 64
// maha_mma_tiled_kernel (mma_tiled.cuh) over maha_tiled_kernel at every D
// (chip_smoke.py --maha-times, PERF.md)
constexpr int kMahaMmaDMin = 9;

// v rounded to TF32, to nearest, ties to even (its low 13 bits 0)
__device__ __forceinline__ uint32_t tf32_rn(float v) {
  uint32_t u;
  asm("cvt.rn.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(v));
  return u;
}

// v = hi + lo, both TF32
__device__ __forceinline__ void tf32_split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rn(v);
  lo = tf32_rn(v - __uint_as_float(hi));
}

// the instantiation of maha_mma_kernel for D (Dp = mma_dpad(D), 8 to 64):
// body(std::integral_constant<int, Dp>()); cudaErrorInvalidValue past 64
template <typename Body>
int dispatch_mma(int D, Body&& body) {
  switch (mma_dpad(D)) {
    case 8: return body(std::integral_constant<int, 8>());
    case 16: return body(std::integral_constant<int, 16>());
    case 24: return body(std::integral_constant<int, 24>());
    case 32: return body(std::integral_constant<int, 32>());
    case 40: return body(std::integral_constant<int, 40>());
    case 48: return body(std::integral_constant<int, 48>());
    case 56: return body(std::integral_constant<int, 56>());
    case 64: return body(std::integral_constant<int, 64>());
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// d += a b: one m16n8k8 TF32 product, FP32 accumulators (a: A fragment,
// rows g and g + 8, columns t and t + 4; b0, b1: B fragment, rows t and t +
// 4, column g; d: rows g and g + 8, columns 2t and 2t + 1)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b (zero accumulators)
__device__ __forceinline__ void mma_tf32_first(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  const float z = 0.0f;
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(z));
}

// The x tile of particles p0 .. p0 + P - 1 (P = mma_tile) of xT (D, N),
// coordinates to DP, at xs by 4-byte cp.async in the A operand's fragment
// order: float4 ((w DP / 8 + s) MT + mt) 32 + lane of warp w, depth step s,
// m-tile mt holds {x[g][t], x[g + 8][t], x[g][t + 4], x[g + 8][t + 4]} of
// its 16 particles and 8 coordinates (g = lane / 4, t = lane % 4); 0 past D
// and past N.  Thread p % P copies particle p's coordinates (of every
// step, or with MT = 1 of every other step), so consecutive threads read
// consecutive particles of a row.
template <int DP, int MT>
__device__ __forceinline__ void mma_stage_x(float* xs, const float* xT, long long N, int D,
                                            long long p0) {
  constexpr int NS = DP / 8, P = mma_tile(DP), TPP = mma_threads(DP) / P;
  const int p = threadIdx.x % P, w = p / (16 * MT), mt = p / 16 % MT, q = p % 16;
  const long long n = p0 + p;
  float* dst = xs + (w * NS * MT + mt) * 128 + q % 8 * 16 + q / 8;
#pragma unroll 1
  for (int s = threadIdx.x / P; s < NS; s += TPP) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = 8 * s + jj;
      const bool valid = j < D && n < N;
      cp_async_f32(dst + s * MT * 128 + jj % 4 * 4 + 2 * (jj / 4),
                   valid ? xT + static_cast<long long>(j) * N + n : xT, valid);
    }
  }
}

// Split the kc VB records at raw (stage_records_async: m | 4 | A's rows
// padded to pad4(D)) into split records at split (mma_split_floats apart):
// row i of A_k as float4s {hi A[i][j], hi A[i][j + 4], lo A[i][j], lo A[i][j
// + 4]}, j = 8s + t, at i R4 + 4s + t; then m_k's pairs {m[j], m[j + 4]} at
// 4 DP R4 + 2 (4s + t); 0 past D.  All threads; __syncthreads() after.
template <int DP>
__device__ __forceinline__ void mma_split_records(float* split, const float* raw, int kc, int D) {
  constexpr int NS = DP / 8, R4 = mma_row4(DP), SF = mma_split_floats(DP);
  constexpr int rows = DP * NS * 4, per = rows + NS * 4;
  const int D4 = pad4(D), F = vb_rec_floats(D);
  for (int e = threadIdx.x; e < kc * per; e += mma_threads(DP)) {
    const int c = e / per, r = e - c * per;
    const float* rec = raw + c * F;
    float* out = split + c * SF;
    if (r < rows) {
      const int i = r / (NS * 4), q = r % (NS * 4), j = q / 4 * 8 + q % 4;
      const float* row = rec + D4 + 4 + i * D4;
      const float v0 = i < D && j < D ? row[j] : 0.0f;
      const float v1 = i < D && j + 4 < D ? row[j + 4] : 0.0f;
      uint32_t h0, l0, h1, l1;
      tf32_split(v0, h0, l0);
      tf32_split(v1, h1, l1);
      reinterpret_cast<float4*>(out)[i * R4 + q] =
          make_float4(__uint_as_float(h0), __uint_as_float(h1), __uint_as_float(l0),
                      __uint_as_float(l1));
    } else {
      const int q = r - rows, j = q / 4 * 8 + q % 4;
      reinterpret_cast<float2*>(out + 4 * DP * R4)[q] =
          make_float2(j < D ? rec[j] : 0.0f, j + 4 < D ? rec[j + 4] : 0.0f);
    }
  }
}

// The squares of one m-tile's rows y = big + small a thread holds, its two
// columns of every n-tile: e0 for particle g, e1 for g + 8.
template <int NT>
__device__ __forceinline__ void mma_squares(const float (&big)[NT][4],
                                            const float (&small)[NT][4], float& e0,
                                            float& e1) {
  e0 = 0.0f;
  e1 = 0.0f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    float y[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) y[q] = big[nt][q] + small[nt][q];
    e0 = fmaf(y[0], y[0], e0);
    e0 = fmaf(y[1], y[1], e0);
    e1 = fmaf(y[2], y[2], e1);
    e1 = fmaf(y[3], y[3], e1);
  }
}

// |A_k (x_n - m_k)|^2 in the record kernel's FP32 arithmetic (project's FMA
// order), from device memory: A_k (D, D), m_k (D), particle n of xT (D, N);
// static, as this header is compiled into several objects of one library
static __device__ __noinline__ float maha_fp32(const float* Ak, const float* mk, const float* xT,
                                        long long N, int D, long long n) {
  return maha_fp32_body(Ak, mk, xT, N, D, n);
}

// One warp's squares of its particles against the kc split components at
// split (components k0 ..): out[(k0 + c) N + n] for its 16 MT particles of
// the tile at p0 (those below N); a value that is not finite recomputed by
// maha_fp32 from xT (D, N), A (K, D, D) and m (K, D).  DP: D padded to 8.
template <int DP, int MT>
__device__ __forceinline__ void mma_chunk(const float* xs, const float* split, int kc, int k0,
                                          long long p0, const float* xT, const float* A,
                                          const float* m, long long N, int D, float* out) {
  constexpr int NS = DP / 8, R4 = mma_row4(DP), SF = mma_split_floats(DP);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane / 4, t = lane % 4;
  const float4* xw = reinterpret_cast<const float4*>(xs) + warp * NS * MT * 32 + lane;
  for (int c = 0; c < kc; ++c) {
    const float* comp = split + c * SF;
    const float4* B = reinterpret_cast<const float4*>(comp) + g * R4 + t;
    const float2* M = reinterpret_cast<const float2*>(comp + 4 * DP * R4) + t;
    float big[MT][NS][4], small[MT][NS][4];
    // depth step s: x - m_k split, then the three products of every tile
    const auto step = [&](int s, auto first) {
      const float2 mm = M[4 * s];
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float4 xv = xw[(s * MT + mt) * 32];
        tf32_split(xv.x - mm.x, ah[mt][0], al[mt][0]);
        tf32_split(xv.y - mm.x, ah[mt][1], al[mt][1]);
        tf32_split(xv.z - mm.y, ah[mt][2], al[mt][2]);
        tf32_split(xv.w - mm.y, ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
        const float4 b = B[nt * 8 * R4 + 4 * s];
        const uint32_t bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
        const uint32_t bl0 = __float_as_uint(b.z), bl1 = __float_as_uint(b.w);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if constexpr (decltype(first)::value) {
            mma_tf32_first(big[mt][nt], ah[mt], bh0, bh1);
            mma_tf32_first(small[mt][nt], ah[mt], bl0, bl1);
          } else {
            mma_tf32(big[mt][nt], ah[mt], bh0, bh1);
            mma_tf32(small[mt][nt], ah[mt], bl0, bl1);
          }
          mma_tf32(small[mt][nt], al[mt], bh0, bh1);
        }
      }
    };
    step(0, std::true_type());
#pragma unroll 1
    for (int s = 1; s < NS; ++s) step(s, std::false_type());
    // v[2 mt + h]: the thread's squares of particle 16 mt + 8 h + g
    float v[2 * MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) mma_squares(big[mt], small[mt], v[2 * mt], v[2 * mt + 1]);
    // reduce-scatter over the row group's 4 lanes: lane t ends with
    // particle 8 t + g (MT = 2), or 8 (t % 2) + g (MT = 1; lanes 0, 1 write)
    const unsigned all = 0xffffffffu;
    const bool b1 = t & 2, b0 = t & 1;
    float w0, w1;
    if constexpr (MT == 2) {
      w0 = (b1 ? v[2] : v[0]) + __shfl_xor_sync(all, b1 ? v[0] : v[2], 2);
      w1 = (b1 ? v[3] : v[1]) + __shfl_xor_sync(all, b1 ? v[1] : v[3], 2);
    } else {
      w0 = v[0] + __shfl_xor_sync(all, v[0], 2);
      w1 = v[1] + __shfl_xor_sync(all, v[1], 2);
    }
    float value = (b0 ? w1 : w0) + __shfl_xor_sync(all, b0 ? w0 : w1, 1);
    const long long n = p0 + warp * 16 * MT + 8 * t + g;
    if ((MT == 2 || t < 2) && n < N) {
      const long long k = k0 + c;
      if (!isfinite(value)) value = maha_fp32(A + k * D * D, m + k * D, xT, N, D, n);
      out[k * N + n] = value;
    }
  }
}

// fused_maha's tensor-core loop (maha_mma_kernel<DP>, mma_dpad(D) = DP): A
// (K, D, D), m (K, D); smem: mma_plan's.
template <int DP>
__device__ __forceinline__ void mma_maha(float* smem, const float* xT, const float* A,
                                         const float* m, float* out, long long N, int K, int D) {
  constexpr int MT = mma_mtiles(DP), P = mma_tile(DP);
  const MmaPlan plan = mma_plan(K, D);
  float* raw = smem + plan.x_buffers * DP * P;
  float* split = raw + plan.kc * vb_rec_floats(D);
  const long long n_tiles = (N + P - 1) / P;
  long long tile = blockIdx.x;
  if (tile >= n_tiles) return;
  const auto stage_raw = [&](int c) {
    const int k0 = c * plan.kc;
    stage_records_async(raw, m, A, m, 0, K, k0, min(plan.kc, K - k0), D, false);
  };
  mma_stage_x<DP, MT>(smem, xT, N, D, tile * P);
  stage_raw(0);
  cp_async_commit();
  bool split_once = false;   // one chunk, split for every tile
  for (int b = 0; tile < n_tiles; tile += gridDim.x, b ^= plan.x_buffers - 1) {
    const float* xs = smem + b * DP * P;
    const bool more = tile + gridDim.x < n_tiles;
    for (int c = 0; c < plan.n_chunks; ++c) {
      const int k0 = c * plan.kc, kc = min(plan.kc, K - k0);
      cp_async_wait<0>();   // the x tile (c = 0) and chunk c's records have landed
      __syncthreads();      // and every warp is done with the split records (and,
                            // c = 0, with the other x tile)
      if (!split_once) {
        mma_split_records<DP>(split, raw, kc, D);
        __syncthreads();
        if (plan.n_chunks > 1) {   // the next chunk's records, this tile's or the next's
          if (c + 1 < plan.n_chunks || more) stage_raw((c + 1) % plan.n_chunks);
        } else {
          split_once = true;
        }
      }
      if (c == 0 && plan.x_buffers == 2 && more)   // the next x tile, ahead
        mma_stage_x<DP, MT>(smem + (b ^ 1) * DP * P, xT, N, D, (tile + gridDim.x) * P);
      cp_async_commit();
      mma_chunk<DP, MT>(xs, split, kc, k0, tile * P, xT, A, m, N, D, out);
    }
    if (plan.x_buffers == 1) {
      __syncthreads();      // every warp is done with the x tile
      if (more) mma_stage_x<DP, MT>(smem, xT, N, D, (tile + gridDim.x) * P);
      cp_async_commit();
    }
  }
}

}  // namespace pmc
