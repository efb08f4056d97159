// The tensor-core product of fused_maha past D = 64 (maha.cu
// maha_mma_tiled_kernel, after mma_split_kernel<false>): out[k, n] = |A_k (x_n -
// m_k)|^2 for general (D, D) matrices A_k, lower, upper or full, by mma.sync
// in three split TF32 products (3xTF32), as mma.cuh's kernel computes it to
// D = 64.  The same walk with TRI on a lower-triangular U_k and an
// epilogue of the caller's is fused_logq's and fused_rho's past D = 64
// (logq.cu logq_mma_tiled_kernel, rho.cu rho_mma_tiled_kernel, after
// mma_split_kernel<true>), which replace logq_tiled_kernel and
// rho_tiled_kernel for the Pallas kernels pallas_kernels.py:788 and :826.
// ops/_build.py mma_tiled_plan, mma_tile_panels and mma_scratch_floats
// mirror the constants.
//
// Replaces, where it is elected (from D = 65 to kWideDMax: csrc/tiled.cuh
// maha_variant), maha_tiled_kernel (the FP32 block-tiled kernel of
// tiled.cuh) for the Pallas kernel pypmc_tpu/ops/pallas_kernels.py:858
// (fused_maha, body _maha_kernel), which runs the product on the TPU's
// matrix unit as three split bf16 passes.  The split and its error are
// mma.cuh's: v = hi + lo, both rounded to TF32 by cvt.rn, a b ~= a_hi b_hi +
// (a_hi b_lo + a_lo b_hi), ~2^-21 of a product.
//
// Bound on the H100: 3 x 2 K D^2 N TF32 operations at 495 TFLOP/s against 4
// (D + K) N bytes: at K = 19, D = 200, 2^16 particles 299 GFLOP, 0.60 ms,
// against 0.02 ms of bytes; the FP32 bound of the tiled kernel's 2 K D^2 N
// FMAs is 1.49 ms.  Operations, by 30x: the design keeps the tensor cores
// fed from shared memory.  What holds it (NVIDIA H100 80GB HBM3, 700 W,
// chip_smoke.py --maha-split, PERF.md): each product beyond the first adds
// ~217 TFLOP/s' worth of time, the rate mma.sync reaches here, and the
// copies, barriers and epilogue (~0.7 ms of 2.28 at K = 19, D = 200) overlap
// it only in part; wgmma with TMA is the next step.
//
// Design.  mma_split_kernel first writes every A_k once a launch, split,
// into a scratch the wrapper allocates (mma_scratch_floats: 8 K Dp Dd
// bytes, Dp = D padded to 8, Dd to a panel), in mma.cuh's B-fragment order:
// row i as float4s {hi A[i][8s + t], hi A[i][8s + t + 4], lo A[i][8s + t],
// lo A[i][8s + t + 4]}, so that a panel of A is one stream of 16-byte
// cp.async copies and no tile splits it again.  A block of kMtThreads
// (8 warps) walks its particle tiles (grid-stride) and in each tile the
// components, the row tiles of kMtM rows of A_k (those below Dp), and for
// each row tile the depth panels of kMtK coordinates.  A step is one (k,
// row tile, panel): its split A panel (rows kMtARow4 float4s apart, 4 (mod
// 8), so that the 8 rows a quarter-warp's LDS.128 reads start in distinct
// banks), its X panel (kMtK rows of xT, kMtP particle columns, rows
// kMtXStride floats apart, so that a warp's fragment reads hit 32 banks;
// 16-byte copies where N is a multiple of 4 (and xT 16-byte aligned),
// 4-byte ones elsewhere: 7-11%
// of the kernel's time at 2^16, chip_smoke.py --maha-split, PERF.md) and
// its m_k panel are copied by cp.async into one of kMtStages buffers,
// the next two steps' copies in flight while this one is computed, so the
// pipeline runs on across panels, row tiles, components and tiles.  The X
// panel is re-staged, and split again, for every row tile and component: a
// tile's whole X (128 particles x D x 4 B, 122 KB at D = 200 with its row
// padding) does not fit beside the ring's A panels (123 KB), and the split
// is ~4% of the time (--maha-split).  Warp w holds 64 particles (four
// m-tiles of 16, particle group w % 2 of the tile) x 32 rows of A_k (four
// n-tiles of 8, row group w / 2; kMtWarps = 16, 32 particles a warp, was
// within 9% either way, PERF.md): per depth step of 8 it reads
// its x words (4 a thread an m-tile, x - m_k formed in FP32 as they are read,
// as the record kernel does; no b_k = A_k m_k, so no cancellation to guard
// against), splits them by cvt.rn, and for each n-tile reads one LDS.128 of
// hi and lo B words that feeds 12 mma (three a m-tile): 8 loads feed 48 mma,
// where mma.cuh's warp of one m-tile feeds 3 mma a load.  Two accumulator
// sets, hi hi in one and hi lo + lo hi in the other (128 registers; 237 a
// thread in all, no spill), added at the row tile's end.  An n-tile past Dp and a depth step past Dp are
// skipped (warp-uniform), so padding costs what D padded to 8 costs.
// Epilogue: at a row tile's end each thread squares its accumulators (its
// two columns of every n-tile), the four lanes of a row group are joined by
// a reduce-scatter (shfl_xor 2, then 1), and each lane adds its two
// particles' sums into registers; at the component's end each warp writes
// its 64 partials to shared memory and thread p sums particle p's four row
// groups in order: no atomics, a fixed order, one input gives one output,
// and each store of a component's 128 particles is coalesced (fused_logq's
// and fused_rho's epilogue, tiled.cuh LogqEpi and RhoEpi, takes the value
// there instead of the store).  With TRI the steps' blocks above the
// diagonal, whose split words are 0 (mma_split_operand<true>), are skipped:
// the panels right of a row tile's last row below D, and within a panel a
// warp's depth step that starts past its 32 rows and each (n-tile, depth
// step) whose first column is past the n-tile's last row, ~half the mma of
// a general A at D = 200.  Padding is
// exact zeros (A past D in the scratch, m and x past D, x past N).  A value
// that is not finite is recomputed in the record kernel's FP32 arithmetic
// from device memory (mma.cuh maha_fp32), which gives the record kernel's
// infinities and NaNs, 0 x inf = NaN included (maha_tiled_kernel's rows
// padded to 128 add fmaf(0, inf, s) = NaN, so it can give NaN where this
// gives +inf).
#pragma once

#include <cstdint>

#include "mma.cuh"

// PMC_MAHA_OFF (chip_smoke.py --maha-split; 0 in the library) is a mask of
// MahaOff parts of maha_mma_tiled_kernel left out, its output then wrong by
// design, to see where its time goes.
#ifndef PMC_MAHA_OFF
#define PMC_MAHA_OFF 0
#endif

namespace pmc {

enum MahaOff : int {
  kMahaOffSplit = 1,    // the x words' split: hi the x - m_k words, lo 0 (the products stay)
  kMahaOffSmall = 2,    // the two small products (hi lo, lo hi)
  kMahaOffCopies = 4,   // the step buffers' copies past the first kMtStages - 1 steps
  kMahaOffMma = 8,      // every product (and so the fragments' loads and the split)
};
__host__ __device__ constexpr bool maha_on(int part) { return (PMC_MAHA_OFF & part) == 0; }

constexpr int kMtP = 128;          // particles a block tile
constexpr int kMtM = 128;          // rows of A_k a row tile
constexpr int kMtK = 32;           // depth of a panel: four mma depth steps
constexpr int kMtWarps = 8;        // warps a block: 4 row groups x kMtWarps / 4 particle groups
constexpr int kMtThreads = 32 * kMtWarps;
constexpr int kMtWP = kMtWarps / 4;          // particle groups
constexpr int kMtMT = kMtP / 16 / kMtWP;     // 16-particle m-tiles a warp
constexpr int kMtStages = 3;       // step buffers: two copies in flight beside the one computed
constexpr int kMtXStride = kMtP + 8;     // floats a row of an X panel
constexpr int kMtARow4 = kMtK / 2 + 4;   // float4s a row of an A panel, 4 (mod 8)
constexpr int kMtAFloats = 4 * kMtM * kMtARow4;
constexpr int kMtXFloats = kMtK * kMtXStride;
constexpr int kMtStageFloats = kMtAFloats + kMtXFloats + kMtK;   // A, X and m panels
constexpr int kMtRedFloats = 4 * kMtP;   // the four row groups' partials of a component
// shared memory of a block: kMtStages step buffers, the partials
constexpr size_t kMmaTiledSmem = sizeof(float) * (kMtStages * kMtStageFloats + kMtRedFloats);
constexpr int kMtSplitThreads = 256;     // mma_split_kernel's block

static_assert(kMtWarps % 4 == 0 && kMtM == 4 * 32 && kMtMT % 2 == 0 && kMtMT * 16 * kMtWP == kMtP,
              "warps of 16 kMtMT particles x 32 rows");
static_assert(kMtARow4 % 8 == 4 && kMtStageFloats % 4 == 0, "banks and 16-byte alignment");
static_assert(kMtM * kMtK / 2 % kMtThreads == 0 && kMtK * kMtP / 4 % kMtThreads == 0 &&
                  kMtThreads % kMtP == 0,
              "whole copies a thread");
static_assert(kMmaTiledSmem <= kSmemLimit, "one block an SM");

// D padded to a panel: the depth of a split row
__host__ __device__ constexpr int mma_tiled_depth(int D) { return (D + kMtK - 1) / kMtK * kMtK; }

// floats of mma_split_kernel's output: K components of mma_dpad(D) rows of
// mma_tiled_depth(D) hi and lo words (ops/_build.py mma_scratch_floats)
__host__ __device__ inline long long mma_scratch_floats(int K, int D) {
  return 2LL * K * mma_dpad(D) * mma_tiled_depth(D);
}

// a 16-byte copy from device memory to shared memory (both 16-byte
// aligned); zeros where not valid
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid = true) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// mma_split_kernel's body: A (K, D, D) split into ``split`` (K, Dp, Dd / 2)
// float4s, float4 (k, i, 4 s + t) = {hi A[i][j], hi A[i][j + 4], lo A[i][j],
// lo A[i][j + 4]}, j = 8 s + t; 0 past D and, TRI (a lower-triangular U, of
// which only the lower triangle is read, as the record and tiled kernels
// read it), above the diagonal.  Grid-stride.
template <bool TRI>
__device__ __forceinline__ void mma_split_operand(const float* A, float4* split, int K, int D) {
  const int Dp = mma_dpad(D), H = mma_tiled_depth(D) / 2;
  const long long total = static_cast<long long>(K) * Dp * H;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < total;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int q = static_cast<int>(e % H);
    const long long r = e / H;
    const int i = static_cast<int>(r % Dp), j = q / 4 * 8 + q % 4;
    float v0 = 0.0f, v1 = 0.0f;
    if (i < D) {
      const float* row = A + (r / Dp * D + i) * D;
      if (j < D && (!TRI || j <= i)) v0 = row[j];
      if (j + 4 < D && (!TRI || j + 4 <= i)) v1 = row[j + 4];
    }
    uint32_t h0, l0, h1, l1;
    tf32_split(v0, h0, l0);
    tf32_split(v1, h1, l1);
    split[e] = make_float4(__uint_as_float(h0), __uint_as_float(h1), __uint_as_float(l0),
                           __uint_as_float(l1));
  }
}

// A split once a launch (tiled.cuh launch_mma_tiled): TRI, U of the packed
// mix (logq.cu, rho.cu); else fused_maha's general A (maha.cu)
template <bool TRI>
__global__ void __launch_bounds__(kMtSplitThreads)
mma_split_kernel(const float* __restrict__ A, float4* __restrict__ split, int K, int D) {
  mma_split_operand<TRI>(A, split, K, D);
}

// the depth panels of row tile rt: every panel of a general A; of a
// lower-triangular U (TRI) those at or left of the row tile's last row
// below D, as tiled.cuh tile_panels
__device__ __forceinline__ int mma_tile_panels(int rt, int D, bool tri) {
  if (!tri) return mma_tiled_depth(D) / kMtK;
  return (min(D, (rt + 1) * kMtM) - 1) / kMtK + 1;
}

// The tensor-core walk past D = 64 (maha_mma_tiled_kernel, and with TRI
// logq_mma_tiled_kernel and rho_mma_tiled_kernel): for every particle n of
// its tiles and every component k, ascending, hands |A_k (x_n - m_k)|^2 to
// epi(k, n, value) on thread n % kMtP (threads 0 .. kMtP - 1; n may be past
// N, and then epi must not write), a value that is not finite recomputed by
// maha_fp32 on A_k whole first.  xT (D, N), A (K, D, D) (TRI: lower
// triangular U), m (K, D), split: the split of A (mma_split_kernel<TRI>);
// TRI skips the panels right of a row tile's last
// row and, within a panel, each warp's (n-tile, depth step) blocks that lie
// wholly above the diagonal, whose split words are 0.  smem: kMmaTiledSmem
// bytes, 16-byte aligned.
template <bool TRI, typename Epi>
__device__ __forceinline__ void mma_tiled_walk(float* smem, const float* xT, const float* A,
                                               const float* m, const float4* split,
                                               long long N, int K, int D, Epi& epi) {
  const int Dp = mma_dpad(D), H = mma_tiled_depth(D) / 2;
  const int n_rows = (Dp + kMtM - 1) / kMtM;
  const long long n_tiles = (N + kMtP - 1) / kMtP;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane / 4, t = lane % 4;
  // the warp's row group and particle half: warp w runs on SM sub-partition
  // w % 4, so that the row groups a short last row tile leaves idle (rows
  // past Dp) are spread over the four tensor-core units
  const int wr = warp / kMtWP, wp = warp % kMtWP;
  // rows of xT 16-byte aligned: N a multiple of 4 and xT itself aligned
  const bool x16 = N % 4 == 0 && reinterpret_cast<uintptr_t>(xT) % 16 == 0;
  float* red = smem + kMtStages * kMtStageFloats;

  struct Step {
    long long tile;
    int k, rt, p;
  };
  // the block's next step after s; false past its last
  const auto advance = [&](Step& s) {
    if (++s.p < mma_tile_panels(s.rt, D, TRI)) return true;
    s.p = 0;
    if (++s.rt < n_rows) return true;
    s.rt = 0;
    if (++s.k < K) return true;
    s.k = 0;
    s.tile += gridDim.x;
    return s.tile < n_tiles;
  };
  // issue step s's copies into buffer b: the A panel's rows below Dp, the
  // X panel (0 past D and past N) and the m panel (0 past D)
  const auto stage = [&](int b, const Step& s) {
    float* buf = smem + b * kMtStageFloats;
    float4* As = reinterpret_cast<float4*>(buf);
    float* Xs = buf + kMtAFloats;
    float* Ms = Xs + kMtXFloats;
    const int r0 = s.rt * kMtM;
    const float4* src = split + (static_cast<long long>(s.k) * Dp + r0) * H + s.p * (kMtK / 2);
#pragma unroll
    for (int c = 0; c < kMtM * (kMtK / 2) / kMtThreads; ++c) {
      const int e = threadIdx.x + c * kMtThreads, r = e / (kMtK / 2), q = e % (kMtK / 2);
      if (r0 + r < Dp) cp_async_16(As + r * kMtARow4 + q, src + static_cast<long long>(r) * H + q);
    }
    if (x16) {
      // thread t copies particles 4 (t % 32) .. + 3 of rows t / 32 + 8 r (N
      // a multiple of 4: all of them below N or none)
      const long long n = s.tile * kMtP + 4 * (threadIdx.x % (kMtP / 4));
#pragma unroll
      for (int r = 0; r < kMtK * kMtP / 4 / kMtThreads; ++r) {
        const int kk = threadIdx.x / (kMtP / 4) + r * (kMtThreads * 4 / kMtP);
        const int j = s.p * kMtK + kk;
        const bool valid = j < D && n < N;
        cp_async_16(Xs + kk * kMtXStride + 4 * (threadIdx.x % (kMtP / 4)),
                    valid ? xT + static_cast<long long>(j) * N + n : xT, valid);
      }
    } else {
      const int pc = threadIdx.x % kMtP, kk0 = threadIdx.x / kMtP;
      const long long n = s.tile * kMtP + pc;
#pragma unroll
      for (int r = 0; r < kMtK * kMtP / kMtThreads; ++r) {
        const int kk = kk0 + kMtThreads / kMtP * r, j = s.p * kMtK + kk;
        const bool valid = j < D && n < N;
        cp_async_f32(Xs + kk * kMtXStride + pc,
                     valid ? xT + static_cast<long long>(j) * N + n : xT, valid);
      }
    }
    if (threadIdx.x < kMtK) {
      const int j = s.p * kMtK + threadIdx.x;
      cp_async_f32(Ms + threadIdx.x, j < D ? m + static_cast<long long>(s.k) * D + j : m, j < D);
    }
  };

  float big[kMtMT][4][4], small[kMtMT][4][4];
#pragma unroll
  for (int mt = 0; mt < kMtMT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int q = 0; q < 4; ++q) big[mt][nt][q] = small[mt][nt][q] = 0.0f;
    }
  }
  // this lane's particles' sums over the row tiles (row_end's)
  float part[kMtMT / 2];
#pragma unroll
  for (int h = 0; h < kMtMT / 2; ++h) part[h] = 0.0f;

  // the three products of step s (buffer b) on the warp's 16 kMtMT particles
  // x 32 rows
  const auto compute = [&](int b, const Step& s) {
    const float* buf = smem + b * kMtStageFloats;
    const int row0 = s.rt * kMtM + 32 * wr;
    if (row0 >= Dp) return;
    const float4* B = reinterpret_cast<const float4*>(buf) + (32 * wr + g) * kMtARow4 + t;
    const float* X = buf + kMtAFloats + t * kMtXStride + 16 * kMtMT * wp + g;
    const float* M = buf + kMtAFloats + kMtXFloats + t;
#pragma unroll
    for (int st = 0; st < kMtK / 8; ++st) {
      const int j0 = s.p * kMtK + 8 * st;   // the step's first column
      if (j0 >= Dp || (TRI && j0 >= row0 + 32)) break;
      const float m0 = M[8 * st], m1 = M[8 * st + 4];
      uint32_t ah[kMtMT][4], al[kMtMT][4];
#pragma unroll
      for (int mt = 0; mt < kMtMT; ++mt) {
        const float* x = X + 8 * st * kMtXStride + 16 * mt;
        const float v[4] = {x[0] - m0, x[8] - m0, x[4 * kMtXStride] - m1,
                            x[4 * kMtXStride + 8] - m1};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if constexpr (maha_on(kMahaOffSplit)) {
            tf32_split(v[q], ah[mt][q], al[mt][q]);
          } else {
            ah[mt][q] = __float_as_uint(v[q]);
            al[mt][q] = 0u;
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (maha_on(kMahaOffMma) && row0 + 8 * nt < Dp && (!TRI || j0 < row0 + 8 * nt + 8)) {
          const float4 bv = B[nt * 8 * kMtARow4 + 4 * st];
          const uint32_t bh0 = __float_as_uint(bv.x), bh1 = __float_as_uint(bv.y);
          const uint32_t bl0 = __float_as_uint(bv.z), bl1 = __float_as_uint(bv.w);
#pragma unroll
          for (int mt = 0; mt < kMtMT; ++mt) {
            mma_tf32(big[mt][nt], ah[mt], bh0, bh1);
            if constexpr (maha_on(kMahaOffSmall)) {
              mma_tf32(small[mt][nt], ah[mt], bl0, bl1);
              mma_tf32(small[mt][nt], al[mt], bh0, bh1);
            }
          }
        }
      }
    }
  };

  // a row tile's end: the squares of y = big + small, joined over the row
  // group's four lanes by a reduce-scatter (shfl_xor 2, then 1: lane t keeps
  // the kMtMT / 2 values of index q = b1 kMtMT + b0 kMtMT / 2 + j, t = 2 b1 +
  // b0, of particle 16 (q / 2) + 8 (q % 2) + g of the warp's), into part;
  // the accumulators back to 0
  const auto row_end = [&]() {
    float v[2 * kMtMT];   // v[2 mt + h]: this thread's squares of particle 16 mt + 8 h + g
#pragma unroll
    for (int mt = 0; mt < kMtMT; ++mt) {
      mma_squares(big[mt], small[mt], v[2 * mt], v[2 * mt + 1]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int q = 0; q < 4; ++q) big[mt][nt][q] = small[mt][nt][q] = 0.0f;
      }
    }
    const unsigned all = 0xffffffffu;
    const bool b1 = t & 2, b0 = t & 1;
    constexpr int H = kMtMT / 2;
    float w[kMtMT];   // w[i]: index b1 kMtMT + i
#pragma unroll
    for (int i = 0; i < kMtMT; ++i)
      w[i] = (b1 ? v[kMtMT + i] : v[i]) + __shfl_xor_sync(all, b1 ? v[i] : v[kMtMT + i], 2);
#pragma unroll
    for (int j = 0; j < H; ++j)
      part[j] += (b0 ? w[H + j] : w[j]) + __shfl_xor_sync(all, b0 ? w[j] : w[H + j], 1);
  };

  // a component's end: the row groups' partials summed in order, particle
  // p of the tile by thread p, one coalesced store
  const auto k_end = [&](const Step& s) {
#pragma unroll
    for (int j = 0; j < kMtMT / 2; ++j) {
      const int q = (t >> 1) * kMtMT + (t & 1) * (kMtMT / 2) + j;
      red[wr * kMtP + 16 * kMtMT * wp + 16 * (q / 2) + 8 * (q % 2) + g] = part[j];
      part[j] = 0.0f;
    }
    __syncthreads();
    if (threadIdx.x < kMtP) {
      const int pc = threadIdx.x;
      float value = ((red[pc] + red[kMtP + pc]) + red[2 * kMtP + pc]) + red[3 * kMtP + pc];
      const long long n = s.tile * kMtP + pc, k = s.k;
      if (n < N && !isfinite(value)) value = maha_fp32(A + k * D * D, m + k * D, xT, N, D, n);
      epi(s.k, n, value);
    }
    // the partials are written again only after a later step's barrier
  };

  Step cur{blockIdx.x, 0, 0, 0};
  if (cur.tile >= n_tiles) return;
  Step ld = cur;   // the next step to stage
  bool staging = true;
  int staged = 0;  // steps staged (kMahaOffCopies: the first kMtStages - 1 only)
#pragma unroll 1
  for (int b = 0; b < kMtStages - 1; ++b) {
    if (staging) {
      stage(b, ld);
      staging = advance(ld);
      ++staged;
    }
    cp_async_commit();
  }
#pragma unroll 1
  for (int b = 0;; b = b + 1 == kMtStages ? 0 : b + 1) {
    cp_async_wait<kMtStages - 2>();   // this thread's copies of step cur have landed
    __syncthreads();                  // and every thread's; buffer b - 1 is free
    if (staging) {
      if (maha_on(kMahaOffCopies) || staged < kMtStages - 1)
        stage(b == 0 ? kMtStages - 1 : b - 1, ld);
      staging = advance(ld);
      ++staged;
    }
    cp_async_commit();
    compute(b, cur);
    if (cur.p + 1 == mma_tile_panels(cur.rt, D, TRI)) {
      row_end();
      if (cur.rt + 1 == n_rows) k_end(cur);
    }
    if (!advance(cur)) break;
  }
  cp_async_wait<0>();
}

// fused_maha's epilogue: out[k, n]
struct MahaStore {
  float* out;
  long long N;
  __device__ void operator()(int k, long long n, float value) const {
    if (n < N) out[k * N + n] = value;
  }
};

// fused_maha's tensor-core loop past D = 64 (maha_mma_tiled_kernel): xT (D,
// N), A (K, D, D), m (K, D), split: mma_split_kernel<false>'s output for A;
// smem: kMmaTiledSmem bytes, 16-byte aligned.
__device__ __forceinline__ void mma_tiled_maha(float* smem, const float* xT, const float* A,
                                               const float* m, const float4* split, float* out,
                                               long long N, int K, int D) {
  MahaStore store{out, N};
  mma_tiled_walk<false>(smem, xT, A, m, split, N, K, D, store);
}

}  // namespace pmc
