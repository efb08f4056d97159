// The Gram statistics pass: the statistics of stats.cuh for fused_pmc_stats
// (pmc_stats.cu), fused_is_pmc_step (is_pmc_step.cu) and fused_vb_estep
// (vb_estep.cu) from D = 17 (past the register pass of reg_stats.cuh) to 128
// where K D <= 128, the JAX rule's reach for these three kernels (K D <= 128,
// from 1024 particles).  One kernel in three modes (DenseMode): the
// statistics, the step's (w formed from its draw's log q and log p) and VB's.
//
// Bound on the H100: FP32 FMAs.  A particle takes K D (D + 1) / 2 FMAs of
// whitening and as many of the product statistics against D + 1 floats
// read (the step: D + 2 written by its draw, D + 3 read here): at K = 1, D =
// 128 ~16,500 FMAs for ~520 bytes, 60x the card's FP32 balance.  The entry
// table it replaces past D = 16 whitened a particle a thread (x and its
// differences in 256 floats of local memory at DMAX 128) and summed each of
// the K (3 + D + D (D + 1) / 2) entries as a * b * c over a tile with three
// 4-byte shared loads an FMA; at K = 1, D = 128 it ran at 2% of its bound.
// VB's work is the same: its projection A_k (x - m_k) in place of the
// whitening, a plain softmax in place of the mixture's log-pdfs.
//
// Design.  A block of kGramThreads (256) walks tiles of kGramP (64)
// particles, grid-stride, one wave of the blocks the occupancy API fits,
// and keeps for its whole life U_k of every component stacked and
// transposed in shared memory (Ut[j][k Dp + i] = U_k[i][j], zero above the
// diagonal and past D; Dp = D rounded up to 8, so that an 8-row group lies
// in one component) with the K means.  A tile's particles (xT's columns)
// are copied by cp.async, the next tile's while this one's statistics are
// formed.  Per tile:
//   A. whitening: the product Delta = U (x - mu_k) of the K Dp stacked rows
//      and the 64 particles on register micro-tiles of 8 rows (one
//      component) x 4 particles (pg + 16 q, so that the stores hit distinct
//      banks; staged side by side), 3 LDS.128 and one LDS of mu_k feeding
//      32 FMAs a depth, a scheduler's two warps paired shallow with deep
//      where the row groups fill the block; a row group stops at
//      its last row's depth and takes its diagonal 8 x 8 block as a
//      triangle, so no FMA multiplies an entry above U's diagonal (a
//      non-finite x_j reaches Delta_i only for i >= j, as whiten's); x -
//      mu_k is formed as x is read (no U mu cancellation).  Delta goes to
//      shared memory, particle-major, rows past D set to 0.
//   B. per particle, four threads a particle: maha_k = |Delta_k|^2 (from
//      K = 4 summed by thread k % 4; below, each thread a quarter of the
//      rows, joined by two xor shuffles); component k's log-pdf, rho_k
//      (exactly 0 for a dead component), gamma, c = w rho gamma and t1 (the
//      entry table's bracket) on thread k % 4, so that the transcendentals
//      of four components share an instruction; log q by the weighted
//      log-sum-exp, k ascending, on all four (the K log-pdfs gathered by
//      shuffles); the step forms w = exp(log p - log q) from its draw's log
//      q and log p and writes it.  VB: log rho_k = c_k - maha_k / 2, the
//      plain log-sum-exp of them, r_k = exp(log rho_k - lse), w r_k as both
//      w rho_k and c_k (gamma 1) and t1_k = w r_k (log rho_k - lse), the log
//      taken as it stands (an underflowed r_k gives 0, not 0 x -inf): one
//      exp a (particle, component) pair besides the log-sum-exp's.  Rows of
//      w rho_k, c_k, t1_k, w, w^2, w log w to shared memory.
//   C. the product statistics as a weighted SYRK: each thread owns one 8 x 8
//      block (k, bi >= bj) of component k's lower triangle of g_k = Delta_k
//      diag(c_k) Delta_k^T, and of the S column slices of the tile
//      (columns s, s + S, ...; S the largest power of two, to 32, with S x
//      the blocks <= 256, the S slices of a block in adjacent lanes) one;
//      per column it reads c and its 16 Delta values by 5 loads (4 LDS.128)
//      for 8 FMULs and 64 FMAs, the diagonal blocks sd_k = Delta_k c_k
//      besides.  The S slices' sums are joined by a reduce-scatter of xor
//      shuffles in a fixed order, each lane left with 72 / S of them (9
//      past 8 slices) to add into the accumulators.  Threads 3K + 3 sum the tile's scalar rows
//      (s0, s0c, t1, sum w, sum w^2, sum w log w), four interleaved partial
//      sums each.
// VB's operands are A (K, D, D) | m (K, D) | c (K) (vb_estep.cu), A_k upper
// triangular: Delta_i = sum_{j >= i} A_ij (x_j - m_j).  The pass reverses
// the coordinates as it stages them (A'_k = J A_k J, lower triangular, into
// Ut; m'_j = m_{D-1-j}; xT's row D - 1 - j into the tile's row j), so that
// phase A runs as for U, reads no entry of A below its diagonal and a
// non-finite x_j reaches Delta_i only for i <= j; the block's row is written
// with sd's and g's entries reversed back (g_ij from the reversed Gram's
// entry (D-1-j, D-1-i), its lower triangle).
// Each tile's sums are float32 over its 64 columns, added into float64
// accumulators of the block in shared memory, one thread an entry, laid out
// block-minor (entry (r, q) of all the 8 x 8 blocks together), so that a
// warp's additions hit consecutive words (in the flat entry order a block's
// row sits 8 words from its neighbour's).  At its end each block writes its
// row of (n_blocks, E) in the flat entry order of the entry table
// (StatsLayout) and reduce_partials sums the rows in block order.  No float
// atomics: one input gives one output.
//
// Where two blocks' shared memory fits an SM (kHalfSmem: K = 1 to D = 82, 2
// to 56, 3 to 40, every K D <= 128 from 4 on) the instantiation capped at
// 128 registers (MINB 2) runs two blocks an SM, so that one block's
// barriers and latency overlap the other's work (at K = 7, D = 17, 2^20
// particles on one H100, 2.55 -> 1.19 ms with the slices' shuffles);
// elsewhere one.
#pragma once

#include "stats.cuh"

namespace pmc {

// gram_phases.py builds the pass with parts of it left out, to time them
// (its statistics then wrong): PMC_GRAM_OFF, a mask of GramOff bits, is 0
// in every other build
#ifndef PMC_GRAM_OFF
#define PMC_GRAM_OFF 0
#endif
enum GramOff : int {
  kGramOffX = 1,       // the particle tile's copies
  kGramOffA = 2,       // A. the whitening
  kGramOffB = 4,       // B. the per-particle phase
  kGramOffS = 8,       // the scalar sums
  kGramOffC = 16,      // C. the weighted SYRK
  kGramOffF = 32,      // the slices' join and the float64 flush
  kGramOffPair = 64,   // A's pairing of warps on a scheduler
};
__host__ __device__ constexpr bool gram_on(int part) { return (PMC_GRAM_OFF & part) == 0; }

constexpr int kGramP = 64;          // particles a tile
constexpr int kGramThreads = 256;   // four a particle in phase B
constexpr int kGramDMin = 17;       // the register pass to 16 (reg_stats.cuh kRegDMax)
constexpr int kGramKD = 128;        // the JAX rule's K D bound
constexpr int kGramKMax = kGramKD / kGramDMin;   // 7 components at most
static_assert(kGramThreads == 4 * kGramP, "phase B: four threads a particle");
static_assert(kGramThreads == 16 * (kGramP / 4), "phase A: 16 particle groups of 4 a row group");

__host__ __device__ inline int pad8(int n) { return (n + 7) / 8 * 8; }

// The pass's shared memory for (K, D) (ops/_build.py gram_layout mirrors
// it), float offsets: Ut (D x R, R = K Dp) | mu (R) | the particle tile (D x
// kGramP) | Delta (kGramP x dstride) | the per-particle rows ((3 K + 3) x
// kGramP) | the float64 accumulators: g, 64 x the 8 x 8 blocks (entry (r, q)
// of block b at (8 r + q) blocks + b), sd, 8 x the blocks (row r of a
// diagonal block), the 3 K + 3 scalars in the per-particle rows' order
struct GramLayout {
  int K, D;
  __host__ __device__ int Dp() const { return pad8(D); }
  __host__ __device__ int R() const { return K * Dp(); }
  __host__ __device__ int nb() const { return Dp() / 8; }
  // phase C's blocks: the lower 8 x 8 blocks of the K triangles
  __host__ __device__ int blocks() const { return K * nb() * (nb() + 1) / 2; }
  __host__ __device__ int slices() const {
    int s = 1;
    while (2 * s <= 32 && 2 * s * blocks() <= kGramThreads) s *= 2;
    return s;
  }
  // Delta's row stride: 4 (mod 32) floats, so that the 16-byte stores of a
  // quarter warp, 8 particles apart by one, hit distinct banks
  __host__ __device__ int dstride() const { return (R() + 31) / 32 * 32 + 4; }
  __host__ __device__ int PC() const { return StatsLayout{1, D}.per_component(); }
  __host__ __device__ int E() const { return K * PC() + 3; }
  __host__ __device__ size_t mu() const { return static_cast<size_t>(D) * R(); }
  __host__ __device__ size_t x() const { return mu() + R(); }
  __host__ __device__ size_t delta() const { return x() + static_cast<size_t>(D) * kGramP; }
  __host__ __device__ size_t rows() const {
    return delta() + static_cast<size_t>(kGramP) * dstride();
  }
  __host__ __device__ size_t acc_bytes() const {
    return ((rows() + static_cast<size_t>(3 * K + 3) * kGramP) * sizeof(float) + 7) / 8 * 8;
  }
  __host__ __device__ int acc_doubles() const { return 72 * blocks() + 3 * K + 3; }
  __host__ __device__ size_t smem() const { return acc_bytes() + acc_doubles() * sizeof(double); }
};

// whether the Gram pass takes (K, D): the JAX rule's reach past the
// register pass, where its shared memory fits (everywhere there: 212,528 B
// at K = 1, D = 128 the most)
inline bool gram_fits(int K, int D) {
  return K >= 1 && D >= kGramDMin && D <= kDMax && K * D <= kGramKD &&
         GramLayout{K, D}.smem() <= kSmemLimit;
}

// A round of phase C's reduce-scatter between lanes o apart: the lane whose
// bit o is set keeps values [H, 2H) of v[0, 2H), the other [0, H), each adds
// its partner's copy of the half it keeps, into v[0, H); base and len follow
// the kept values (H a constant, so that v stays in registers).
template <int H>
__device__ __forceinline__ void scatter_round(float (&v)[72], int o, int& base, int& len) {
  const bool upper = (threadIdx.x & o) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float keep = upper ? v[i + H] : v[i];
    const float send = upper ? v[i] : v[i + H];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
  }
  base += upper ? H : 0;
  len = H;
}

// the blocks an SM the pass's instantiation for (K, D) is built for: two
// where two blocks' shared memory fits an SM
inline int gram_min_blocks(int K, int D) {
  return GramLayout{K, D}.smem() <= kHalfSmem ? 2 : 1;
}

// the dense statistics kernels' modes, of the Gram pass and of reg_stats.cuh's
// register kernel (pmc_dense_plan's codes): the step draws its particles and
// evaluates the target; VB loads weighted particles and projects them on its
// operands; the statistics mode loads weighted particles and evaluates them
// as the step does
enum DenseMode : int { kDenseStep = 0, kDenseVb = 1, kDenseStats = 2 };

// One block of the pass.  MODE kDenseStep (fused_is_pmc_step): w = exp(log_p
// - log_q) from the draw's outputs, written to wts; kDenseStats
// (fused_pmc_stats): w read from wts, mix the packed proposal (MixLayout);
// kDenseVb (fused_vb_estep): w read from wts, mix VB's operands, the
// coordinates reversed.  MINB: the blocks an SM it is built for
// (gram_min_blocks).
template <int MODE, int MINB>
__global__ void __launch_bounds__(kGramThreads, MINB)
gram_stats_kernel(const float* __restrict__ xT, float* __restrict__ wts,
                  const float* __restrict__ log_q, const float* __restrict__ log_p,
                  const float* __restrict__ mix, double* __restrict__ partial, long long N,
                  int K, int D, int student_t, int dof_stats) {
  constexpr bool STEP = MODE == kDenseStep, VB = MODE == kDenseVb;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const GramLayout G{K, D};
  const MixLayout L{K, D};
  // VB: A (K, D, D) | m (K, D) | c (K)
  const float* vb_m = mix + static_cast<long long>(K) * D * D;
  const int Dp = G.Dp(), R = G.R(), nb = G.nb(), ds = G.dstride(), PC = G.PC(), E = G.E();
  float* Ut = smem;
  float* Ms = smem + G.mu();
  float* Xs = smem + G.x();
  float* Dt = smem + G.delta();
  float* rows = smem + G.rows();
  double* accG = reinterpret_cast<double*>(reinterpret_cast<char*>(smem) + G.acc_bytes());
  const int n_blocks_c = G.blocks(), S = G.slices();
  double* accSD = accG + 64 * n_blocks_c;
  double* accS = accSD + 8 * n_blocks_c;
  const int t = threadIdx.x;
  const bool st = student_t != 0;

  // U_k's lower triangle (VB: A'_k = J A_k J's, A_k's upper triangle) and
  // the means (VB: m reversed)
  for (int idx = t; idx < D * R; idx += kGramThreads) {
    const int j = idx / R, r = idx - j * R, k = r / Dp, i = r - k * Dp;
    float u = 0.0f;
    if (i < D && j <= i) {
      if constexpr (VB) {
        u = __ldg(mix + (static_cast<long long>(k) * D + D - 1 - i) * D + D - 1 - j);
      } else {
        u = __ldg(mix + L.U() + (static_cast<long long>(k) * D + i) * D + j);
      }
    }
    Ut[idx] = u;
  }
  for (int r = t; r < R; r += kGramThreads) {
    const int k = r / Dp, j = r - k * Dp;
    Ms[r] = j < D ? __ldg(VB ? vb_m + k * D + D - 1 - j : mix + L.mu() + k * D + j) : 0.0f;
  }
  for (int e = t; e < G.acc_doubles(); e += kGramThreads) accG[e] = 0.0;

  const long long n_tiles = (N + kGramP - 1) / kGramP;
  // the tile's particles, zero past N; particle pg + 16 q at column 4 pg +
  // q, so that phase A reads a thread's four particles by one LDS.128 (VB:
  // xT's row D - 1 - j into row j)
  const auto stage = [&](long long tile) {
    const long long n0 = tile * kGramP;
    for (int idx = t; idx < D * kGramP; idx += kGramThreads) {
      const int j = idx / kGramP, p = idx % kGramP;
      const bool valid = n0 + p < N;
      const int row = VB ? D - 1 - j : j;
      cp_async_f32(Xs + j * kGramP + 4 * (p % 16) + p / 16,
                   valid ? xT + static_cast<long long>(row) * N + n0 + p : xT, valid);
    }
    cp_async_commit();
  };
  if (gram_on(kGramOffX) && blockIdx.x < n_tiles) stage(blockIdx.x);

  // phase C's block and slice of this thread (none where t >= blocks x
  // slices): the S slices of a block in adjacent lanes
  const bool owner = t < n_blocks_c * S;
  const int slice = t % S;
  int ck = 0, bi = 0, bj = 0, item = 0;
  if (owner) {
    const int tri = nb * (nb + 1) / 2;
    item = t / S;
    ck = item / tri;
    int lin = item - ck * tri;
    while ((bi + 1) * (bi + 2) / 2 <= lin) ++bi;
    bj = lin - bi * (bi + 1) / 2;
  }
  const int n_groups_a = (R / 8) * (kGramP / 4);

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    cp_async_wait<0>();
    __syncthreads();   // the tile's particles are in; the last tile's reads are done

    // A. Delta = U (x - mu_k), a row group of 8 rows x 4 particles at a time,
    // the shallowest first; in the first 256, warp w + 4 (on warp w's
    // scheduler) takes the items of warp 7 - w, so that a scheduler's two
    // warps sum to about the same depth
    for (int it = t; gram_on(kGramOffA) && it < n_groups_a; it += kGramThreads) {
      const int w = it >> 5;
      const int jt = gram_on(kGramOffPair) && it < kGramThreads &&
                             n_groups_a >= kGramThreads && w >= 4
                         ? ((11 - w) << 5) | (it & 31)
                         : it;
      const int i_rg = jt >> 4, pg = jt & 15;
      const int b = i_rg / K, k = i_rg % K, rg = k * nb + b;
      const float* ucol = Ut + rg * 8;
      const float* mk = Ms + k * Dp;
      const float* xs = Xs + 4 * pg;
      float a[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) a[r][q] = 0.0f;
      }
      const int j_full = min(D, 8 * b);   // depths below the row group's first row
      const auto depth = [&](int j) {
        const float4 u0 = *reinterpret_cast<const float4*>(ucol + j * R);
        const float4 u1 = *reinterpret_cast<const float4*>(ucol + j * R + 4);
        const float m = mk[j];
        const float u[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
        const float4 xv = *reinterpret_cast<const float4*>(xs + j * kGramP);
        const float xc[4] = {xv.x - m, xv.y - m, xv.z - m, xv.w - m};
#pragma unroll
        for (int r = 0; r < 8; ++r) {
#pragma unroll
          for (int q = 0; q < 4; ++q) a[r][q] = fmaf(u[r], xc[q], a[r][q]);
        }
      };
      // the instantiation capped at 128 registers keeps fewer depths in
      // flight (4 spilled it)
      if constexpr (MINB == 2) {
#pragma unroll 2
        for (int j = 0; j < j_full; ++j) depth(j);
      } else {
#pragma unroll 4
        for (int j = 0; j < j_full; ++j) depth(j);
      }
      // the diagonal block: row 8 b + r takes depths 8 b .. 8 b + r
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * b + jj;
        if (j < D) {
          const float4 u0 = *reinterpret_cast<const float4*>(ucol + j * R);
          const float4 u1 = *reinterpret_cast<const float4*>(ucol + j * R + 4);
          const float m = mk[j];
          const float u[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
          const float4 xv = *reinterpret_cast<const float4*>(xs + j * kGramP);
          const float xc[4] = {xv.x - m, xv.y - m, xv.z - m, xv.w - m};
#pragma unroll
          for (int r = jj; r < 8; ++r) {
#pragma unroll
            for (int q = 0; q < 4; ++q) a[r][q] = fmaf(u[r], xc[q], a[r][q]);
          }
        }
      }
      // rows past D are 0, not 0 x a non-finite x
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float v[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) v[r] = 8 * b + r < D ? a[r][q] : 0.0f;
        float* out = Dt + (pg + 16 * q) * ds + rg * 8;
        *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(out + 4) = make_float4(v[4], v[5], v[6], v[7]);
      }
    }
    __syncthreads();   // Delta is in; the particle tile is free
    if (gram_on(kGramOffX) && tile + gridDim.x < n_tiles) stage(tile + gridDim.x);

    // B. per particle, four threads a particle: maha_k of every component
    // (from K = 4 on thread k % 4, below each thread a quarter of the rows,
    // joined), then component k's density, responsibility and rows on
    // thread k % 4, log q over all K on every thread, k ascending
    if (gram_on(kGramOffB)) {
      constexpr int kM = (kGramKMax + 3) / 4;   // components a thread
      const int p = t >> 2, part = t & 3, quad = t & 28;   // quad: lane of part 0
      const long long n = tile * kGramP + p;
      const float* drow = Dt + p * ds;
      float maha[kM] = {}, ind[kM] = {};
      if (K >= 4) {
        // thread k % 4 sums component k's rows itself
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          const int k = 4 * m + part;
          if (k < K) {
            float s = 0.0f;
            for (int c4 = 0; c4 < Dp / 4; ++c4) {
              const float4 v = *reinterpret_cast<const float4*>(drow + k * Dp + 4 * c4);
              s = fmaf(v.x, v.x, s);
              s = fmaf(v.y, v.y, s);
              s = fmaf(v.z, v.z, s);
              s = fmaf(v.w, v.w, s);
            }
            maha[m] = s;
          }
        }
      } else {
        // each of the four a quarter of the rows of every component, joined
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          if (k < K) {
            float s = 0.0f;
            for (int c4 = part; c4 < Dp / 4; c4 += 4) {
              const float4 v = *reinterpret_cast<const float4*>(drow + k * Dp + 4 * c4);
              s = fmaf(v.x, v.x, s);
              s = fmaf(v.y, v.y, s);
              s = fmaf(v.z, v.z, s);
              s = fmaf(v.w, v.w, s);
            }
            // a + b == b + a: the four threads of the particle agree
            s += __shfl_xor_sync(0xffffffffu, s, 1);
            s += __shfl_xor_sync(0xffffffffu, s, 2);
            if (k == part) maha[0] = s;
          }
        }
      }
      // the component log-pdfs (VB: log rho_k)
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        const int k = 4 * m + part;
        if (k < K) {
          if constexpr (VB) {
            ind[m] = __ldg(vb_m + K * D + k) - 0.5f * maha[m];
          } else {
            ind[m] = component_logpdf(maha[m], __ldg(mix + L.ln() + k),
                                      __ldg(mix + L.dof() + k), D, st);
          }
        }
      }
      WeightedLse lse;
#pragma unroll
      for (int k = 0; k < kGramKMax; ++k) {
        if (k < K)
          lse.add(__shfl_sync(0xffffffffu, ind[k >> 2], quad | (k & 3)),
                  VB ? 1.0f : __ldg(mix + L.w() + k));
      }
      float w = 0.0f;   // 0 past N
      if (n < N) {
        if constexpr (STEP) {
          w = expf(__ldg(log_p + n) - __ldg(log_q + n));
          if (part == 0) wts[n] = w;
        } else {
          w = __ldg(wts + n);
        }
      }
      const float lq = lse.value();
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        const int k = 4 * m + part;
        if (k < K) {
          if constexpr (VB) {
            // r_k, and its log as it stands
            const float log_r = ind[m] - lq;
            const float wr = w * expf(log_r);
            rows[k * kGramP + p] = wr;
            rows[(K + k) * kGramP + p] = wr;
            rows[(2 * K + k) * kGramP + p] = wr * log_r;
          } else {
            const float wk = __ldg(mix + L.w() + k);
            const float rho = wk > 0.0f ? expf(ind[m] - lq) * wk : 0.0f;
            const float wrho = rho * w;
            float gamma = 1.0f, t1 = 0.0f;
            if (st) {
              const float nu = __ldg(mix + L.dof() + k);
              gamma = (nu + static_cast<float>(D)) / (nu + maha[m]);
              if (dof_stats)
                t1 = wrho * (logf(0.5f * (maha[m] + nu)) - __ldg(mix + L.psi() + k) + gamma);
            }
            rows[k * kGramP + p] = wrho;
            rows[(K + k) * kGramP + p] = wrho * gamma;
            rows[(2 * K + k) * kGramP + p] = t1;
          }
        }
      }
      if (part == 0) {
        rows[3 * K * kGramP + p] = w;
        rows[(3 * K + 1) * kGramP + p] = w * w;
        rows[(3 * K + 2) * kGramP + p] = w > 0.0f ? w * logf(w) : 0.0f;
      }
    }
    __syncthreads();

    // C. the scalar sums of the tile, one thread a row: four interleaved
    // partial sums, then joined in a fixed order
    if (gram_on(kGramOffS) && t < 3 * K + 3) {
      const float* row = rows + t * kGramP;
      float s4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
      for (int p = 0; p < kGramP; p += 4) {
        const float4 v = *reinterpret_cast<const float4*>(row + p);
        s4[0] += v.x;
        s4[1] += v.y;
        s4[2] += v.z;
        s4[3] += v.w;
      }
      accS[t] += static_cast<double>((s4[0] + s4[1]) + (s4[2] + s4[3]));
    }
    // ... and the weighted SYRK on this thread's block and slice
    float g[8][8], sd[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      sd[r] = 0.0f;
#pragma unroll
      for (int q = 0; q < 8; ++q) g[r][q] = 0.0f;
    }
    if (gram_on(kGramOffC) && owner) {
      const float* crow = rows + (K + ck) * kGramP;
      const float* di = Dt + ck * Dp + 8 * bi;
      const float* dj = Dt + ck * Dp + 8 * bj;
      const auto column = [&](int p) {
        const float c = crow[p];
        const float4 i0 = *reinterpret_cast<const float4*>(di + p * ds);
        const float4 i1 = *reinterpret_cast<const float4*>(di + p * ds + 4);
        const float4 j0 = *reinterpret_cast<const float4*>(dj + p * ds);
        const float4 j1 = *reinterpret_cast<const float4*>(dj + p * ds + 4);
        const float av[8] = {c * i0.x, c * i0.y, c * i0.z, c * i0.w,
                             c * i1.x, c * i1.y, c * i1.z, c * i1.w};
        const float bv[8] = {j0.x, j0.y, j0.z, j0.w, j1.x, j1.y, j1.z, j1.w};
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          sd[r] += av[r];
#pragma unroll
          for (int q = 0; q < 8; ++q) g[r][q] = fmaf(av[r], bv[q], g[r][q]);
        }
      };
      // one column's loads in flight under the 128-register cap, two else
      if constexpr (MINB == 2) {
#pragma unroll 1
        for (int p = slice; p < kGramP; p += S) column(p);
      } else {
#pragma unroll 2
        for (int p = slice; p < kGramP; p += S) column(p);
      }
    }
    // the S slices' sums joined by a reduce-scatter of xor shuffles: each
    // round a lane keeps half of its values (72 = 64 of g, then 8 of sd)
    // and adds its partner's copy of them, to 9 values; past 8 slices the 9
    // are summed across the remaining lanes.  A fixed order, (s0 + s1) +
    // (s2 + s3) ..., the non-owners of the last warp adding their zeros.
    float v[72];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      v[64 + r] = sd[r];
#pragma unroll
      for (int q = 0; q < 8; ++q) v[8 * r + q] = g[r][q];
    }
    int base = 0, len = 72;
    constexpr bool join = gram_on(kGramOffF);
    if (join && S > 1) scatter_round<36>(v, 1, base, len);
    if (join && S > 2) scatter_round<18>(v, 2, base, len);
    if (join && S > 4) scatter_round<9>(v, 4, base, len);
    for (int o = 8; join && o < S; o *= 2) {
#pragma unroll
      for (int i = 0; i < 9; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
    }
    // ... into the block's accumulators (entries above the diagonal and past
    // D are never read), each lane its len values
    if (join && owner && (slice & ~7) == 0) {
#pragma unroll
      for (int i = 0; i < 72; ++i) {
        if (i < len) {
          const int e = base + i;
          if (e < 64) accG[e * n_blocks_c + item] += static_cast<double>(v[i]);
          else if (bi == bj) accSD[(e - 64) * n_blocks_c + item] += static_cast<double>(v[i]);
        }
      }
    }
  }
  __syncthreads();   // every thread's sums are in
  // the block's row in the flat entry order: per component s0, s0c, t1, sd,
  // g's lower triangle by row; then sum w, sum w^2, sum w log w
  const int tri = nb * (nb + 1) / 2;
  for (int e = t; e < E; e += kGramThreads) {
    double v;
    if (e >= K * PC) {
      v = accS[3 * K + e - K * PC];
    } else {
      const int k = e / PC, r = e - k * PC;
      if (r < 3) {
        v = accS[r * K + k];
      } else if (r < 3 + D) {
        const int i = VB ? D - 1 - (r - 3) : r - 3, b = i / 8;
        v = accSD[(i % 8) * n_blocks_c + k * tri + b * (b + 1) / 2 + b];
      } else {
        const int q = r - 3 - D;
        int i = static_cast<int>((sqrtf(8.0f * q + 1.0f) - 1.0f) * 0.5f);
        while (i * (i + 1) / 2 > q) --i;
        while ((i + 1) * (i + 2) / 2 <= q) ++i;
        int j = q - i * (i + 1) / 2;
        if constexpr (VB) {
          // g_ij of the reversed coordinates: entry (D-1-j, D-1-i), lower
          const int i0 = i;
          i = D - 1 - j;
          j = D - 1 - i0;
        }
        const int b0 = i / 8, b1 = j / 8;
        v = accG[(8 * (i % 8) + j % 8) * n_blocks_c + k * tri + b0 * (b0 + 1) / 2 + b1];
      }
    }
    partial[static_cast<long long>(blockIdx.x) * E + e] = v;
  }
}

// the pass's instantiation in MODE (DenseMode) for (K, D)
template <int MODE>
inline auto gram_kernel_for(int K, int D) {
  return gram_min_blocks(K, D) == 2 ? &gram_stats_kernel<MODE, 2> : &gram_stats_kernel<MODE, 1>;
}

// blocks of the pass in MODE that fit on one SM at once at (K, D); -1 on an
// error
template <int MODE>
inline int gram_per_sm(int K, int D) {
  const auto kernel = gram_kernel_for<MODE>(K, D);
  const size_t smem = GramLayout{K, D}.smem();
  int n = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kGramThreads, smem) !=
          cudaSuccess)
    return -1;
  return n;
}

// The pass in MODE on stream s, n_blocks blocks, then the reduction of their
// partials (n_blocks x E float64 scratch) into stats (E of T: float, or
// VB's double).  An error where gram_fits is false.
template <int MODE, typename T>
inline int launch_gram(const float* xT, float* w, const float* log_q, const float* log_p,
                       const float* mix, double* partial, T* stats, long long N, int K,
                       int D, int student_t, int dof_stats, int n_blocks, cudaStream_t s) {
  if (!gram_fits(K, D) || n_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const GramLayout G{K, D};
  const auto kernel = gram_kernel_for<MODE>(K, D);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(G.smem()));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_blocks, kGramThreads, G.smem(), s>>>(xT, w, log_q, log_p, mix, partial, N, K, D,
                                                  student_t, dof_stats);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  launch_reduce(partial, stats, n_blocks, G.E(), s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pmc
