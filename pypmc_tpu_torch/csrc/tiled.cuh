// The block-tiled FP32 product engine of fused_maha's and fused_logq's
// kernels past the record kernels (maha.cu maha_tiled_kernel, logq.cu
// logq_tiled_kernel; ops/_build.py tiled_plan mirrors the constants).
//
// Both functions are products in disguise: for component k and a tile of P
// particles, Y_k = A_k (X - m_k) is a (D x D) (D x P) product, and each wants
// the column sums of Y_k * Y_k (fused_logq's A_k = U_k lower triangular,
// then the component's log-density in a running weighted log-sum-exp).
//
// Bound on the H100: FP32 FMAs, D^2 a (particle, component) for a general
// A_k, D (D + 1) / 2 for a triangular U_k, against D + K (or D + 1) floats
// of a particle moved; no tensor cores, since TF32 keeps ~3 digits and the
// products here are held to float32 tolerances.
//
// Design.  A block of kTileThreads (256) takes a tile of kTileP (128)
// particles and walks the components k ascending; for each k the row tiles
// of kTileM (128) rows of A_k, and for each row tile the depth panels of
// kTileK (16) columns, with a triangular A_k only the panels at or left of
// the tile's last row.  A step is one (k, row tile, panel): its A panel,
// transposed (the rows of A_k on the fast axis, rows kTileStride floats
// apart), and its X panel (kTileK rows of xT, kTileP particles) are copied
// to shared memory by cp.async into one of two buffers, the next step's
// copy in flight while this one is used, so the pipeline runs on across
// row tiles, components and particle tiles.  The step's m_k panel is copied
// beside them, and x - m_k is formed as each X word is read into registers,
// never stored in device memory.  Each thread
// holds an 8 x 8 register micro-tile of Y_k (rows ty*4 + {0..3} and 64 +
// ty*4 + {0..3}, particles tx*4 + {0..3} and 64 + tx*4 + {0..3}), read by
// LDS.128 from both panels: 4 loads feed 64 FMAs, where the warp kernels
// (warp.cuh) gave each word read from L2 one FMA.  Each accumulator is one
// row's dot product with j ascending, the FMA order of whiten and project.
// At a row tile's end a thread adds its rows' squares into its 8
// per-particle partials, which it keeps in its own words of shared memory
// (in registers they spilled the triangular kernel at 128); at a
// component's end thread p sums column p of the 16 threads that share
// particle p, ty ascending: a fixed order with no atomics, so one input
// gives one output.  The ragged edges are masked: A past D (and above a
// triangular U's diagonal) and xT past D or N are copied as zeros, and a
// particle past N is computed and never handed on.
#pragma once

#include "common.cuh"

namespace pmc {

constexpr int kTileP = 128;        // particles a block tile
constexpr int kTileM = 128;        // rows of A_k a row tile
constexpr int kTileK = 16;         // depth of a panel
constexpr int kTileThreads = 256;  // 16 (rows) x 16 (particles) threads, 8 x 8 each
constexpr int kTileStride = kTileM + 4;   // an A panel's row stride: staging hits distinct banks
constexpr int kTileAFloats = kTileK * kTileStride;
constexpr int kTileXFloats = kTileK * kTileP;
constexpr int kTileRedFloats = 16 * kTileP;   // the partials of a component, 16 threads a column
// shared memory of a tiled block: two A panels, two X panels, two m panels,
// the partials
constexpr size_t kTiledSmem =
    sizeof(float) * (2 * kTileAFloats + 2 * kTileXFloats + 2 * kTileK + kTileRedFloats);
// the smallest D at which fused_maha and fused_logq take the tiled kernel
// (ops/_build.py TILED_D_MIN): the first past the record kernels' 64, since
// it beat the looped DMAX = 128 kernel, which it replaced, at D = 65, 96 and
// 128, at K = 1 and at the JAX rule's largest K (PERF.md)
constexpr int kTiledDMin = 65;

static_assert(kTileThreads == (kTileM / 8) * (kTileP / 8), "an 8 x 8 micro-tile a thread");
static_assert(kTileM * kTileK % kTileThreads == 0 && kTileP * kTileK % kTileThreads == 0,
              "whole copies a thread");

// one step of a block's walk: particle tile, component, row tile, panel
struct TileStep {
  long long tile;
  int k, rt, p;
};

// the depth panels of row tile rt (tri: those at or left of its last row)
__device__ __forceinline__ int tile_panels(int rt, int D, bool tri) {
  if (!tri) return (D + kTileK - 1) / kTileK;
  return (min(D, (rt + 1) * kTileM) - 1) / kTileK + 1;
}

// Issue the copies of step s's A panel (As[jj][ii] = A_k[i0 + ii][j0 + jj],
// zero past D and, tri, above the diagonal), X panel (Xs[kk][pc] =
// xT[j0 + kk][n0 + pc], zero past D or N) and m panel (Ms[kk] = m_k[j0 +
// kk], zero past D).  Thread t copies rows i0 + t / 8 + 32 q of A_k at
// columns j0 + t % 8 + 8 h, so that a warp copies 4 rows of 8 consecutive
// words, which land in 32 distinct banks, and column n0 + t % kTileP of X
// at rows j0 + t / kTileP + 2 r: each address a step from the last.
template <bool TRI>
__device__ __forceinline__ void tile_stage(float* As, float* Xs, float* Ms, const float* xT,
                                           const float* M, const float* mu, long long N, int D,
                                           const TileStep& s) {
  constexpr int kXRows = kTileThreads / kTileP;   // rows of X a pass of the block copies
  const int t = threadIdx.x, j0 = s.p * kTileK;
  const int ib = s.rt * kTileM + t / 8, jb = j0 + t % 8;
  const float* a = M + (static_cast<long long>(s.k) * D + ib) * D + jb;
  float* as = As + (t % 8) * kTileStride + t / 8;
#pragma unroll
  for (int q = 0; q < kTileM / 32; ++q) {
#pragma unroll
    for (int h = 0; h < kTileK / 8; ++h) {
      const int i = ib + 32 * q, j = jb + 8 * h;
      const bool valid = i < D && j < D && (!TRI || j <= i);
      cp_async_f32(as + 8 * h * kTileStride + 32 * q,
                   valid ? a + static_cast<long long>(32 * q) * D + 8 * h : M, valid);
    }
  }
  const long long n = s.tile * kTileP + t % kTileP;
  const int jx = j0 + t / kTileP;
  const float* x = xT + static_cast<long long>(jx) * N + n;
#pragma unroll
  for (int r = 0; r < kTileK / kXRows; ++r) {
    const bool valid = n < N && jx + kXRows * r < D;
    cp_async_f32(Xs + t + r * kTileThreads, valid ? x + kXRows * r * N : xT, valid);
  }
  if (t < kTileK) {
    const bool valid = j0 + t < D;
    cp_async_f32(Ms + t, valid ? mu + static_cast<long long>(s.k) * D + j0 + t : mu, valid);
  }
}

// acc += the panel's product on this thread's 8 x 8 micro-tile, x - m_k
// formed as the X words are read
__device__ __forceinline__ void tile_fma(const float* As, const float* Xs, const float* Ms,
                                         float (&acc)[8][8], int ty, int tx) {
#pragma unroll
  for (int k4 = 0; k4 < kTileK; k4 += 4) {
    const float4 m4 = *reinterpret_cast<const float4*>(Ms + k4);
    const float mk[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int kk = k4 + q;
      const float4 a0 = *reinterpret_cast<const float4*>(As + kk * kTileStride + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(As + kk * kTileStride + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(Xs + kk * kTileP + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(Xs + kk * kTileP + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x - mk[q], b0.y - mk[q], b0.z - mk[q], b0.w - mk[q],
                          b1.x - mk[q], b1.y - mk[q], b1.z - mk[q], b1.w - mk[q]};
#pragma unroll
      for (int r = 0; r < 8; ++r) {
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
      }
    }
  }
}

// The walk of a tiled block (grid-stride over particle tiles): for every
// particle n of its tiles and every component k, ascending, hands |M_k (x_n
// - mu_k)|^2 to epi(k, n, value) on thread n % kTileP (threads 0 ..
// kTileP - 1; n may be past N, and then epi must not write).  M (K, D, D)
// row-major (tri: lower triangular, only the lower triangle read), mu (K,
// D).  smem: kTiledSmem bytes, 16-byte aligned.
template <bool TRI, typename Epi>
__device__ __forceinline__ void tiled_eval(float* smem, const float* xT, const float* M,
                                           const float* mu, long long N, int K, int D,
                                           Epi&& epi) {
  const long long n_tiles = (N + kTileP - 1) / kTileP;
  const int n_rows = (D + kTileM - 1) / kTileM;
  const int t = threadIdx.x, ty = t / (kTileP / 8), tx = t % (kTileP / 8);
  float* red = smem + 2 * kTileAFloats + 2 * kTileXFloats + 2 * kTileK;
  const auto A = [&](int b) { return smem + b * kTileAFloats; };
  const auto X = [&](int b) { return smem + 2 * kTileAFloats + b * kTileXFloats; };
  const auto Ms = [&](int b) { return smem + 2 * kTileAFloats + 2 * kTileXFloats + b * kTileK; };
  TileStep cur{blockIdx.x, 0, 0, 0};
  if (cur.tile >= n_tiles) return;
  tile_stage<TRI>(A(0), X(0), Ms(0), xT, M, mu, N, D, cur);
  cp_async_commit();
  float acc[8][8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[r][c] = 0.0f;
  }
  // this thread's 8 per-particle partials of the component, kept in red
  float* const part0 = red + ty * kTileP + tx * 4;
  float* const part1 = part0 + 64;
  for (int b = 0;; b ^= 1) {
    const bool row_end = cur.p + 1 == tile_panels(cur.rt, D, TRI);
    const bool k_end = row_end && cur.rt + 1 == n_rows;
    TileStep nxt = cur;
    bool more = true;
    if (++nxt.p == tile_panels(nxt.rt, D, TRI)) {
      nxt.p = 0;
      if (++nxt.rt == n_rows) {
        nxt.rt = 0;
        if (++nxt.k == K) {
          nxt.k = 0;
          nxt.tile += gridDim.x;
          more = nxt.tile < n_tiles;
        }
      }
    }
    if (more) tile_stage<TRI>(A(b ^ 1), X(b ^ 1), Ms(b ^ 1), xT, M, mu, N, D, nxt);
    cp_async_commit();
    cp_async_wait<1>();   // this thread's copies of step cur have landed
    __syncthreads();
    tile_fma(A(b), X(b), Ms(b), acc, ty, tx);
    if (row_end) {
      // the row tile's squares into the partials (set at the first row tile)
      float part[8];
      const float4 p0 = cur.rt == 0 ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                                    : *reinterpret_cast<const float4*>(part0);
      const float4 p1 = cur.rt == 0 ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                                    : *reinterpret_cast<const float4*>(part1);
      part[0] = p0.x; part[1] = p0.y; part[2] = p0.z; part[3] = p0.w;
      part[4] = p1.x; part[5] = p1.y; part[6] = p1.z; part[7] = p1.w;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          part[c] = fmaf(acc[r][c], acc[r][c], part[c]);
          acc[r][c] = 0.0f;
        }
      }
      *reinterpret_cast<float4*>(part0) = make_float4(part[0], part[1], part[2], part[3]);
      *reinterpret_cast<float4*>(part1) = make_float4(part[4], part[5], part[6], part[7]);
    }
    __syncthreads();      // buffer b is refilled next; the partials are in
    if (k_end && t < kTileP) {
      float v = 0.0f;
#pragma unroll
      for (int q = 0; q < kTileRedFloats / kTileP; ++q) v += red[q * kTileP + t];
      epi(cur.k, cur.tile * kTileP + t, v);
    }
    if (!more) break;
    cur = nxt;
  }
}

// fused_maha's and fused_logq's variants (the launchers' codes; -1 the
// elected one) and the one elected for D (ops/_build.py eval_variant): the
// record kernel below kTiledDMin, the tiled kernel from it
constexpr int kEvalRec = 1, kEvalTiled = 2;
static_assert(kTiledDMin <= kRecDMax + 1, "a record kernel below kTiledDMin");
__host__ __device__ inline int eval_variant(int D) {
  return D < kTiledDMin ? kEvalRec : kEvalTiled;
}

// whether fused_maha's and fused_logq's launchers have variant v at D: the
// record kernel to D = 64, the tiled kernel at every D to kWideDMax
__host__ __device__ inline bool eval_has_variant(int D, int v) {
  if (D < 1 || D > kWideDMax) return false;
  return v == kEvalTiled || (v == kEvalRec && D <= kRecDMax);
}

// The shared memory of fused_maha's (maha) or fused_logq's elected kernel at
// (K, D) (ops/_build.py eval_plan): the tiled kernel's, else eval_plan's.
inline size_t eval_variant_smem(int K, int D, bool maha) {
  return eval_variant(D) == kEvalTiled ? kTiledSmem : eval_plan(K, D, maha).smem;
}

// Call body(kernel, threads, smem) with fused_maha's or fused_logq's kernel
// of variant v (-1: eval_variant's) at (K, D), its shared memory set first
// as its limit; Kernels has ``maha`` (fused_maha's records) and rec<DMAX>()
// and tiled(), the kernels.  body's result, the error of setting the limit,
// or cudaErrorInvalidValue where v has no kernel at D.
template <typename Kernels, typename Body>
int with_eval_variant(int K, int D, int variant, Body&& body) {
  const int v = variant < 0 ? eval_variant(D) : variant;
  if (!eval_has_variant(D, v)) return static_cast<int>(cudaErrorInvalidValue);
  const auto run = [&](auto kernel, int threads, size_t smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    return body(kernel, threads, smem);
  };
  if (v == kEvalTiled) return run(Kernels::tiled(), kTileThreads, kTiledSmem);
  const EvalPlan plan = eval_plan(K, D, Kernels::maha);
  auto rec = [&](auto dmax, auto) {
    return run(Kernels::template rec<decltype(dmax)::value>(), kEvalThreads, plan.smem);
  };
  return dispatch_records(D, rec, EvalInsts());
}

// blocks of fused_maha's or fused_logq's kernel of variant v at (K, D)
// that fit on one SM at once (registers, shared memory and threads); -1 on
// an error
template <typename Kernels>
int eval_variant_per_sm(int K, int D, int variant) {
  int n = 0;
  const int err = with_eval_variant<Kernels>(K, D, variant, [&](auto kernel, int threads,
                                                                size_t smem) {
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem));
  });
  return err == 0 ? n : -1;
}

}  // namespace pmc
