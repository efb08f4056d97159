// The block-tiled FP32 product engine past the record kernels: the
// evaluation kernels of fused_maha, fused_logq and fused_rho (maha.cu
// maha_tiled_kernel, logq.cu logq_tiled_kernel, rho.cu rho_tiled_kernel) and
// fused_transform's product (transform.cu transform_tiled_kernel);
// ops/_build.py tiled_plan mirrors the constants.
//
// Each is a product in disguise: for component k and a tile of P particles,
// Y_k = A_k (X - m_k) is a (D x D) (D x P) product.  The evaluations want the
// column sums of Y_k * Y_k (fused_logq's and fused_rho's A_k = U_k lower
// triangular, then the component's log-density); fused_transform wants Y_k =
// L_k Z itself, for the particles whose component is k.
//
// Bound on the H100: FP32 FMAs, D^2 a (particle, component) for a general
// A_k, D (D + 1) / 2 for a triangular U_k or L_k, against D + K (or D + 1,
// or the transform's 2 D + 2) floats of a particle moved; no tensor cores,
// since TF32 keeps ~3 digits and the products here are held to float32
// tolerances (fused_transform's, bit for bit to its looped kernel).
//
// Design.  A block of kTileThreads (256) walks its tiles (grid-stride over
// slots of a tile source, below) and in each tile the components of the
// tile, the row tiles of kTileM (128) rows of A_k, and for each row tile the
// depth panels of kTileK (16) columns, with a triangular A_k only the panels
// at or left of the tile's last row.  A step is one (k, row tile, panel):
// its A panel, transposed (the rows of A_k on the fast axis, rows
// kTileStride floats apart), and its X panel (kTileK rows of xT, kTileP
// particle columns) are copied to shared memory by cp.async into one of two
// buffers, the next step's copy in flight while this one is used, so the
// pipeline runs on across row tiles, components and tiles.  With CENTER the
// step's m_k panel is copied beside them and x - m_k is formed as each X
// word is read into registers, never stored in device memory.  Each thread
// holds an 8 x 8 register micro-tile of Y_k (rows ty*4 + {0..3} and 64 +
// ty*4 + {0..3}, particles tx*4 + {0..3} and 64 + tx*4 + {0..3}), read by
// LDS.128 from both panels: 4 loads feed 64 FMAs, where a warp a particle
// (warp.cuh) gave each word read from L2 one FMA.  Each accumulator is one
// row's dot product with j ascending, the FMA order of whiten, project and
// affine_transform (a zero above a triangle's diagonal or past D adds
// fmaf(0, z, s) = s).  The ragged edges are masked: A past D (and above a
// triangular A's diagonal) and X past D or past the tile's run are copied as
// zeros, and a particle past the run is computed and never handed on.
//
// Two tile sources.  ParticleTiles (the evaluations): tile t holds 128
// consecutive particles and all K components.  BucketTiles (fused_transform):
// tile t holds one component k and a run of up to 128 entries of a
// permutation of the particles that lists each component's particles
// together (transform.cu transform_bucket_kernel), its X panel gathered,
// Xs[kk][pc] = zT[(j0 + kk) N + perm[start + pc]] by 4-byte cp.async: each
// particle uses its own component, so only a tile of one component shares
// L_k's panels, where the JAX kernel computes all K products and keeps one.
//
// Two epilogues.  SquaresEpi (the evaluations): at a row tile's end a
// thread adds its rows' squares into its 8 per-particle partials, which it
// keeps in its own words of shared memory (in registers they spilled the
// triangular kernel at 128); at a component's end thread p sums column p of
// the 16 threads that share particle p, ty ascending, a fixed order with no
// atomics, so one input gives one output.  A row-tile epilogue of the
// caller's (fused_transform's StoreEpi) takes the thread's 8 x 8
// accumulators with their rows and the tile's particles instead.
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
// where the partials start, after two A, two X and two m panels
constexpr int kTileRedOffset = 2 * kTileAFloats + 2 * kTileXFloats + 2 * kTileK;
// shared memory of a tiled block: two A panels, two X panels, two m panels,
// the partials (fused_transform's tile particles in their place)
constexpr size_t kTiledSmem = sizeof(float) * (kTileRedOffset + kTileRedFloats);
// the smallest D at which fused_maha, fused_logq and fused_rho take the
// tiled kernel (ops/_build.py TILED_D_MIN): the first past the record
// kernels' 64, since it beat the looped DMAX = 128 kernel, which it
// replaced, at D = 65, 96 and 128, at K = 1 and at the JAX rule's largest K
// (PERF.md)
constexpr int kTiledDMin = 65;

static_assert(kTileThreads == (kTileM / 8) * (kTileP / 8), "an 8 x 8 micro-tile a thread");
static_assert(kTileM * kTileK % kTileThreads == 0 && kTileP * kTileK % kTileThreads == 0,
              "whole copies a thread");
static_assert(kTileRedOffset % 4 == 0, "16-byte aligned partials");

// the depth panels of row tile rt (tri: those at or left of its last row)
__device__ __forceinline__ int tile_panels(int rt, int D, bool tri) {
  if (!tri) return (D + kTileK - 1) / kTileK;
  return (min(D, (rt + 1) * kTileM) - 1) / kTileK + 1;
}

// Tile source of the evaluations: slot t is the tile of particles t kTileP
// .. t kTileP + kTileP - 1 (those below N) with all K components.
struct ParticleTiles {
  struct Tile {};
  long long N;
  int K;
  // whether slot t (the block's next, grid-stride) holds a tile
  __device__ bool at(long long& t, Tile&) const { return t * kTileP < N; }
  __device__ int k0(const Tile&) const { return 0; }
  __device__ int k1(const Tile&) const { return K; }
  // the particle of column 0
  __device__ long long first(long long t, const Tile&) const { return t * kTileP; }
  // this thread's column's particle (column threadIdx.x % kTileP), -1 past N
  __device__ long long col(long long t, const Tile&) const {
    const long long n = t * kTileP + threadIdx.x % kTileP;
    return n < N ? n : -1;
  }
};

// Tile source of fused_transform: slot t holds {k, start, len, 0} (k < 0:
// no tile), the tile of component k's particles perm[start .. start + len
// - 1]; the slots and perm written by transform_bucket_kernel.  A block
// skips the empty slots of its stride.
struct BucketTiles {
  struct Tile {
    int k, first, col;
  };
  const int4* slots;
  const int* perm;
  long long n_slots;
  __device__ bool at(long long& t, Tile& tile) const {
    for (; t < n_slots; t += gridDim.x) {
      const int4 e = slots[t];
      if (e.x < 0) continue;
      const int pc = threadIdx.x % kTileP;
      tile = {e.x, e.y, pc < e.z ? perm[e.y + pc] : -1};
      return true;
    }
    return false;
  }
  __device__ int k0(const Tile& tile) const { return tile.k; }
  __device__ int k1(const Tile& tile) const { return tile.k + 1; }
  __device__ long long first(long long, const Tile& tile) const { return tile.first; }
  __device__ long long col(long long, const Tile& tile) const { return tile.col; }
};

// Issue the copies of a step's A panel (As[jj][ii] = A_k[i0 + ii][j0 + jj],
// zero past D and, tri, above the diagonal), X panel (Xs[kk][pc] = xT[j0 +
// kk][col(pc)], zero past D or past the run) and, CENTER, m panel (Ms[kk] =
// m_k[j0 + kk], zero past D).  Thread t copies rows i0 + t / 8 + 32 q of A_k
// at columns j0 + t % 8 + 8 h, so that a warp copies 4 rows of 8 consecutive
// words, which land in 32 distinct banks, and column t % kTileP of X (its
// particle ``col``, -1 past the run) at rows j0 + t / kTileP + 2 r: each
// address a step from the last.
template <bool TRI, bool CENTER>
__device__ __forceinline__ void tile_stage(float* As, float* Xs, float* Ms, const float* xT,
                                           const float* M, const float* mu, long long N, int D,
                                           int k, int rt, int p, long long col) {
  constexpr int kXRows = kTileThreads / kTileP;   // rows of X a pass of the block copies
  const int t = threadIdx.x, j0 = p * kTileK;
  const int ib = rt * kTileM + t / 8, jb = j0 + t % 8;
  const float* a = M + (static_cast<long long>(k) * D + ib) * D + jb;
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
  const int jx = j0 + t / kTileP;
  const float* x = xT + static_cast<long long>(jx) * N + col;
#pragma unroll
  for (int r = 0; r < kTileK / kXRows; ++r) {
    const bool valid = col >= 0 && jx + kXRows * r < D;
    cp_async_f32(Xs + t + r * kTileThreads, valid ? x + kXRows * r * N : xT, valid);
  }
  if (CENTER && t < kTileK) {
    const bool valid = j0 + t < D;
    cp_async_f32(Ms + t, valid ? mu + static_cast<long long>(k) * D + j0 + t : mu, valid);
  }
}

// acc += the panel's product on this thread's 8 x 8 micro-tile; CENTER: x -
// m_k formed as the X words are read
template <bool CENTER>
__device__ __forceinline__ void tile_fma(const float* As, const float* Xs, const float* Ms,
                                         float (&acc)[8][8], int ty, int tx) {
#pragma unroll
  for (int k4 = 0; k4 < kTileK; k4 += 4) {
    float mk[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if constexpr (CENTER) {
      const float4 m4 = *reinterpret_cast<const float4*>(Ms + k4);
      mk[0] = m4.x; mk[1] = m4.y; mk[2] = m4.z; mk[3] = m4.w;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int kk = k4 + q;
      const float4 a0 = *reinterpret_cast<const float4*>(As + kk * kTileStride + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(As + kk * kTileStride + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(Xs + kk * kTileP + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(Xs + kk * kTileP + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      if constexpr (CENTER) {
#pragma unroll
        for (int c = 0; c < 8; ++c) b[c] = b[c] - mk[q];
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
      }
    }
  }
}

// the row of A_k and the tile column of a thread's micro-tile entry (r, c)
__device__ __forceinline__ int tile_row(int rt, int ty, int r) {
  return rt * kTileM + (r < 4 ? ty * 4 + r : 64 + ty * 4 + r - 4);
}
__device__ __forceinline__ int tile_col(int tx, int c) {
  return c < 4 ? tx * 4 + c : 64 + tx * 4 + c - 4;
}

// The walk of a tiled block over the tiles of ``src`` (grid-stride over its
// slots): for each tile, its components ascending, their row tiles and
// panels.  M (K, D, D) row-major (TRI: lower triangular, only the lower
// triangle read), mu (K, D) (CENTER; else unused).  smem: kTiledSmem bytes,
// 16-byte aligned.  epi, the epilogue, has
//   tile(src, t, tile, q): a tile begins, the block's q-th (called when its
//     first step is staged, while the tile before is still computed);
//   row_end(src, step, q, acc, ty, tx): a row tile's product in acc, which
//     it sets back to 0 (between the step's two barriers);
//   k_end(src, step, q): a component of the tile is done (after them).
// step has the slot ``t``, the tile ``tile``, the component ``k`` and the
// row tile ``rt``.
template <bool TRI, bool CENTER, typename Source, typename Epi>
__device__ __forceinline__ void tiled_walk(float* smem, const float* xT, const float* M,
                                           const float* mu, long long N, int D,
                                           const Source& src, Epi& epi) {
  struct Step {
    long long t;
    int k, rt, p;
    typename Source::Tile tile;
  };
  const int n_rows = (D + kTileM - 1) / kTileM;
  const int ty = threadIdx.x / (kTileP / 8), tx = threadIdx.x % (kTileP / 8);
  const auto A = [&](int b) { return smem + b * kTileAFloats; };
  const auto X = [&](int b) { return smem + 2 * kTileAFloats + b * kTileXFloats; };
  const auto Ms = [&](int b) { return smem + 2 * kTileAFloats + 2 * kTileXFloats + b * kTileK; };
  const auto stage = [&](int b, const Step& s) {
    tile_stage<TRI, CENTER>(A(b), X(b), Ms(b), xT, M, mu, N, D, s.k, s.rt, s.p,
                            src.col(s.t, s.tile));
  };
  Step cur;
  cur.t = blockIdx.x;
  if (!src.at(cur.t, cur.tile)) return;
  cur.k = src.k0(cur.tile);
  cur.rt = 0;
  cur.p = 0;
  int q = 0;   // the tiles this block began before cur's
  epi.tile(src, cur.t, cur.tile, q);
  stage(0, cur);
  cp_async_commit();
  float acc[8][8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[r][c] = 0.0f;
  }
  for (int b = 0;; b ^= 1) {
    const bool row_end = cur.p + 1 == tile_panels(cur.rt, D, TRI);
    const bool k_end = row_end && cur.rt + 1 == n_rows;
    Step nxt = cur;
    bool more = true, new_tile = false;
    if (++nxt.p == tile_panels(nxt.rt, D, TRI)) {
      nxt.p = 0;
      if (++nxt.rt == n_rows) {
        nxt.rt = 0;
        if (++nxt.k == src.k1(nxt.tile)) {
          nxt.t += gridDim.x;
          more = src.at(nxt.t, nxt.tile);
          nxt.k = src.k0(nxt.tile);
          new_tile = true;
        }
      }
    }
    if (more) {
      if (new_tile) epi.tile(src, nxt.t, nxt.tile, q + 1);
      stage(b ^ 1, nxt);
    }
    cp_async_commit();
    cp_async_wait<1>();   // this thread's copies of step cur have landed
    __syncthreads();
    tile_fma<CENTER>(A(b), X(b), Ms(b), acc, ty, tx);
    if (row_end) epi.row_end(src, cur, q, acc, ty, tx);
    __syncthreads();      // buffer b is refilled next; the epilogue's shared words are in
    if (k_end) epi.k_end(src, cur, q);
    if (!more) break;
    q += new_tile ? 1 : 0;
    cur = nxt;
  }
}

// The evaluations' epilogue: hands |M_k (x_n - mu_k)|^2 to f(k, n, value)
// on thread n % kTileP (threads 0 .. kTileP - 1; n may be past N, and then f
// must not write), k ascending for each particle.
template <typename F>
struct SquaresEpi {
  float* red;   // the partials, kTileRedFloats
  F f;
  template <typename Src, typename Tile>
  __device__ void tile(const Src&, long long, const Tile&, int) {}
  // the row tile's squares into this thread's 8 partials (set at the first
  // row tile)
  template <typename Src, typename Step>
  __device__ void row_end(const Src&, const Step& s, int, float (&acc)[8][8], int ty, int tx) {
    float* const part0 = red + ty * kTileP + tx * 4;
    float* const part1 = part0 + 64;
    float part[8];
    const float4 p0 = s.rt == 0 ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                                : *reinterpret_cast<const float4*>(part0);
    const float4 p1 = s.rt == 0 ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
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
  template <typename Src, typename Step>
  __device__ void k_end(const Src& src, const Step& s, int) {
    const int t = threadIdx.x;
    if (t >= kTileP) return;
    float v = 0.0f;
#pragma unroll
    for (int q = 0; q < kTileRedFloats / kTileP; ++q) v += red[q * kTileP + t];
    f(s.k, src.first(s.t, s.tile) + t, v);
  }
};

// The evaluations' walk: for every particle n of its tiles and every
// component k, ascending, hands |M_k (x_n - mu_k)|^2 to epi(k, n, value) on
// thread n % kTileP (threads 0 .. kTileP - 1; n may be past N, and then epi
// must not write).  M (K, D, D) row-major (tri: lower triangular, only the
// lower triangle read), mu (K, D).  smem: kTiledSmem bytes, 16-byte aligned.
template <bool TRI, typename Epi>
__device__ __forceinline__ void tiled_eval(float* smem, const float* xT, const float* M,
                                           const float* mu, long long N, int K, int D,
                                           Epi&& epi) {
  SquaresEpi<Epi&> squares{smem + kTileRedOffset, epi};
  tiled_walk<TRI, true>(smem, xT, M, mu, N, D, ParticleTiles{N, K}, squares);
}

// fused_maha's, fused_logq's and fused_rho's variants (the launchers'
// codes; -1 the elected one) and the one elected for D (ops/_build.py
// eval_variant): the record kernel below kTiledDMin, the tiled kernel from
// it
constexpr int kEvalRec = 1, kEvalTiled = 2;
static_assert(kTiledDMin <= kRecDMax + 1, "a record kernel below kTiledDMin");
__host__ __device__ inline int eval_variant(int D) {
  return D < kTiledDMin ? kEvalRec : kEvalTiled;
}

// whether fused_maha's, fused_logq's and fused_rho's launchers have variant
// v at D: the record kernel to D = 64, the tiled kernel at every D to
// kWideDMax
__host__ __device__ inline bool eval_has_variant(int D, int v) {
  if (D < 1 || D > kWideDMax) return false;
  return v == kEvalTiled || (v == kEvalRec && D <= kRecDMax);
}

// The shared memory of fused_maha's (maha) or fused_logq's and fused_rho's
// elected kernel at (K, D) (ops/_build.py eval_plan): the tiled kernel's,
// else eval_plan's.
inline size_t eval_variant_smem(int K, int D, bool maha) {
  return eval_variant(D) == kEvalTiled ? kTiledSmem : eval_plan(K, D, maha).smem;
}

// Call body(kernel, threads, smem) with fused_maha's, fused_logq's or
// fused_rho's kernel of variant v (-1: eval_variant's) at (K, D), its shared
// memory set first as its limit; Kernels has ``maha`` (fused_maha's records)
// and rec<DMAX>() and tiled(), the kernels.  body's result, the error of setting the limit,
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

// blocks of fused_maha's, fused_logq's or fused_rho's kernel of variant v
// at (K, D) that fit on one SM at once (registers, shared memory and threads); -1 on
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
