// The block-tiled FP32 product engine past the record kernels: the
// evaluation kernels of fused_maha, fused_logq and fused_rho (maha.cu
// maha_tiled_kernel, logq.cu logq_tiled_kernel, rho.cu rho_tiled_kernel),
// fused_transform's product (transform.cu transform_tiled_kernel) and the
// drawn products of fused_transform_rng and fused_propose_logq
// (draw_tiled_kernel, below); ops/_build.py tiled_plan and draw_tiled_smem
// mirror the constants.
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
// LDS.128 from both panels: 4 loads feed 64 FMAs, where the warp-a-particle
// kernels these replaced gave each word read from L2 one FMA.  Each accumulator is one
// row's dot product with j ascending, the FMA order of whiten, project and
// affine_transform (a zero above a triangle's diagonal or past D adds
// fmaf(0, z, s) = s).  The ragged edges are masked: A past D (and above a
// triangular A's diagonal) and X past D or past the tile's run are copied as
// zeros, and a particle past the run is computed and never handed on.
//
// Two tile sources.  ParticleTiles (the evaluations): tile t holds 128
// consecutive particles and all K components (the drawn products at K = 1:
// one).  BucketTiles (the draws at K > 1): tile t holds one component k and
// a run of up to 128 entries of a
// permutation of the particles that lists each component's particles
// together (transform.cu transform_bucket_kernel), its X panel gathered,
// Xs[kk][pc] = zT[(j0 + kk) N + perm[start + pc]] by 4-byte cp.async: each
// particle uses its own component, so only a tile of one component shares
// L_k's panels, where the JAX kernel computes all K products and keeps one.
//
// Two X sources.  LoadedX (the evaluations, fused_transform) copies the
// panel from device memory by cp.async, as above.  DrawnX
// (fused_transform_rng's and fused_propose_logq's products) draws it in
// shared memory: row j of particle n is draw_normals' j-th normal of n's
// Philox stream after its first OFF words (words OFF + 2 (j / 2) and OFF +
// 2 (j / 2) + 1, Box-Muller), thread t drawing rows j0 + 8 (t / 128) .. + 7
// of its column's particle from the two or three Philox blocks that hold
// their words, so that a tile's particles need no contiguous indices and
// the panel is the looped kernel's normals bit for bit.  Where D > kTileM
// the panels of row tile 0 (kDrawCachePanels of them) are drawn into a
// cache beside the engine's shared memory and read there by the row tiles
// below, so that D <= 256 draws each normal once; the others are drawn into
// the step's X buffer, the next step's while this one is computed.
//
// Two epilogues.  SquaresEpi (the evaluations): at a row tile's end a
// thread adds its rows' squares into its 8 per-particle partials, which it
// keeps in its own words of shared memory (in registers they spilled the
// triangular kernel at 128); at a component's end thread p sums column p of
// the 16 threads that share particle p, ty ascending, a fixed order with no
// atomics, so one input gives one output.  A row-tile epilogue of the
// caller's (fused_transform's StoreEpi) takes the thread's 8 x 8
// accumulators with their rows and the tile's particles instead.
//
// The bucket kernel (transform_bucket_kernel, below) writes BucketTiles'
// slots: a counting sort of the particles by component, a chunk of
// kBucketChunk particles a block, on components given (fused_transform,
// fused_transform_rng) or drawn from word 0 of each particle's stream
// (fused_propose_logq).
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
// zero past D and, tri, above the diagonal) and, CENTER, m panel (Ms[kk] =
// m_k[j0 + kk], zero past D).  Thread t copies rows i0 + t / 8 + 32 q of A_k
// at columns j0 + t % 8 + 8 h, so that a warp copies 4 rows of 8 consecutive
// words, which land in 32 distinct banks.
template <bool TRI, bool CENTER>
__device__ __forceinline__ void tile_stage(float* As, float* Ms, const float* M, const float* mu,
                                           int D, int k, int rt, int p) {
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
  if (CENTER && t < kTileK) {
    const bool valid = j0 + t < D;
    cp_async_f32(Ms + t, valid ? mu + static_cast<long long>(k) * D + j0 + t : mu, valid);
  }
}

// An X source's stage(Xs, rt, p, col, D): the X panel of row tile rt's
// panel p (Xs[kk][pc] = row p kTileK + kk of column pc's particle, zero past
// D or past the run) for this thread's share, ``col`` the particle of its
// column t % kTileP (-1 past the run): copies issued (waited for with the
// step's) or values stored, into Xs or elsewhere in shared memory; returns
// where the panel is read.

// X from xT (D, N) in device memory: thread t copies its column at rows j0
// + t / kTileP + 2 r, each address a step from the last.
struct LoadedX {
  const float* xT;
  long long N;
  __device__ __forceinline__ const float* stage(float* Xs, int, int p, long long col,
                                                int D) const {
    constexpr int kXRows = kTileThreads / kTileP;   // rows of X a pass of the block copies
    const int t = threadIdx.x, jx = p * kTileK + t / kTileP;
    const float* x = xT + static_cast<long long>(jx) * N + col;
#pragma unroll
    for (int r = 0; r < kTileK / kXRows; ++r) {
      const bool valid = col >= 0 && jx + kXRows * r < D;
      cp_async_f32(Xs + t + r * kTileThreads, valid ? x + kXRows * r * N : xT, valid);
    }
    return Xs;
  }
};

// z = rows j .. j + 7 (j a multiple of 8) of draw_normals' normals of
// particle n's stream (key, n) after its first OFF words: words OFF + j ..
// OFF + j + 7, from Philox blocks j / 4 on (two, three where OFF > 0)
template <int OFF, typename Key>
__device__ __forceinline__ void draw_eight(Key key, uint64_t n, int j, float (&z)[8]) {
  static_assert(OFF >= 0 && OFF < 4, "the words start in block j / 4");
  constexpr int kBlocks = OFF == 0 ? 2 : 3;
  uint32_t w[4 * kBlocks];
  PhiloxT<Key> r(key, n);
  r.c2 = static_cast<uint32_t>(j / 4);
#pragma unroll
  for (int b = 0; b < kBlocks; ++b) {
    r.refill();
    w[4 * b] = r.b0;
    w[4 * b + 1] = r.b1;
    w[4 * b + 2] = r.b2;
    w[4 * b + 3] = r.b3;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) PhiloxT<Key>::box_muller(w[OFF + 2 * q], w[OFF + 2 * q + 1],
                                                      z[2 * q], z[2 * q + 1]);
}

static_assert(kTileK == 8 * (kTileThreads / kTileP), "a drawn panel: 8 rows a thread");
constexpr int kDrawCachePanels = kTileM / kTileK;   // row tile 0's panels
constexpr int kDrawCacheFloats = kDrawCachePanels * kTileXFloats;

// X drawn in shared memory (the header's DrawnX): normals of the stream
// (key, n) after its first OFF words; cache, kDrawCacheFloats of shared
// memory where D > kTileM (else null), holds row tile 0's panels.
template <int OFF, typename Key>
struct DrawnX {
  Key key;
  float* cache;
  __device__ __forceinline__ const float* stage(float* Xs, int rt, int p, long long col,
                                                int D) const {
    const bool cached = cache != nullptr && p < kDrawCachePanels;
    float* dst = cached ? cache + p * kTileXFloats : Xs;
    if (cached && rt > 0) return dst;
    const int pc = threadIdx.x % kTileP, h = threadIdx.x / kTileP;
    const int j = p * kTileK + 8 * h;   // this thread's first row
    float z[8];
    if (col >= 0 && j < D) {
      draw_eight<OFF>(key, static_cast<uint64_t>(col), j, z);
    } else {
#pragma unroll
      for (int r = 0; r < 8; ++r) z[r] = 0.0f;
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) dst[(8 * h + r) * kTileP + pc] = j + r < D ? z[r] : 0.0f;
    return dst;
  }
};

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
// panels, the X panels from ``xsrc`` (LoadedX, DrawnX).  M (K, D, D)
// row-major (TRI: lower triangular, only the lower triangle read), mu (K,
// D) (CENTER; else unused).  smem: kTiledSmem bytes, 16-byte aligned.  epi,
// the epilogue, has
//   tile(src, t, tile, q): a tile begins, the block's q-th (called when its
//     first step is staged, while the tile before is still computed);
//   row_end(src, step, q, acc, ty, tx): a row tile's product in acc, which
//     it sets back to 0 (between the step's two barriers);
//   k_end(src, step, q): a component of the tile is done (after them).
// step has the slot ``t``, the tile ``tile``, the component ``k`` and the
// row tile ``rt``.
template <bool TRI, bool CENTER, typename Source, typename XSource, typename Epi>
__device__ __forceinline__ void tiled_walk(float* smem, const XSource& xsrc, const float* M,
                                           const float* mu, int D, const Source& src,
                                           Epi& epi) {
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
  // issue step s's copies into buffer b; where its X panel is read
  const auto stage = [&](int b, const Step& s) {
    tile_stage<TRI, CENTER>(A(b), Ms(b), M, mu, D, s.k, s.rt, s.p);
    return xsrc.stage(X(b), s.rt, s.p, src.col(s.t, s.tile), D);
  };
  Step cur;
  cur.t = blockIdx.x;
  if (!src.at(cur.t, cur.tile)) return;
  cur.k = src.k0(cur.tile);
  cur.rt = 0;
  cur.p = 0;
  int q = 0;   // the tiles this block began before cur's
  epi.tile(src, cur.t, cur.tile, q);
  const float* xs = stage(0, cur);
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
    const float* xs_nxt = xs;
    if (more) {
      if (new_tile) epi.tile(src, nxt.t, nxt.tile, q + 1);
      xs_nxt = stage(b ^ 1, nxt);
    }
    cp_async_commit();
    cp_async_wait<1>();   // this thread's copies of step cur have landed
    __syncthreads();      // and every thread's copies and stores
    tile_fma<CENTER>(A(b), xs, Ms(b), acc, ty, tx);
    if (row_end) epi.row_end(src, cur, q, acc, ty, tx);
    __syncthreads();      // buffer b is refilled next; the epilogue's shared words are in
    if (k_end) epi.k_end(src, cur, q);
    if (!more) break;
    q += new_tile ? 1 : 0;
    cur = nxt;
    xs = xs_nxt;
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
  tiled_walk<TRI, true>(smem, LoadedX{xT, N}, M, mu, D, ParticleTiles{N, K}, squares);
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


// ---------------------------------------------------------------------
// The draws' tiled products: fused_transform's (transform.cu, LoadedX on
// the given normals), fused_transform_rng's (transform.cu) and
// fused_propose_logq's (propose_logq.cu), DrawnX.  The bucket kernel sorts
// the particles by component (BucketTiles' slots); StoreEpi writes x.
// ---------------------------------------------------------------------

// The bucket kernel's block: 1,024 threads of 32 particles each.  A thread
// reads (or draws) its latents again for the scatter rather than keep them
// in registers: kept, they spilled the 64 registers a thread of 1,024 has
// (as 32 ints, and as 16 two-latent words, the unrolled loads' addresses
// beside them), and at 512 threads of 64 the 128 of 512
constexpr int kBucketThreads = 1024;
constexpr int kBucketItems = 32;                      // particles a thread
constexpr int kBucketChunk = kBucketThreads * kBucketItems;
constexpr int kBucketWarps = kBucketThreads / 32;

// slots of a full chunk: its tiles, at most one partial a component
__host__ __device__ constexpr long long bucket_chunk_slots(int K) {
  return kBucketChunk / kTileP + K;
}
// the slots of N particles: full chunks', then the last chunk's
// ceil(len / 128) + K
__host__ __device__ inline long long bucket_slots(long long N, int K) {
  if (N <= 0) return 0;
  const long long chunks = (N + kBucketChunk - 1) / kBucketChunk;
  const long long last = N - (chunks - 1) * kBucketChunk;
  return (chunks - 1) * bucket_chunk_slots(K) + (last + kTileP - 1) / kTileP + K;
}
// shared memory of a bucket block: a warp's count a component, then the
// buckets' starts and tiles (K + 1 each)
__host__ __device__ inline size_t bucket_smem_bytes(int K) {
  return sizeof(int) * (static_cast<size_t>(kBucketWarps) * K + 2 * (K + 1));
}
// int32 words of the scratch: perm (N, padded to 4: the slots are int4),
// then the slots
__host__ __device__ inline long long transform_scratch_words(long long N, int K) {
  return (N + 3) / 4 * 4 + 4 * bucket_slots(N, K);
}

// The bucket kernel's components: given, latent (N,) (fused_transform,
// fused_transform_rng) ...
struct GivenLatents {
  const int* latent;
  __device__ GivenLatents resolved() const { return *this; }
  __device__ int operator()(long long n) const { return __ldg(latent + n); }
};

// ... or drawn as propose_particle draws them (fused_propose_logq): the
// uniform of word 0 of particle n's stream against the K - 1 tail-sum
// thresholds cumw
struct DrawnLatents {
  Seed seed;
  const float* cumw;
  int K;
  // the seed's words read once (from a seed tensor)
  __device__ DrawnLatents resolved() const { return {{seed.w0(), seed.w1(), nullptr}, cumw, K}; }
  __device__ int operator()(long long n) const {
    Philox r(seed.s0, seed.s1, static_cast<uint64_t>(n));
    const float u = r.uniform();
    int lat = 0;
    for (int k = 0; k < K - 1; ++k) lat += u >= __ldg(cumw + k) ? 1 : 0;
    return lat;
  }
};

// The counting sort of chunk blockIdx.x: perm's entries of the chunk list
// its particles by component (the chunk's bucket k at its start + the
// counts of the buckets before), each bucket's particles in their order,
// and the chunk's slots (from blockIdx.x * bucket_chunk_slots(K)) its tiles,
// bucket by bucket, then empty slots (k = -1).  A latent outside [0, K) is
// left out (its column of x is not written).
template <typename Latents>
__global__ void __launch_bounds__(kBucketThreads)
transform_bucket_kernel(const Latents latents, int* __restrict__ perm, int4* __restrict__ slots,
                        long long N, int K) {
  extern __shared__ int bsm[];
  int* hist = bsm;                          // kBucketWarps x K
  int* start = hist + kBucketWarps * K;     // K + 1: the chunk's buckets
  int* tile0 = start + K + 1;               // K + 1: their first tiles
  const Latents lats = latents.resolved();
  const long long c0 = static_cast<long long>(blockIdx.x) * kBucketChunk;
  const int len = static_cast<int>(min(static_cast<long long>(kBucketChunk), N - c0));
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  for (int i = threadIdx.x; i < kBucketWarps * K; i += kBucketThreads) hist[i] = 0;
  // warp w's particles: chunk positions (w kBucketItems + r) 32 + lane; -1
  // past the chunk or outside [0, K)
  const auto lat = [&](int r) {
    const int i = (w * kBucketItems + r) * 32 + lane;
    const int v = i < len ? lats(c0 + i) : -1;
    return v >= 0 && v < K ? v : -1;
  };
  __syncthreads();
#pragma unroll 8
  for (int r = 0; r < kBucketItems; ++r) {
    const int k = lat(r);
    const unsigned g = __match_any_sync(0xffffffffu, k);
    if (k >= 0 && lane == __ffs(g) - 1) hist[w * K + k] += __popc(g);
    __syncwarp();
  }
  __syncthreads();
  // each bucket's warps in order: hist[w][k] becomes warp w's first
  // position in bucket k, start[k] the bucket's count
  for (int k = threadIdx.x; k < K; k += kBucketThreads) {
    int run = 0;
    for (int v = 0; v < kBucketWarps; ++v) {
      const int c = hist[v * K + k];
      hist[v * K + k] = run;
      run += c;
    }
    start[k] = run;
  }
  __syncthreads();
  // warp 0: the exclusive scans over k of the counts and of their tiles
  if (w == 0) {
    int base = 0, tbase = 0;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + lane;
      const int n = k < K ? start[k] : 0;
      const int tiles = (n + kTileP - 1) / kTileP;
      int sn = n, st = tiles;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int a = __shfl_up_sync(0xffffffffu, sn, o), b = __shfl_up_sync(0xffffffffu, st, o);
        if (lane >= o) {
          sn += a;
          st += b;
        }
      }
      if (k < K) {
        start[k] = base + sn - n;
        tile0[k] = tbase + st - tiles;
      }
      base += __shfl_sync(0xffffffffu, sn, 31);
      tbase += __shfl_sync(0xffffffffu, st, 31);
    }
    if (lane == 0) {
      start[K] = base;
      tile0[K] = tbase;
    }
  }
  __syncthreads();
  // the chunk's slots: tile j of bucket k at slot tile0[k] + j
  const long long s0 = static_cast<long long>(blockIdx.x) * bucket_chunk_slots(K);
  const int n_slots = (len + kTileP - 1) / kTileP + K;
  for (int l = threadIdx.x; l < n_slots; l += kBucketThreads) {
    int4 e = make_int4(-1, 0, 0, 0);
    if (l < tile0[K]) {
      int lo = 0, hi = K - 1;   // the last bucket whose first tile is at or before l
      while (lo < hi) {
        const int mid = (lo + hi + 1) / 2;
        if (tile0[mid] <= l) lo = mid;
        else hi = mid - 1;
      }
      const int first = start[lo] + (l - tile0[lo]) * kTileP;
      e = make_int4(lo, static_cast<int>(c0 + first), min(kTileP, start[lo + 1] - first), 0);
    }
    slots[s0 + l] = e;
  }
  // the scatter, warp w's particles in order
#pragma unroll 8
  for (int r = 0; r < kBucketItems; ++r) {
    const int k = lat(r);
    const unsigned g = __match_any_sync(0xffffffffu, k);
    int pos = 0;
    if (k >= 0) pos = start[k] + hist[w * K + k] + __popc(g & ((1u << lane) - 1u));
    __syncwarp();
    if (k >= 0) {
      perm[c0 + pos] = static_cast<int>(c0 + (w * kBucketItems + r) * 32 + lane);
      if (lane == __ffs(g) - 1) hist[w * K + k] += __popc(g);
    }
    __syncwarp();
  }
}

// The bucket kernel on stream s, a block a chunk: perm and the slots into
// scratch, transform_scratch_words(N, K) int32, 16-byte aligned (perm, then
// the slots).  Its error, or cudaErrorInvalidValue past its limits.
template <typename Latents>
int launch_buckets(const Latents& latents, int* scratch, long long N, int K, cudaStream_t s) {
  const size_t bsmem = bucket_smem_bytes(K);
  if (K < 1 || N < 1 || N > 0x7fffffffLL || bsmem > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = transform_bucket_kernel<Latents>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bsmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<int>((N + kBucketChunk - 1) / kBucketChunk), kBucketThreads, bsmem, s>>>(
      latents, scratch, reinterpret_cast<int4*>(scratch + (N + 3) / 4 * 4), N, K);
  return static_cast<int>(cudaGetLastError());
}

// the scale of particle n, drawn in component k's tile: given, scale (N,)
// (fused_transform) ...
struct GivenScales {
  const float* scale;
  __device__ float operator()(int, long long n) const { return __ldg(scale + n); }
};

// ... or drawn (fused_transform_rng, fused_propose_logq): for a Student-t
// mixture student_t_scale(dof_k) from the stream (key, n) at its word
// normal_words_end(OFF, D), after the normals (draw_component's), else 1
template <int OFF, typename Key>
struct DrawnScales {
  Key key;
  const float* dof;
  int D;
  bool student_t;
  __device__ float operator()(int k, long long n) const {
    if (!student_t) return 1.0f;
    PhiloxT<Key> r(key, static_cast<uint64_t>(n));
    r.seek(normal_words_end(OFF, D));
    return student_t_scale(__ldg(dof + k), r);
  }
};

// The draws' row-tile epilogue: x_i = fmaf(scale_n, s, mu_k[i]) to particle
// n's column of xT, for the thread's rows below D and its tile columns that
// hold a particle (affine_transform's last FMA).  A tile's particles and
// their scales are kept in shared memory (two tiles' worth, the next
// written while the last is computed), the scales taken once a particle;
// with ``latent``, each particle's component is written there too.
template <typename Scales>
struct StoreEpi {
  int* cols;       // 2 x kTileP
  float* scales;   // 2 x kTileP
  const float* mu;
  float* xT;
  int* latent;     // null, or (N,)
  long long N;
  int D;
  Scales scale_of;
  template <typename Src, typename Tile>
  __device__ void tile(const Src& src, long long t, const Tile& tile, int q) {
    if (threadIdx.x >= kTileP) return;
    const long long n = src.col(t, tile);
    const int k = src.k0(tile), at = (q & 1) * kTileP + threadIdx.x;
    cols[at] = static_cast<int>(n);
    scales[at] = n >= 0 ? scale_of(k, n) : 0.0f;
    if (latent != nullptr && n >= 0) latent[n] = k;
  }
  template <typename Src, typename Step>
  __device__ void row_end(const Src&, const Step& s, int q, float (&acc)[8][8], int ty, int tx) {
    const int* c = cols + (q & 1) * kTileP;
    const float* scl = scales + (q & 1) * kTileP;
    int n[8];
    float sc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      n[j] = c[tile_col(tx, j)];
      sc[j] = scl[tile_col(tx, j)];
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = tile_row(s.rt, ty, r);
      if (i < D) {
        const float m = __ldg(mu + static_cast<long long>(s.k) * D + i);
        float* row = xT + static_cast<long long>(i) * N;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (n[j] >= 0) row[n[j]] = fmaf(sc[j], acc[r][j], m);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[r][j] = 0.0f;
    }
  }
  template <typename Src, typename Step>
  __device__ void k_end(const Src&, const Step&, int) {}
};
// where the epilogue's particles and scales start in a tiled block's
// shared memory: the partials' place
constexpr int kStoreColsOffset = kTileRedOffset;
constexpr int kStoreScalesOffset = kTileRedOffset + 2 * kTileP;
static_assert(4 * kTileP <= kTileRedFloats, "the particles and scales of two tiles");

// the smallest D at which fused_transform_rng and fused_propose_logq take
// their drawn tiled products (ops/_build.py DRAW_TILED_D_MIN): the first
// past the record kernels' 64
constexpr int kDrawTiledDMin = 65;
static_assert(kDrawTiledDMin > kRecDMax && kDrawTiledDMin <= kDMax + 1,
              "the record kernel to 64, the looped kernel forced to kDMax");
constexpr int kDrawTiled = 2;   // DrawPlan::variant of the draws' tiled products

// shared memory of a drawn product's block at D: the tiled engine's, and
// past kTileM row tile 0's panels
__host__ __device__ inline size_t draw_tiled_smem(int D) {
  return kTiledSmem + (D > kTileM ? sizeof(float) * kDrawCacheFloats : 0);
}

template <bool SEED_PTR>
using SeedKey = std::conditional_t<SEED_PTR, SharedKey, ValueKey>;

// the streams' key of a launch's seed: by value the kernel parameters, from
// a seed tensor the words in shared memory (store_seed_key, then a barrier)
template <bool SEED_PTR>
__device__ __forceinline__ SeedKey<SEED_PTR> seed_key_of(Seed seed) {
  if constexpr (SEED_PTR) return {};
  else return {seed.s0, seed.s1};
}

// The drawn product: for each tile of ``src`` (BucketTiles of the
// components' buckets, or ParticleTiles at K = 1), x = mu_k + scale (L_k z)
// with z drawn by DrawnX from each particle's stream after its first OFF
// words (0: draw_component's, fused_transform_rng; 1: propose_particle's,
// word 0 the component's uniform, fused_propose_logq) and the scale by
// DrawnScales; latent (null: not written) gets each particle's component.
// mu (K, D), L (K, D, D) lower triangular, dof (K).  Shared memory:
// draw_tiled_smem(D).
template <int OFF, bool SEED_PTR, typename Source>
__global__ void __launch_bounds__(kTileThreads, 2)
draw_tiled_kernel(const Seed seed, const float* __restrict__ mu, const float* __restrict__ L,
                  const float* __restrict__ dof, const Source src, float* __restrict__ xT,
                  int* __restrict__ latent, long long N, int D, int student_t) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  if constexpr (SEED_PTR) {
    if (threadIdx.x == 0) store_seed_key(seed);
    __syncthreads();
  }
  const SeedKey<SEED_PTR> key = seed_key_of<SEED_PTR>(seed);
  const DrawnX<OFF, SeedKey<SEED_PTR>> xsrc{
      key, D > kTileM ? smem + kTiledSmem / sizeof(float) : nullptr};
  StoreEpi<DrawnScales<OFF, SeedKey<SEED_PTR>>> epi{
      reinterpret_cast<int*>(smem + kStoreColsOffset), smem + kStoreScalesOffset, mu, xT, latent,
      N, D, {key, dof, D, student_t != 0}};
  tiled_walk<true, false>(smem, xsrc, L, nullptr, D, src, epi);
}

// The drawn product on stream s: at K = 1 one launch over ParticleTiles;
// else the bucket kernel on ``latents`` (GivenLatents, DrawnLatents), perm
// and slots into scratch (transform_scratch_words(N, K) int32), then the
// product over BucketTiles, n_blocks blocks.  The error of the first launch
// that fails, or cudaErrorInvalidValue past the limits.
template <int OFF, typename Latents>
int launch_draw_tiled(const Seed& seed, const Latents& latents, const float* mu, const float* L,
                      const float* dof, int* scratch, float* xT, int* latent, long long N, int K,
                      int D, int student_t, int n_blocks, cudaStream_t s) {
  if (D < 1 || D > kWideDMax || K < 1 || N > 0x7fffffffLL || n_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const size_t smem = draw_tiled_smem(D);
  const auto run = [&](auto kernel, const auto& src) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<n_blocks, kTileThreads, smem, s>>>(seed, mu, L, dof, src, xT, latent, N, D,
                                                student_t);
    return static_cast<int>(cudaGetLastError());
  };
  if (K == 1) {
    const ParticleTiles src{N, 1};
    return seed.words == nullptr ? run(draw_tiled_kernel<OFF, false, ParticleTiles>, src)
                                 : run(draw_tiled_kernel<OFF, true, ParticleTiles>, src);
  }
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int err = launch_buckets(latents, scratch, N, K, s);
  if (err != 0) return err;
  const BucketTiles src{reinterpret_cast<const int4*>(scratch + (N + 3) / 4 * 4), scratch,
                        bucket_slots(N, K)};
  return seed.words == nullptr ? run(draw_tiled_kernel<OFF, false, BucketTiles>, src)
                               : run(draw_tiled_kernel<OFF, true, BucketTiles>, src);
}

// blocks of the drawn product (words after the first OFF) that fit on one
// SM at once at D (ptxas -v on sm_90a: 127-128 registers each instantiation);
// -1 on an error
template <int OFF>
int draw_tiled_per_sm(int D) {
  const auto kernel = draw_tiled_kernel<OFF, false, BucketTiles>;
  const size_t smem = draw_tiled_smem(D);
  int n = 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kTileThreads, smem);
  return err == cudaSuccess ? n : -1;
}

}  // namespace pmc
