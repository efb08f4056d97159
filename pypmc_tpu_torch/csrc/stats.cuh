// PMC sufficient statistics shared by fused_pmc_stats (pmc_stats.cu),
// fused_is_pmc_step (is_pmc_step.cu) and fused_vb_estep (vb_estep.cu): the
// entry-table pass.  Each takes it past D = 16, or where its register pass
// (reg_stats.cuh) does not fit shared memory.
//
// A block walks over tiles of tw particles, one a thread (grid-stride): tw
// = kThreads, or kNarrowTile where that tile and the accumulators do not fit
// shared memory (stats_layout: D = 1 with K >= 109), a template argument of
// the kernels so that the tile's row stride is a constant (instantiated to
// DMAX kNarrowTileDMax only, the reach of the JAX rule).  Phase 1:
// each thread takes one particle and writes, into a shared-memory tile, one
// column of per-particle rows: the whitened differences diff_k = U_k (x -
// mu_k), w rho_k, c_k = w rho_k gamma_k, the dof-condition term, w and
// w log w.  Phase 2: each thread owns a few statistic entries and sums
// a * b * c over the tile's columns, where (a, b, c) are three rows of the
// tile (a row of ones stands in for a missing factor).  Entries per
// component k, in this order (P = 3 + D + D (D + 1) / 2 of them):
//   s0 = sum w rho, s0c = sum c, t1 = sum w rho [log((maha + nu) / 2)
//   - psi + gamma], sd_i = sum c diff_i, g_ij = sum c diff_i diff_j (i >= j,
//   row-major lower triangle)
// followed by three global entries sum w, sum w^2, sum w log w.
//
// The mixture operands sit in front of the tile when they fit (OPS_SMEM, see
// common.cuh).  Only the K diagonal (D, D) blocks of the Gram matrix are
// formed, and of each only its lower triangle.  Every block adds its tiles' sums into
// float64 accumulators in shared memory and writes them to its own row of a
// (n_blocks, S) buffer; reduce_partials then sums the rows in a fixed order.
// No float atomics: a seed gives the same statistics on every run.
#pragma once

#include "common.cuh"

namespace pmc {

constexpr int kTileStride = kThreads + 1;   // padded: rows hit different banks

struct StatsLayout {
  int K, D;
  int tw = kThreads;   // particles a tile (threads a block); rows tw + 1 apart
  __host__ __device__ int stride() const { return tw + 1; }
  // tile rows
  __host__ __device__ int diff() const { return 0; }
  __host__ __device__ int wrho() const { return K * D; }
  __host__ __device__ int c() const { return K * D + K; }
  __host__ __device__ int t1() const { return K * D + 2 * K; }
  __host__ __device__ int w() const { return K * D + 3 * K; }
  __host__ __device__ int wlogw() const { return K * D + 3 * K + 1; }
  __host__ __device__ int ones() const { return K * D + 3 * K + 2; }
  __host__ __device__ int rows() const { return K * D + 3 * K + 3; }
  // statistic entries
  __host__ __device__ int per_component() const { return 3 + D + D * (D + 1) / 2; }
  __host__ __device__ int entries() const { return K * per_component() + 3; }
};

// shared memory of a statistics kernel with ``params`` floats of mixture
// operands in front (must match ops/_build.py smem_bytes)
__host__ __device__ inline size_t stats_acc_offset(const StatsLayout& S,
                                                   int params) {
  const size_t floats = static_cast<size_t>(params) +
                        static_cast<size_t>(S.rows()) * S.stride();
  return (floats * sizeof(float) + 7) / 8 * 8;
}
__host__ __device__ inline size_t stats_smem_bytes(const StatsLayout& S,
                                                   int params) {
  return stats_acc_offset(S, params) + S.entries() * (sizeof(double) + 3 * sizeof(uint16_t));
}
// whether a statistics kernel stages its ``params`` operand floats in shared
// memory: if they fit there beside the tile and the accumulators
inline bool stats_ops_smem(const StatsLayout& S, int params) {
  return stats_smem_bytes(S, params) <= kSmemLimit;
}
// the shared memory its launcher asks for
inline size_t stats_launch_smem(const StatsLayout& S, int params) {
  return stats_smem_bytes(S, stats_ops_smem(S, params) ? params : 0);
}
// The layout of a dense statistics kernel for (K, D), with its tile width
// (ops/_build.py stats_tile): kThreads particles, or half as many where that
// tile and the accumulators alone pass kSmemLimit.
constexpr int kNarrowTile = kThreads / 2;   // the narrow tile's particles
constexpr int kNarrowTileDMax = 8;           // the DMAX it is built for
inline StatsLayout stats_layout(int K, int D) {
  const bool full = stats_smem_bytes(StatsLayout{K, D}, 0) <= kSmemLimit;
  return StatsLayout{K, D, full ? kThreads : kNarrowTile};
}
// whether a statistics kernel is built for the layout's tile at D
inline bool stats_tile_built(const StatsLayout& S, int D) {
  return S.tw == kThreads || D <= kNarrowTileDMax;
}

// Launch ``kernel<DMAX, OPS_SMEM, tw>`` for the layout's tile width through
// launch(kernel).  The narrow tile is built at kNarrowTileDMax only: past
// it the narrow branch names the wide kernel and is never taken (the
// launcher refuses the layout first, stats_tile_built).
#define PMC_STATS_TILE(S, kernel, launch)                                         \
  do {                                                                             \
    constexpr int kNarrow = DMAX == kNarrowTileDMax ? kNarrowTile : kThreads;     \
    if ((S).tw == kThreads)                                                        \
      launch(kernel<DMAX, OPS_SMEM, kThreads>);                                    \
    else                                                                           \
      launch(kernel<DMAX, OPS_SMEM, kNarrow>);                                     \
  } while (0)

// the three tile rows whose product statistic entry e sums
__device__ inline void entry_rows(const StatsLayout& S, int e, uint16_t* out) {
  const int P = S.per_component();
  int a = S.ones(), b = S.ones(), c = S.ones();
  if (e >= S.K * P) {
    const int r = e - S.K * P;
    if (r == 0) a = S.w();
    else if (r == 1) { a = S.w(); b = S.w(); }
    else a = S.wlogw();
  } else {
    const int k = e / P;
    int r = e % P;
    if (r == 0) a = S.wrho() + k;
    else if (r == 1) a = S.c() + k;
    else if (r == 2) a = S.t1() + k;
    else if (r < 3 + S.D) { a = S.c() + k; b = S.diff() + k * S.D + (r - 3); }
    else {
      int q = r - 3 - S.D, i = 0;
      while (q > i) { q -= i + 1; ++i; }
      a = S.c() + k;
      b = S.diff() + k * S.D + i;
      c = S.diff() + k * S.D + q;
    }
  }
  out[0] = static_cast<uint16_t>(a);
  out[1] = static_cast<uint16_t>(b);
  out[2] = static_cast<uint16_t>(c);
}

// Block set-up: entry table, zeroed accumulators and the row of ones.
__device__ inline void stats_setup(const StatsLayout& S, float* tile,
                                   double* acc, uint16_t* table) {
  for (int e = threadIdx.x; e < S.entries(); e += blockDim.x) {
    entry_rows(S, e, table + 3 * e);
    acc[e] = 0.0;
  }
  tile[S.ones() * S.stride() + threadIdx.x] = 1.0f;
}

// Phase 1, first half: proposal evaluation of particle x with the
// whitened differences stored in tile column t; maha and the component
// log-pdfs are parked in the c and wrho rows.  Returns log q(x).
template <int DMAX>
__device__ float stats_evaluate(const float* mix, const StatsLayout& S,
                                bool student_t, const float (&x)[DMAX],
                                float* tile, int t) {
  const int K = S.K, D = S.D, st = S.stride();
  const MixLayout L{K, D};
  WeightedLse lse;
  float diff[DMAX];
  for (int k = 0; k < K; ++k) {
    const float maha = whiten<DMAX>(mix + L.U() + k * D * D,
                                    mix + L.mu() + k * D, x, D, diff);
#pragma unroll
    for (int i = 0; i < dim_loop<DMAX>(D); ++i)
      if (i < D) tile[(S.diff() + k * D + i) * st + t] = diff[i];
    const float ind = component_logpdf(maha, mix[L.ln() + k], mix[L.dof() + k],
                                       D, student_t);
    tile[(S.c() + k) * st + t] = maha;
    tile[(S.wrho() + k) * st + t] = ind;
    lse.add(ind, mix[L.w() + k]);
  }
  return lse.value();
}

// Phase 1, second half: log-space Rao-Blackwellized responsibilities
// rho_k = w_k exp(ind_k - log q) (exactly 0 for a dead component), the
// Student-t gamma, and the per-particle factors of every statistic, for a
// particle of importance weight w (0 for a particle past N).
__device__ inline void stats_finish(const float* mix, const StatsLayout& S,
                                    bool student_t, bool dof_stats, float log_q,
                                    float w, float* tile, int t) {
  const int K = S.K, D = S.D, st = S.stride();
  const MixLayout L{K, D};
  for (int k = 0; k < K; ++k) {
    const float wk = mix[L.w() + k];
    const float maha = tile[(S.c() + k) * st + t];
    const float ind = tile[(S.wrho() + k) * st + t];
    const float rho = wk > 0.0f ? expf(ind - log_q) * wk : 0.0f;
    const float wrho = rho * w;
    float gamma = 1.0f, t1 = 0.0f;
    if (student_t) {
      const float nu = mix[L.dof() + k];
      gamma = (nu + static_cast<float>(D)) / (nu + maha);
      if (dof_stats)
        t1 = wrho * (logf(0.5f * (maha + nu)) - mix[L.psi() + k] + gamma);
    }
    tile[(S.wrho() + k) * st + t] = wrho;
    tile[(S.c() + k) * st + t] = wrho * gamma;
    tile[(S.t1() + k) * st + t] = t1;
  }
  tile[S.w() * st + t] = w;
  tile[S.wlogw() * st + t] = w > 0.0f ? w * logf(w) : 0.0f;
}

// Phase 2: add this tile's column sums into the block's accumulators (S.tw
// == TW).  Call between two __syncthreads().
template <int TW>
__device__ inline void stats_accumulate(const StatsLayout& S, const float* tile,
                                        double* acc, const uint16_t* table) {
  const int st = S.stride();
  for (int e = threadIdx.x; e < S.entries(); e += blockDim.x) {
    const float* a = tile + table[3 * e] * st;
    const float* b = tile + table[3 * e + 1] * st;
    const float* c = tile + table[3 * e + 2] * st;
    float s = 0.0f;
#pragma unroll 8
    for (int t = 0; t < TW; ++t) s = fmaf(a[t] * b[t], c[t], s);
    acc[e] += static_cast<double>(s);
  }
}

__device__ inline void stats_write_partial(const StatsLayout& S,
                                           const double* acc, double* partial) {
  for (int e = threadIdx.x; e < S.entries(); e += blockDim.x)
    partial[static_cast<long long>(blockIdx.x) * S.entries() + e] = acc[e];
}

namespace {

// out[e] = sum over blocks of partial[b, e], in block order (T = float or
// double)
template <typename T>
__global__ void reduce_partials(const double* __restrict__ partial,
                                T* __restrict__ out, int n_blocks, int S) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= S) return;
  double s = 0.0;
  for (int b = 0; b < n_blocks; ++b) s += partial[static_cast<long long>(b) * S + e];
  out[e] = static_cast<T>(s);
}

template <typename T>
inline void launch_reduce(const double* partial, T* out, int n_blocks, int S,
                          cudaStream_t stream) {
  reduce_partials<T><<<(S + 255) / 256, 256, 0, stream>>>(partial, out, n_blocks, S);
}

}  // namespace

}  // namespace pmc
