// The statistics pass of the K-blocked kernels (pmc_stats_blocked.cu,
// is_pmc_step_blocked.cu, vb_estep_blocked.cu): the statistics of stats.cuh
// for mixtures whose tile of K D + 3 K + 3 rows does not fit a block's shared
// memory.
//
// A first launch writes each particle's normalizer to device memory (log q
// for PMC, the unweighted log-sum-exp for VB: one float a particle), so the
// responsibilities need no second look at the other components.  Then the
// statistics pass walks the component axis in chunks of kc components.  The
// grid is (particle blocks, chunks); block (b, c) adds chunk c's entries over
// the tiles of particle block b and writes them into row b of the (n_blocks,
// S) float64 partials at the chunk's offset, chunk 0 also the three global
// entries.  Every entry of a row is written by one block, and
// reduce_partials sums the rows in block order: no float atomics, so a seed
// gives the same statistics on every run.  The (K, N) matrices are never
// formed.
//
// The operands come chunk-major from the wrapper: chunk c (kca = min(kc, K -
// c kc) components) at offset c kc F, with F the operand floats of one
// component, laid out as a kca-component mixture:
//   PMC and step: MixLayout{kca, D}'s evaluation part (mu | U | log_norm |
//                 weights | dof | psi);
//   VB:           A (kca, D, D) | m (kca, D) | c (kca).
//
// Two designs, by D (blocked_plan, mirrored by ops/_build.py blocked_plan):
//
// D <= 16, blocked_reg_stats_kernel: the register pass of reg_stats.cuh
// with 8 column slices.  The chunk's operands are staged as 16-byte
// component records (common.cuh stage_records).  In phase 1 each particle of
// the 64-particle tile has two threads, each evaluating half of the chunk's
// components and writing, per component, its D + 3 rows of the tile.  At
// D <= 10 a chunk has 16 components (one band), at 11 <= D <= 16 4 components
// (three bands, a warp each): a chunk is one group of the block's pairs, so
// the accumulators stay in registers from flush to flush.
//
// D > 16, blocked_stats_kernel: the tile, entry table and accumulation of
// stats.cuh for kc components; a block stages its chunk in shared memory when
// one component's operands fit beside the tile (OPS_SMEM), and reads it from
// device memory otherwise.  kc is the largest chunk whose shared memory lets
// two blocks share an SM, or one where a single component needs more.
#pragma once

#include <type_traits>

#include "reg_stats.cuh"

namespace pmc {

enum BlockedKind { kBlockedPmc = 0, kBlockedStep = 1, kBlockedVb = 2 };

// operand floats of one component in the chunk layout
__host__ __device__ inline int blocked_floats(int D, bool vb) {
  return vb ? D * D + D + 1 : MixLayout{1, D}.eval_size();
}

struct BlockedPlan {
  int kc;          // components a chunk
  bool ops_smem;   // the chunk's operands staged in shared memory
  size_t smem;     // shared memory a block of the statistics pass asks for
};

// ---- the register pass (D <= 16) ----
constexpr int kRegGroups = kThreads / kRegCols;     // threads a particle in phase 1

// components a chunk: one group of the block's pairs at 8 slices
__host__ __device__ inline int reg_chunk(int D) { return reg_per_group(D, kRegSlices); }
__host__ __device__ inline int reg_rec_floats(int D, bool vb) {
  return vb ? vb_rec_floats(D) : rec_floats(D);
}
// floats of the tile, which the flush's slice sums (8 per entry) and the
// global entries' per-particle sums reuse
__host__ __device__ inline size_t reg_region(int kc, int D) {
  const size_t P = StatsLayout{1, D}.per_component();
  const size_t tile = static_cast<size_t>(kc) * reg_rows(D) * reg_stride(D, kRegSlices);
  const size_t scratch = kRegSlices * kc * P + 3 * kRegCols;
  return tile > scratch ? tile : scratch;
}
__host__ __device__ inline size_t reg_acc_offset(int kc, int D, bool vb) {
  const size_t floats = static_cast<size_t>(kc) * reg_rec_floats(D, vb) + reg_region(kc, D);
  return (floats * sizeof(float) + 7) / 8 * 8;
}
__host__ __device__ inline size_t reg_smem_bytes(int kc, int D, bool vb) {
  return reg_acc_offset(kc, D, vb) + StatsLayout{kc, D}.entries() * sizeof(double);
}

inline BlockedPlan blocked_plan(int K, int D, bool vb) {
  if (D <= kRegDMax) {
    const int kc = K < reg_chunk(D) ? K : reg_chunk(D);
    return {kc, true, reg_smem_bytes(kc, D, vb)};
  }
  const int per = blocked_floats(D, vb);
  const bool staged = stats_smem_bytes(StatsLayout{1, D}, per) <= kSmemLimit;
  const int f = staged ? per : 0;
  auto bytes = [&](int kc) { return stats_smem_bytes(StatsLayout{kc, D}, kc * f); };
  const size_t budget = bytes(1) <= kHalfSmem ? kHalfSmem : kSmemLimit;
  int kc = 1;
  while (kc < K && bytes(kc + 1) <= budget) ++kc;
  return {kc, staged, bytes(kc)};
}

// The statistics pass.  xT (D, N); wts (N,) the weights (PMC, VB) or, for
// the step, the output the weights w = exp(log p - log q) are written to (by
// chunk 0); norm (N,) log q (PMC, step) or the VB normalizer; lp (N,) log p
// (step only); chunks the chunk-major operands; partial (n_blocks, S) with S
// = K P + 3.
template <int DMAX, bool OPS_SMEM, int KIND>
__global__ void __launch_bounds__(kThreads)
blocked_stats_kernel(const float* __restrict__ xT, float* __restrict__ wts,
                     const float* __restrict__ norm, const float* __restrict__ lp,
                     const float* __restrict__ chunks, double* __restrict__ partial,
                     long long N, int K, int D, int kc, int student_t,
                     int dof_stats) {
  constexpr bool vb = KIND == kBlockedVb;
  extern __shared__ float smem[];
  const int chunk = blockIdx.y;
  const int k0 = chunk * kc;
  const int kca = min(kc, K - k0);
  const StatsLayout S{kca, D};
  const int n_ops = kca * blocked_floats(D, vb);
  const int n_staged = OPS_SMEM ? n_ops : 0;
  float* tile = smem + n_staged;
  double* acc = reinterpret_cast<double*>(
      reinterpret_cast<char*>(smem) + stats_acc_offset(S, n_staged));
  uint16_t* table = reinterpret_cast<uint16_t*>(acc + S.entries());
  const float* ops = stage_operands<OPS_SMEM>(
      smem, chunks + static_cast<long long>(k0) * blocked_floats(D, vb), n_ops);
  stats_setup(S, tile, acc, table);
  __syncthreads();
  const MixLayout L{kca, D};

  const int t = threadIdx.x;
  const long long n_tiles = (N + kThreads - 1) / kThreads;
  for (long long tile_i = blockIdx.x; tile_i < n_tiles; tile_i += gridDim.x) {
    const long long n = tile_i * kThreads + t;
    const bool live = n < N;
    float x[DMAX];
    if (live) {
      load_particle<DMAX>(xT, N, n, D, x);
    } else {
#pragma unroll
      for (int i = 0; i < dim_loop<DMAX>(D); ++i) x[i] = 0.0f;
    }
    float diff[DMAX];
    if (vb) {
      const float* A = ops;
      const float* m = A + kca * D * D;
      const float* c = m + kca * D;
      const float w = live ? wts[n] : 0.0f;
      const float l = live ? norm[n] : 0.0f;
      for (int j = 0; j < kca; ++j) {
        const float maha = project<DMAX>(A + j * D * D, m + j * D, x, D, diff);
#pragma unroll
        for (int i = 0; i < dim_loop<DMAX>(D); ++i)
          if (i < D) tile[(S.diff() + j * D + i) * kTileStride + t] = diff[i];
        const float log_r = c[j] - 0.5f * maha - l;
        const float wr = live ? w * expf(log_r) : 0.0f;
        tile[(S.wrho() + j) * kTileStride + t] = wr;
        tile[(S.c() + j) * kTileStride + t] = wr;
        tile[(S.t1() + j) * kTileStride + t] = live ? wr * log_r : 0.0f;
      }
      tile[S.w() * kTileStride + t] = w;
      tile[S.wlogw() * kTileStride + t] = w > 0.0f ? w * logf(w) : 0.0f;
    } else {
      // past N: log q = +inf makes every responsibility exactly 0
      float log_q = INFINITY, w = 0.0f;
      if (live) {
        log_q = norm[n];
        if (KIND == kBlockedStep) {
          w = expf(lp[n] - log_q);
          if (chunk == 0) wts[n] = w;
        } else {
          w = wts[n];
        }
      }
      for (int j = 0; j < kca; ++j) {
        const float maha = whiten<DMAX>(ops + L.U() + j * D * D, ops + L.mu() + j * D,
                                        x, D, diff);
#pragma unroll
        for (int i = 0; i < dim_loop<DMAX>(D); ++i)
          if (i < D) tile[(S.diff() + j * D + i) * kTileStride + t] = diff[i];
        tile[(S.c() + j) * kTileStride + t] = maha;
        tile[(S.wrho() + j) * kTileStride + t] =
            component_logpdf(maha, ops[L.ln() + j], ops[L.dof() + j], D, student_t != 0);
      }
      stats_finish(ops, S, student_t != 0, dof_stats != 0, log_q, w, tile, t);
    }
    __syncthreads();
    stats_accumulate<kThreads>(S, tile, acc, table);
    __syncthreads();
  }

  // this chunk's entries at its offset in the block's row; the three global
  // entries from chunk 0
  const int P = S.per_component();
  double* row = partial + static_cast<long long>(blockIdx.x) * (K * P + 3);
  for (int e = threadIdx.x; e < S.entries(); e += blockDim.x) {
    if (e < kca * P) row[k0 * P + e] = acc[e];
    else if (chunk == 0) row[K * P + e - kca * P] = acc[e];
  }
}

// The statistics pass for D <= 16 (DMAX 8 or 16): xT (D, N); wts (N,) the
// weights (PMC, VB) or, for the step, the output the weights w = exp(log p -
// log q) are written to (by chunk 0); norm (N,) log q (PMC, step) or the VB
// normalizer; lp (N,) log p (step only); chunks the chunk-major operands;
// partial (n_blocks, S) with S = K P + 3.
template <int DMAX, int KIND>
__global__ void __launch_bounds__(kThreads, DMAX <= 8 ? 4 : 3)
blocked_reg_stats_kernel(const float* __restrict__ xT, float* __restrict__ wts,
                         const float* __restrict__ norm, const float* __restrict__ lp,
                         const float* __restrict__ chunks, double* __restrict__ partial,
                         long long N, int K, int D, int kc, int student_t, int dof_stats) {
  constexpr bool vb = KIND == kBlockedVb;
  using Bands = RegBands<DMAX>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int chunk = blockIdx.y;
  const int k0 = chunk * kc;
  const int kca = min(kc, K - k0);
  const int P = StatsLayout{1, D}.per_component();
  const int F = reg_rec_floats(D, vb);
  const int D4 = pad4(D);
  const int ts = reg_stride(D, kRegSlices);
  const int comp_floats = reg_rows(D) * ts;
  float* recs = smem;
  float* tile = smem + kc * F;      // also the flush's scratch
  double* acc = reinterpret_cast<double*>(reinterpret_cast<char*>(smem) +
                                          reg_acc_offset(kc, D, vb));
  const float* src = chunks + static_cast<long long>(k0) * blocked_floats(D, vb);
  if (vb) stage_vb_records(recs, src, kca, D);
  else stage_records(recs, src, kca, D);
  for (int e = threadIdx.x; e < kca * P + 3; e += blockDim.x) acc[e] = 0.0;
  __syncthreads();

  const int t = threadIdx.x;
  // phase 1: particle column p, components grp, grp + kRegGroups, ...
  const int p = t % kRegCols, grp = t / kRegCols;
  // phase 2: (component jc, band) and column slice
  const int slice = t % kRegSlices, pair = t / kRegSlices;
  const int per_band = reg_chunk(D);
  const int band = pair / per_band, jc = pair % per_band;
  const bool owner = jc < kca && band < reg_bands(D);
  const float* my_rows = tile + jc * comp_floats + slice;

  float a[Bands::NA];
#pragma unroll
  for (int e = 0; e < Bands::NA; ++e) a[e] = 0.0f;
  float sw = 0.0f, sw2 = 0.0f, swlogw = 0.0f;   // this column's particles (grp 0)

  const long long n_tiles = (N + kRegCols - 1) / kRegCols;
  const int E = kc * P;   // a slice's row of the scratch
  int since = 0;
  for (long long tile_i = blockIdx.x;; tile_i += gridDim.x) {
    const bool more = tile_i < n_tiles;
    if (more) {
      const long long n = tile_i * kRegCols + p;
      const bool live = n < N;
      float x[DMAX];
      if (live) {
        load_particle<DMAX>(xT, N, n, D, x);
      } else {
#pragma unroll
        for (int i = 0; i < DMAX; ++i) x[i] = 0.0f;
      }
      float w = 0.0f, l = 0.0f;
      // past N: log q = +inf makes every responsibility exactly 0
      float log_q = INFINITY;
      if (live) {
        if (vb) {
          w = wts[n];
          l = norm[n];
        } else {
          log_q = norm[n];
          if (KIND == kBlockedStep) {
            w = expf(lp[n] - log_q);
            if (chunk == 0 && grp == 0) wts[n] = w;
          } else {
            w = wts[n];
          }
        }
      }
      if (grp == 0) {
        sw += w;
        sw2 += w * w;
        swlogw += w > 0.0f ? w * logf(w) : 0.0f;
      }
      for (int j = grp; j < kca; j += kRegGroups) {
        const float* r = recs + j * F;
        float* out = tile + j * comp_floats + p;
        const auto emit = [&](int i, float d) { out[i * ts] = d; };
        float wrho, c, t1;
        if (vb) {
          const float maha = project_rec<DMAX>(r, x, D, emit);
          const float log_r = r[D4] - 0.5f * maha - l;
          wrho = live ? w * expf(log_r) : 0.0f;
          c = wrho;
          t1 = live ? wrho * log_r : 0.0f;
        } else {
          const float maha = whiten_rec<DMAX>(r, x, D, emit);
          // ln, w, nu, log(nu / 2) - psi
          const float4 q = *reinterpret_cast<const float4*>(r + D4);
          float ind = q.x - 0.5f * maha, gamma = 1.0f, l1p = 0.0f;
          if (student_t) {
            // component_logpdf's log1p, reused for t1's log((maha + nu) / 2)
            // = log1p(maha / nu) + log(nu / 2); the divisions to 2 ulp
            l1p = log1pf(__fdividef(maha, q.z));
            ind = q.x - 0.5f * (q.z + static_cast<float>(D)) * l1p;
            gamma = __fdividef(q.z + static_cast<float>(D), q.z + maha);
          }
          const float rho = q.y > 0.0f ? expf(ind - log_q) * q.y : 0.0f;
          wrho = rho * w;
          t1 = student_t && dof_stats ? wrho * (l1p + q.w + gamma) : 0.0f;
          c = wrho * gamma;
        }
        out[D * ts] = wrho;
        out[(D + 1) * ts] = c;
        out[(D + 2) * ts] = t1;
      }
      __syncthreads();
      if (owner) Bands::accumulate(band, my_rows, ts, D, kRegSlices, kRegCols / kRegSlices, a);
      __syncthreads();
      ++since;
    }
    if (since == kRegFlush || (!more && since > 0)) {
      // the slices' sums to the scratch, then each entry's 8 slices in order
      float* scratch = tile;
      if (owner) Bands::store(band, scratch + slice * E + jc * P, D, a);
      if (grp == 0) {
        scratch[kRegSlices * E + p] = sw;
        scratch[kRegSlices * E + kRegCols + p] = sw2;
        scratch[kRegSlices * E + 2 * kRegCols + p] = swlogw;
        sw = sw2 = swlogw = 0.0f;
      }
      __syncthreads();
      reg_flush(scratch, kRegSlices, E, kca * P, acc, false);
      __syncthreads();
      since = 0;
    }
    if (!more) break;
  }

  double* row = partial + static_cast<long long>(blockIdx.x) * (K * P + 3);
  for (int e = threadIdx.x; e < kca * P + 3; e += blockDim.x) {
    if (e < kca * P) row[k0 * P + e] = acc[e];
    else if (chunk == 0) row[K * P + e - kca * P] = acc[e];
  }
}

// Call body(DMAX, OPS_SMEM) (std::integral_constant arguments) with the
// statistics pass's instantiation for D: the register pass at DMAX 8 or 16
// (its operands always staged), the tile pass at DMAX 32 or 128.
template <typename Body>
int dispatch_blocked(int D, bool ops_smem, Body&& body) {
  using std::integral_constant;
  if (D <= 8) {
    body(integral_constant<int, 8>(), std::true_type());
  } else if (D <= kRegDMax) {
    body(integral_constant<int, 16>(), std::true_type());
  } else if (D <= 32) {
    if (ops_smem) body(integral_constant<int, 32>(), std::true_type());
    else body(integral_constant<int, 32>(), std::false_type());
  } else if (D <= kDMax) {
    if (ops_smem) body(integral_constant<int, kDMax>(), std::true_type());
    else body(integral_constant<int, kDMax>(), std::false_type());
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

// The kernel of the statistics pass for KIND at DMAX, OPS_SMEM.
template <int KIND, int DMAX, bool OPS_SMEM>
inline auto blocked_kernel() {
  if constexpr (DMAX <= kRegDMax) return blocked_reg_stats_kernel<DMAX, KIND>;
  else return blocked_stats_kernel<DMAX, OPS_SMEM, KIND>;
}

// Blocks of the statistics pass that fit on one SM at once (registers,
// shared memory and threads), for the wrapper's grid; -1 on an error.
template <int KIND>
int blocked_stats_per_sm(int K, int D) {
  const BlockedPlan plan = blocked_plan(K, D, KIND == kBlockedVb);
  int n = 0;
  const int err = dispatch_blocked(D, plan.ops_smem, [&](auto dmax, auto ops) {
    const auto kernel = blocked_kernel<KIND, decltype(dmax)::value, decltype(ops)::value>();
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(plan.smem));
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, plan.smem);
  });
  return err == 0 && cudaGetLastError() == cudaSuccess ? n : -1;
}

// Launch the statistics pass and the reduction of its partials into
// ``stats`` (T = float or double).  kc must be blocked_plan's.
template <int KIND, typename T>
int launch_blocked_stats(const float* xT, float* wts, const float* norm,
                         const float* lp, const float* chunks, double* partial,
                         T* stats, long long N, int K, int D, int kc, int student_t,
                         int dof_stats, int n_blocks, cudaStream_t s) {
  const BlockedPlan plan = blocked_plan(K, D, KIND == kBlockedVb);
  if (kc != plan.kc) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_blocks, (K + kc - 1) / kc);
  const int bad = dispatch_blocked(D, plan.ops_smem, [&](auto dmax, auto ops) {
    const auto kernel = blocked_kernel<KIND, decltype(dmax)::value, decltype(ops)::value>();
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(plan.smem));
    kernel<<<grid, kThreads, plan.smem, s>>>(xT, wts, norm, lp, chunks, partial, N, K, D,
                                             kc, student_t, dof_stats);
  });
  if (bad != 0) return bad;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int P = StatsLayout{K, D}.per_component();
  launch_reduce(partial, stats, n_blocks, K * P + 3, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pmc
