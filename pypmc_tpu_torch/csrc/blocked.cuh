// The statistics pass of the K-blocked kernels (pmc_stats_blocked.cu,
// is_pmc_step_blocked.cu, vb_estep_blocked.cu): the statistics of stats.cuh
// for mixtures whose tile of K D + 3 K + 3 rows does not fit a block's shared
// memory.
//
// A first launch writes each particle's normalizer to device memory (log q
// for PMC, the unweighted log-sum-exp for VB: one float a particle), so the
// responsibilities need no second look at the other components.  Then the
// statistics pass walks the component axis in chunks of kc components, each
// chunk the tile and accumulators of stats.cuh for kc components.  The grid
// is (particle blocks, chunks); block (b, c) adds chunk c's entries over the
// tiles of particle block b and writes them into row b of the (n_blocks, S)
// float64 partials at the chunk's offset, chunk 0 also the three global
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
// A block stages its chunk in shared memory when one component's operands
// fit beside the tile (OPS_SMEM), and reads it from device memory otherwise.
// kc is the largest chunk whose shared memory lets two blocks share an SM,
// or one where a single component needs more (blocked_plan, mirrored by
// ops/_build.py blocked_plan).
#pragma once

#include "stats.cuh"

namespace pmc {

enum BlockedKind { kBlockedPmc = 0, kBlockedStep = 1, kBlockedVb = 2 };

// an SM's 228 KB, halved, less the 1 KB each block reserves
constexpr size_t kBlockedHalf = 228 * 1024 / 2 - 1024;

// operand floats of one component in the chunk layout
__host__ __device__ inline int blocked_floats(int D, bool vb) {
  return vb ? D * D + D + 1 : MixLayout{1, D}.eval_size();
}

struct BlockedPlan {
  int kc;          // components a chunk
  bool ops_smem;   // the chunk's operands staged in shared memory
  size_t smem;     // shared memory a block of the statistics pass asks for
};

inline BlockedPlan blocked_plan(int K, int D, bool vb) {
  const int per = blocked_floats(D, vb);
  const bool staged = stats_smem_bytes(StatsLayout{1, D}, per) <= kSmemLimit;
  const int f = staged ? per : 0;
  auto bytes = [&](int kc) { return stats_smem_bytes(StatsLayout{kc, D}, kc * f); };
  const size_t budget = bytes(1) <= kBlockedHalf ? kBlockedHalf : kSmemLimit;
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
    stats_accumulate(S, tile, acc, table);
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
  PMC_DISPATCH_D(D, PMC_DISPATCH_OPS(plan.ops_smem, {
    cudaFuncSetAttribute(blocked_stats_kernel<DMAX, OPS_SMEM, KIND>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(plan.smem));
    blocked_stats_kernel<DMAX, OPS_SMEM, KIND><<<grid, kThreads, plan.smem, s>>>(
        xT, wts, norm, lp, chunks, partial, N, K, D, kc, student_t, dof_stats);
  }));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int P = StatsLayout{K, D}.per_component();
  launch_reduce(partial, stats, n_blocks, K * P + 3, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pmc
