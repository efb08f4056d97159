// The register statistics pass (D <= 16): the statistics of stats.cuh with
// each thread's entries in float32 registers instead of an entry table.
// Its phase 2 and flush are shared by the K-blocked statistics pass
// (blocked.cuh blocked_reg_stats_kernel) and the dense kernels of
// fused_vb_estep, fused_is_pmc_step and fused_pmc_stats (dense_reg_kernel
// below).
//
// The tile holds kRegCols = 64 particle columns.  Phase 1 writes, per
// component, reg_rows(D) rows of the tile: diff_0 .. diff_{D-1}, w rho,
// c = w rho gamma, t1 (and a pad row where D + 3 is even).  In phase 2 each
// thread owns one (component, row band) pair and one of S column slices
// (columns slice + S m): per column it reads the component's D + 3 values
// once into registers and updates the band's entries (s0, s0c, t1 with band
// 0, then per row i sd_i and g_i0 .. g_ii).  At D <= 10 one band holds every
// row; at 11 <= D <= 16 rows [0, 10), [10, 13) and [13, 16) are three bands,
// a warp each, so that no thread holds more than 68 accumulators and the
// DMAX 16 kernels keep them in registers.  The tile's row stride makes a
// component's rows S banks from the next one's (reg_stride), so the S
// slices of consecutive components cover consecutive banks: a phase-2 load
// of a warp hits 32 banks.  Every kRegFlush tiles (at most 128 columns a
// slice: the float32 span of the dense kernels' entry-table tile) the slices
// write their sums to shared memory and each entry's S slices are added in
// slice order into float64 accumulators.  No float atomics: a seed gives the
// same statistics on every run.
#pragma once

#include "stats.cuh"

namespace pmc {

constexpr int kRegDMax = 16;
constexpr int kRegCols = 64;                        // particles a tile
constexpr int kRegSlices = 8;                       // the K-blocked pass's column slices
constexpr int kRegFlush = 16;                       // tiles between two flushes
constexpr int kRegSplit0 = 10, kRegSplit1 = 13;     // DMAX 16's bands: [0, 10), [10, 13), [13, 16)

__host__ __device__ inline int reg_bands(int D) { return D > kRegSplit0 ? 3 : 1; }
// components a group, the pairs of one band for S slices: one band takes
// the block's kThreads / S pairs, three bands a warp each
__host__ __device__ inline int reg_per_group(int D, int S) {
  return (reg_bands(D) == 1 ? kThreads : 32) / S;
}
// tile rows a component: diff_0 .. diff_{D-1}, w rho, c, t1, made odd
__host__ __device__ inline int reg_rows(int D) { return (D + 3) | 1; }
// tile row stride: reg_rows(D) * stride = S (mod 32), so that a component's
// rows start S banks after the previous component's
__host__ __device__ inline int reg_stride(int D, int S) {
  const int rb = reg_rows(D);
  int inv = 1;
  while ((rb * inv) % 32 != 1) inv += 2;
  return kRegCols + (S * inv) % 32;
}

// index, in a band's accumulators, of row i's sd_i (g_i0 .. g_ii follow);
// band 0 starts with s0, s0c, t1
__host__ __device__ constexpr int band_base(int r0, int i) {
  return (r0 == 0 ? 3 : 0) + (i - r0) * (i + r0 + 3) / 2;
}
// accumulators a thread holds: band 0's, the largest band of its DMAX
template <int DMAX>
__host__ __device__ constexpr int reg_acc_count() {
  return DMAX <= 8 ? band_base(0, 8) : band_base(0, kRegSplit0);
}

// Phase 2: add the columns slice + S m, m < cols, of one component's tile
// rows (``rows`` points at its diff_0 row, column ``slice``; ``ts`` the row
// stride) into the accumulators of rows [R0, R1).
template <int R0, int R1, int NA>
__device__ __forceinline__ void reg_accumulate(const float* rows, int ts, int D, int S, int cols,
                                               float (&a)[NA]) {
#pragma unroll 2
  for (int m = 0; m < cols; ++m) {
    const float* col = rows + m * S;
    float d[R1 > 0 ? R1 : 1];
#pragma unroll
    for (int i = 0; i < R1; ++i) d[i] = i < D ? col[i * ts] : 0.0f;
    const float c = col[(D + 1) * ts];
    if (R0 == 0) {
      a[0] += col[D * ts];
      a[1] += c;
      a[2] += col[(D + 2) * ts];
    }
#pragma unroll
    for (int i = R0; i < R1; ++i) {
      if (i < D) {
        const float cd = c * d[i];
        const int b = band_base(R0, i);
        a[b] += cd;
#pragma unroll
        for (int j = 0; j <= i; ++j) a[b + 1 + j] = fmaf(cd, d[j], a[b + 1 + j]);
      }
    }
  }
}

// A band's sums to the slice's row of the scratch (entries of the component
// at ``out``, in the StatsLayout order), then 0.
template <int R0, int R1, int NA>
__device__ __forceinline__ void reg_store(float* out, int D, float (&a)[NA]) {
  if (R0 == 0) {
    out[0] = a[0];
    out[1] = a[1];
    out[2] = a[2];
  }
#pragma unroll
  for (int i = R0; i < R1; ++i) {
    if (i < D) {
      const int b = band_base(R0, i);
      out[3 + i] = a[b];
#pragma unroll
      for (int j = 0; j <= i; ++j) out[3 + D + i * (i + 1) / 2 + j] = a[b + 1 + j];
    }
  }
#pragma unroll
  for (int e = 0; e < NA; ++e) a[e] = 0.0f;
}

// reg_store's inverse: a band's running sums from the scratch
template <int R0, int R1, int NA>
__device__ __forceinline__ void reg_load(const float* in, int D, float (&a)[NA]) {
  if (R0 == 0) {
    a[0] = in[0];
    a[1] = in[1];
    a[2] = in[2];
  }
#pragma unroll
  for (int i = R0; i < R1; ++i) {
    if (i < D) {
      const int b = band_base(R0, i);
      a[b] = in[3 + i];
#pragma unroll
      for (int j = 0; j <= i; ++j) a[b + 1 + j] = in[3 + D + i * (i + 1) / 2 + j];
    }
  }
}

// The three functions above for band ``band`` of DMAX's bands: rows [0, B0),
// [B0, B1), [B1, DMAX)
template <int DMAX>
struct RegBands {
  static constexpr int B0 = DMAX <= 8 ? DMAX : kRegSplit0;
  static constexpr int B1 = DMAX <= 8 ? DMAX : kRegSplit1;
  static constexpr int NA = reg_acc_count<DMAX>();
  static_assert(band_base(B0, B1) <= NA && band_base(B1, DMAX) <= NA, "a band past NA");

  __device__ static __forceinline__ void accumulate(int band, const float* rows, int ts, int D,
                                                    int S, int cols, float (&a)[NA]) {
    if (band == 0) reg_accumulate<0, B0>(rows, ts, D, S, cols, a);
    else if (band == 1) reg_accumulate<B0, B1>(rows, ts, D, S, cols, a);
    else reg_accumulate<B1, DMAX>(rows, ts, D, S, cols, a);
  }
  __device__ static __forceinline__ void store(int band, float* out, int D, float (&a)[NA]) {
    if (band == 0) reg_store<0, B0>(out, D, a);
    else if (band == 1) reg_store<B0, B1>(out, D, a);
    else reg_store<B1, DMAX>(out, D, a);
  }
  __device__ static __forceinline__ void load(int band, const float* in, int D, float (&a)[NA]) {
    if (band == 0) reg_load<0, B0>(in, D, a);
    else if (band == 1) reg_load<B0, B1>(in, D, a);
    else reg_load<B1, DMAX>(in, D, a);
  }
};

// The flush, second half (between two __syncthreads()): the S slices' rows
// of the scratch, E floats apart, summed entry by entry in slice order into
// acc[0, n); the three global sums (rows of kRegCols per-particle sums after
// the slices) into acc[n, n + 3).  ``clear``: set the slices' entries to 0
// (where they hold running sums).
__device__ inline void reg_flush(float* scratch, int S, int E, int n, double* acc, bool clear) {
  const int t = threadIdx.x;
  for (int e = t; e < n; e += blockDim.x) {
    double v = 0.0;
    for (int sl = 0; sl < S; ++sl) {
      v += scratch[sl * E + e];
      if (clear) scratch[sl * E + e] = 0.0f;
    }
    acc[e] += v;
  }
  if (t < 3) {
    double v = 0.0;
    for (int q = 0; q < kRegCols; ++q) v += scratch[S * E + t * kRegCols + q];
    acc[n + t] += v;
  }
}

// ---------------------------------------------------------------------
// The dense register kernel of fused_vb_estep (vb_estep.cu),
// fused_is_pmc_step (is_pmc_step.cu) and fused_pmc_stats (pmc_stats.cu) at
// D <= 16: one launch, all K components a block.  Its three modes differ in
// where a particle comes from and how it is evaluated (DenseMode).
//
// A block walks rounds of kThreads particles (grid-stride).  Each thread
// takes one particle of the round: VB and the statistics mode load it and
// its weight; the step draws it (propose_particle's draw: Philox counted by
// the particle index, the component from the tail-sum thresholds, the drawn
// component's mu and L read from device memory), writes it and its
// component, and evaluates the target on it (log p, on the target's records
// as fused_is_pmc_step_blocked's first launch does).  The round's particles
// go to a staging area in shared memory; then each half of the round is a
// tile of kRegCols columns.  Phase 1 takes two threads a particle, lanes l
// and l + 16 of a warp, each evaluating every other component on the
// 16-byte records (whiten_rec, with the Student-t gamma and the t1 bracket;
// VB: project_upper_rec) into the tile's diff rows and parking the
// component's log-density (VB: log rho) in its w rho row.  After a
// __syncwarp() both read the K parked values in ascending k into the
// particle's normalizer (the step and the statistics mode: log q by the
// weighted log-sum-exp, the entry-table kernel's arithmetic in its order;
// VB: the plain log-sum-exp), and each finishes its components' w rho, c
// and t1 rows.  Phase 2 and the flush are those above,
// with S slices chosen from K (dense_slices: one band spreads its K pairs
// over as many of the block's threads as it can, S = 128 / K, 12 at K=10).
// Where the block's pairs take all K components (one group) the
// accumulators stay in registers from flush to flush; where K needs more
// groups, the block walks the groups over the same tile and each pair's
// running sums live in the scratch (a reg_load and a reg_store a group a
// tile).
//
// The plan (dense_plan, mirrored by ops/_build.py dense_plan): the register
// pass at D <= 16 wherever its shared memory fits kSmemLimit; elsewhere the
// launcher takes stats.cuh's entry-table kernel.
// ---------------------------------------------------------------------

// the dense register kernel's modes (pmc_dense_plan's codes): the step
// draws its particles and evaluates the target; VB loads weighted particles
// and projects them on VB records; the statistics mode loads weighted
// particles and evaluates them as the step does
enum DenseMode : int { kDenseStep = 0, kDenseVb = 1, kDenseStats = 2 };

// the slices for K components at D: as many as leave one group of pairs,
// at least kRegSlices; one band takes any count up to kRegCols, three take
// 8, 16 or 32 (a warp a band)
__host__ __device__ inline int dense_slices(int K, int D) {
  if (reg_bands(D) == 1) {
    const int S = kThreads / K;
    return S < kRegSlices ? kRegSlices : S > kRegCols ? kRegCols : S;
  }
  int S = kRegSlices;
  while (S < 32 && K <= reg_per_group(D, 2 * S)) S *= 2;
  return S;
}

struct DenseLayout {
  int K, Kt, D, S;
  int mode;   // DenseMode
  __host__ __device__ bool vb() const { return mode == kDenseVb; }
  __host__ __device__ bool step() const { return mode == kDenseStep; }
  __host__ __device__ int F() const { return vb() ? vb_rec_floats(D) : rec_floats(D); }
  __host__ __device__ int per_group() const { return reg_per_group(D, S); }
  __host__ __device__ int groups() const { return (K + per_group() - 1) / per_group(); }
  // the accumulators stay in registers across tiles
  __host__ __device__ bool resident() const { return groups() == 1; }
  __host__ __device__ int stride() const { return reg_stride(D, S); }
  __host__ __device__ int comp_floats() const { return reg_rows(D) * stride(); }
  __host__ __device__ int P() const { return StatsLayout{1, D}.per_component(); }
  __host__ __device__ int E() const { return K * P(); }
  // float offsets: records (the step: the target's after the proposal's,
  // then the thresholds) | staging (D rows of x, a row of w or log p) | tile
  // | scratch (the tile itself where the accumulators stay in registers)
  __host__ __device__ size_t cumw() const {
    return static_cast<size_t>(K) * F() + (step() ? static_cast<size_t>(Kt) * F() : 0);
  }
  __host__ __device__ size_t stage() const { return cumw() + (step() ? K : 0); }
  __host__ __device__ size_t tile() const {
    return stage() + static_cast<size_t>(D + 1) * kThreads;
  }
  __host__ __device__ size_t tile_floats() const {
    return static_cast<size_t>(K) * comp_floats();
  }
  __host__ __device__ size_t scratch_floats() const {
    return static_cast<size_t>(S) * E() + 3 * kRegCols;
  }
  __host__ __device__ size_t scratch() const {
    return resident() ? tile() : tile() + tile_floats();
  }
  __host__ __device__ size_t acc_bytes() const {
    const size_t end = resident() ? tile() + (tile_floats() > scratch_floats() ? tile_floats()
                                                                                : scratch_floats())
                                  : scratch() + scratch_floats();
    return (end * sizeof(float) + 7) / 8 * 8;
  }
  __host__ __device__ size_t smem() const { return acc_bytes() + (E() + 3) * sizeof(double); }
};

struct DensePlan {
  bool reg;        // the register pass (else stats.cuh's entry table)
  int slices;      // phase 2's column slices
  int groups;      // component groups a tile
  size_t smem;     // shared memory a block asks for
};

// The plan of fused_vb_estep (kDenseVb), fused_is_pmc_step (kDenseStep, Kt
// target components) or fused_pmc_stats (kDenseStats) for (K, D); the
// entry-table pass's shared memory where the register pass is not taken.
inline DensePlan dense_plan(int K, int Kt, int D, int mode) {
  if (D <= kRegDMax) {
    const DenseLayout L{K, Kt, D, dense_slices(K, D), mode};
    if (L.smem() <= kSmemLimit) return {true, L.S, L.groups(), L.smem()};
  }
  const int params = mode == kDenseVb     ? K * D * D + K * D + K
                     : mode == kDenseStep ? MixLayout{K, D}.size() + MixLayout{Kt, D}.eval_size()
                                          : MixLayout{K, D}.eval_size();
  return {false, 0, 0, stats_launch_smem(stats_layout(K, D), params)};
}

// what the dense register kernel reads and writes
struct DenseArgs {
  const float* ops;    // VB: A (K, D, D) | m (K, D) | c (K); else the packed proposal
  const float* tmix;   // the step: the packed target
  float* xT;           // VB, statistics: the particles (D, N); the step: the draw's output
  float* w;            // VB, statistics: the weights; the step: the output w = exp(log p - log q)
  int* latent;         // the step: the drawn components
  double* partial;     // (gridDim.x, K P + 3)
  long long N;
  int K, Kt, D, slices;
  Seed seed;           // the step: the draw's seed words
  int student_t, t_student_t, dof_stats;
};

// project on a VB record whose matrix is upper triangular (A_k = sqrt(nu_k)
// chol(W_k)^T): row i reads columns i .. D - 1 only, D (D + 1) / 2 FMAs, in
// project_rec's order; for a finite x the FMAs it drops add exact zeros, so
// the result is project_rec's bit for bit.  DMAX <= 32.
template <int DMAX, typename Emit>
__device__ __forceinline__ float project_upper_rec(const float* rec, const float (&x)[DMAX],
                                                   int D, Emit&& emit) {
  static_assert(DMAX <= 32 && DMAX % 4 == 0, "records are read by unrolled loops");
  float xm[DMAX];
  centre_rec<DMAX>(rec, x, D, xm);
  const int D4 = pad4(D);
  const float* A = rec + D4 + 4;
  float maha = 0.0f;
#pragma unroll
  for (int i = 0; i < DMAX; ++i) {
    if (i < D) {
      float s = 0.0f;
      const float4* row = reinterpret_cast<const float4*>(A + i * D4);
#pragma unroll
      for (int q = i / 4; q < DMAX / 4; ++q) {
        if (4 * q < D) {
          const float4 u = row[q];
          if (4 * q >= i) s = fmaf(u.x, xm[4 * q], s);
          if (4 * q + 1 >= i && 4 * q + 1 < D) s = fmaf(u.y, xm[4 * q + 1], s);
          if (4 * q + 2 >= i && 4 * q + 2 < D) s = fmaf(u.z, xm[4 * q + 2], s);
          if (4 * q + 3 < D) s = fmaf(u.w, xm[4 * q + 3], s);
        }
      }
      emit(i, s);
      maha = fmaf(s, s, maha);
    }
  }
  return maha;
}

// DMAX 8's VB kernel fits 4 blocks an SM, its step (which keeps the draw's
// state beside the accumulators) 3, as DMAX 16's: ptxas spilled it at 4;
// the statistics mode, whose phase 1 is the step's, takes 3 as the step
template <int DMAX, int MODE>
__global__ void __launch_bounds__(kThreads, DMAX <= 8 && MODE == kDenseVb ? 4 : 3)
dense_reg_kernel(const DenseArgs args) {
  using Bands = RegBands<DMAX>;
  constexpr bool VB = MODE == kDenseVb, STEP = MODE == kDenseStep;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int K = args.K, Kt = args.Kt, D = args.D;
  const DenseLayout lay{K, Kt, D, args.slices, MODE};
  const int S = lay.S, F = lay.F(), D4 = pad4(D), ts = lay.stride();
  const int comp_floats = lay.comp_floats(), P = lay.P(), E = lay.E();
  const int per_group = lay.per_group(), groups = lay.groups();
  const bool resident = lay.resident();
  const bool student_t = args.student_t != 0;
  float* recs = smem;
  float* trecs = smem + static_cast<size_t>(K) * F;
  float* cumw = smem + lay.cumw();
  float* stage = smem + lay.stage();
  float* tile = smem + lay.tile();
  float* scratch = smem + lay.scratch();
  double* acc = reinterpret_cast<double*>(reinterpret_cast<char*>(smem) + lay.acc_bytes());
  if constexpr (VB) {
    stage_vb_records(recs, args.ops, K, D);
  } else {
    stage_records(recs, args.ops, K, D);
  }
  if constexpr (STEP) {
    stage_records(trecs, args.tmix, Kt, D);
    load_to_shared(cumw, args.ops + MixLayout{K, D}.cumw(), K);
    if (threadIdx.x == 0) store_seed_key(args.seed);
  }
  for (int e = threadIdx.x; e < E + 3; e += blockDim.x) acc[e] = 0.0;
  if (!resident)
    for (int e = threadIdx.x; e < S * E; e += blockDim.x) scratch[e] = 0.0f;
  __syncthreads();

  const int t = threadIdx.x, lane = t % 32;
  // phase 1: tile column p, components grp, grp + 2, ...
  const int p = (t / 32) * 16 + lane % 16, grp = lane / 16;
  // phase 2: (component jc of each group, band) and column slice
  const int slice = t % S, pair = t / S;
  const int band = pair / per_group, jc = pair % per_group;
  const bool in_band = band < reg_bands(D);
  const int cols = (kRegCols - slice + S - 1) / S;   // columns slice + S m < kRegCols

  float a[Bands::NA];
#pragma unroll
  for (int e = 0; e < Bands::NA; ++e) a[e] = 0.0f;
  float sw = 0.0f, sw2 = 0.0f, swlogw = 0.0f;   // column p's particles (grp 0)
  int since = 0;
  const auto flush = [&]() {
    if (resident && in_band && jc < K) Bands::store(band, scratch + slice * E + jc * P, D, a);
    if (grp == 0) {
      scratch[S * E + p] = sw;
      scratch[S * E + kRegCols + p] = sw2;
      scratch[S * E + 2 * kRegCols + p] = swlogw;
      sw = sw2 = swlogw = 0.0f;
    }
    __syncthreads();
    reg_flush(scratch, S, E, E, acc, !resident);
    __syncthreads();
    since = 0;
  };

  const long long N = args.N;
  const long long n_rounds = (N + kThreads - 1) / kThreads;
  for (long long round = blockIdx.x; round < n_rounds; round += gridDim.x) {
    {  // this thread's particle of the round to the staging columns
      const long long n = round * kThreads + t;
      float x[DMAX];
#pragma unroll
      for (int i = 0; i < DMAX; ++i) x[i] = 0.0f;
      float v = 0.0f;   // VB, statistics: the weight; the step: log p
      if (n < N) {
        if constexpr (!STEP) {
          load_particle<DMAX>(args.xT, N, n, D, x);
          v = args.w[n];
        } else {
          const MixLayout L{K, D};
          PhiloxT<SharedKey> rng({}, static_cast<uint64_t>(n));
          const float u = rng.uniform();
          int lat = 0;
          for (int k = 0; k < K - 1; ++k) lat += u >= cumw[k] ? 1 : 0;
          draw_component<DMAX>(args.ops + L.mu(), args.ops + L.L(), args.ops + L.dof(), lat,
                               D, student_t, rng, x);
          args.latent[n] = lat;
          store_particle<DMAX>(args.xT, N, n, D, x);
          v = records_logpdf<DMAX>(trecs, Kt, D, args.t_student_t != 0, x);
        }
      }
#pragma unroll
      for (int i = 0; i < DMAX; ++i)
        if (i < D) stage[i * kThreads + t] = x[i];
      stage[D * kThreads + t] = v;
    }
    __syncthreads();

    for (int h = 0; h < kThreads / kRegCols; ++h) {
      const long long base = round * kThreads + h * kRegCols;
      if (base >= N) break;   // the block's last half-round: nothing left
      const int col = h * kRegCols + p;
      const long long n = base + p;
      float x[DMAX];
      if constexpr (MODE != kDenseStats) {
#pragma unroll
        for (int i = 0; i < DMAX; ++i) x[i] = i < D ? stage[i * kThreads + col] : 0.0f;
      }
      const float v = stage[D * kThreads + col];

      for (int j = grp; j < K; j += 2) {
        if constexpr (MODE == kDenseStats) {
          // the particle read again for each component: held across the
          // loop, it spilled the DMAX 16 kernel at 3 blocks an SM (ptxas)
#pragma unroll
          for (int i = 0; i < DMAX; ++i) x[i] = i < D ? stage[i * kThreads + col] : 0.0f;
        }
        const float* r = recs + j * F;
        float* out = tile + j * comp_floats + p;
        const auto emit = [&](int i, float d) { out[i * ts] = d; };
        if constexpr (VB) {
          out[D * ts] = r[D4] - 0.5f * project_upper_rec<DMAX>(r, x, D, emit);
        } else {
          const float maha = whiten_rec<DMAX>(r, x, D, emit);
          // ln, w, nu, log(nu / 2) - psi
          const float4 q = *reinterpret_cast<const float4*>(r + D4);
          out[D * ts] = component_logpdf(maha, q.x, q.z, D, student_t);
          float gamma = 1.0f, bracket = 0.0f;
          if (student_t) {
            // t1's log((maha + nu) / 2) - psi + gamma, as log1p(maha / nu)
            // + log(nu / 2) - psi + gamma
            gamma = (q.z + static_cast<float>(D)) / (q.z + maha);
            bracket = log1pf(maha / q.z) + q.w + gamma;
          }
          out[(D + 1) * ts] = gamma;
          out[(D + 2) * ts] = bracket;
        }
      }
      __syncwarp();
      // the normalizer over every component, k ascending
      WeightedLse lse;
      for (int k = 0; k < K; ++k)
        lse.add(tile[k * comp_floats + D * ts + p], VB ? 1.0f : recs[k * F + D4 + 1]);
      const float l = lse.value();
      float w = v;   // VB, statistics: 0 past N
      if constexpr (STEP) {
        w = n < N ? expf(v - l) : 0.0f;
        if (n < N && grp == 0) args.w[n] = w;
      }
      __syncwarp();
      for (int j = grp; j < K; j += 2) {
        float* out = tile + j * comp_floats + p;
        const float ind = out[D * ts];
        float wrho, c, t1;
        if constexpr (VB) {
          const float log_r = ind - l;
          wrho = w * expf(log_r);
          c = wrho;
          t1 = wrho * log_r;
        } else {
          // rho_k exactly 0 for a dead component
          const float wk = recs[j * F + D4 + 1];
          wrho = (wk > 0.0f ? expf(ind - l) * wk : 0.0f) * w;
          c = wrho * out[(D + 1) * ts];
          t1 = student_t && args.dof_stats ? wrho * out[(D + 2) * ts] : 0.0f;
        }
        out[D * ts] = wrho;
        out[(D + 1) * ts] = c;
        out[(D + 2) * ts] = t1;
      }
      if (grp == 0) {
        sw += w;
        sw2 += w * w;
        swlogw += w > 0.0f ? w * logf(w) : 0.0f;
      }
      __syncthreads();

      for (int g = 0; g < groups; ++g) {
        const int k = g * per_group + jc;
        if (in_band && k < K) {
          float* sums = scratch + slice * E + k * P;
          if (!resident) Bands::load(band, sums, D, a);
          Bands::accumulate(band, tile + k * comp_floats + slice, ts, D, S, cols, a);
          if (!resident) Bands::store(band, sums, D, a);
        }
      }
      __syncthreads();
      if (++since == kRegFlush) flush();
    }
  }
  if (since > 0) flush();
  for (int e = threadIdx.x; e < E + 3; e += blockDim.x)
    args.partial[static_cast<long long>(blockIdx.x) * (E + 3) + e] = acc[e];
}

// The register kernel for D (DMAX 8 or 16).
template <int MODE>
inline auto dense_reg_kernel_for(int D) {
  return D <= 8 ? &dense_reg_kernel<8, MODE> : &dense_reg_kernel<kRegDMax, MODE>;
}

// blocks of the register kernel at D with ``smem`` bytes that fit on one SM
// at once (registers, shared memory and threads); -1 on an error
template <int MODE>
inline int dense_reg_per_sm(int D, size_t smem) {
  const auto kernel = dense_reg_kernel_for<MODE>(D);
  int n = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, smem) != cudaSuccess)
    return -1;
  return n;
}

// Launch the register kernel with ``plan`` (plan.reg) and the reduction of
// its partials into ``stats`` (T = float or double).
template <int MODE, typename T>
inline int launch_dense_reg(DenseArgs args, const DensePlan& plan, T* stats, int n_blocks,
                            cudaStream_t s) {
  args.slices = plan.slices;
  const auto kernel = dense_reg_kernel_for<MODE>(args.D);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(plan.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_blocks, kThreads, plan.smem, s>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int S = args.K * StatsLayout{1, args.D}.per_component() + 3;
  launch_reduce(args.partial, stats, n_blocks, S, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pmc
