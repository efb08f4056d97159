// fused_mcmc_pool: C symmetric-proposal Metropolis chains, n_steps steps
// each, against a Gaussian or Student-t mixture target, in one launch ->
// points (n_steps, D, C), accepts (C,), nan_counts (C,), xf (D, C), ef (C,).
//
// Replaces the Pallas kernel pypmc_tpu/ops/pallas_kernels.py:2293
// (fused_mcmc_pool, body _mcmc_pool_kernel).  The TPU kernel carries a
// chain block's state in VMEM across a sequential step-chunk grid axis;
// here a chain's owner loops over all n_steps itself, so nothing carries
// between blocks.  Per step: D Box-Muller normals, the proposal delta = L_c
// z (the chain's lower Cholesky factor), for a Student-t proposal delta *=
// sqrt(dof / chi2(dof)) with one scalar dof, the target's log-density at
// the proposal, and the accept against u drawn in (0, 1]: accept iff
// log_rho >= log u, so log_rho >= 0 always accepts; a NaN log_rho is
// counted and rejected.  The visited point (after the move) is written
// every step.  The randomness is Philox keyed by the seed and counted by
// (chain, step) -- the normals, then the scale, then u -- so a chain's
// stream depends on neither the block size, nor the number of chains, nor
// the variant below.
//
// Bound on the H100: the output stream, n_steps * D floats a chain (at
// C = 16384, D = 10, 500 steps: 328 MB), against the per-step work of a
// chain -- D (D + 1) / 2 FMAs of the proposal and K_target D (D + 1) / 2 of
// the target -- memory-bound at the pool's large shapes.  The pipeline's
// pool has 32 chains (C = 32, D = 40, a 2-component target, 400 steps): its
// bytes and operations take ~1 us, and its time is the latency of n_steps
// dependent steps (the warp variant, measured on one H100: ~5.3 us a step).
//
// Two variants, elected by pool_variant (C, D):
// - a thread a chain where the chains fill the card, the Cholesky factors
//   in a chain-fastest layout, cholr [(d D + e) C + c], so a warp's loads
//   coalesce and stay L1/L2-resident across steps, and each step's point
//   stored as one coalesced column of points.  Up to D = 64
//   (mcmc_pool_kernel, the record instantiations' DMAX 8, 16, 32, 40, 64)
//   the target's components are 16-byte records in shared memory, read by
//   broadcast LDS.128 (common.cuh records_lse) against the proposal in
//   registers; to DMAX 32 the chain state x stays in registers and L z is
//   unrolled whole, past it x and the proposal sit in a shared-memory
//   column a thread and L z loops over its rows, so that no array outlives
//   its use in registers (no spill, no stack frame).  Past D = 64, or where
//   the records and the columns pass shared memory,
//   mcmc_pool_looped_kernel (DMAX 128: its arrays in local memory) reads the
//   packed operands, staged where they fit.
// - a warp a chain (mcmc_pool_warp_kernel) where the chains are fewer
//   than pool_warp_chains(D) (the pipeline's 32 chains at D = 40 ran on one
//   warp of one SM the other way, ~190,000 clocks a step): one warp a
//   block, so 32 chains
//   take 32 SMs.  Lane d keeps row d of L_c (and row d + 32 past D = 32) in
//   registers for the whole launch (where the target's records do not fit
//   shared memory, the lane reads its rows from device memory each step,
//   and the target's packed operands likewise); the lanes draw the step's
//   Philox blocks
//   (warp.cuh warp_normals: the thread variant's normals) into shared
//   memory, and row d of L z is D FMAs over broadcast reads; lane 0 draws
//   the scale (a rejection loop of variable length) and u, and decides the
//   accept, which every lane applies to its coordinates; the target's
//   components are 16-byte records in shared memory (common.cuh
//   stage_records), each whitened with rows over the lanes and one warp
//   reduction.  What remains is the chain of dependent steps: the normals'
//   Philox and Box-Muller, D FMAs, Kt whitenings of up to D FMAs and 5
//   shuffles each, and lane 0's draws.
#include "warp.cuh"

namespace pmc {

constexpr int kPoolWarpDMax = 64;   // the warp variant's largest D: two rows a lane

// The largest pool the warp variant takes in D dimensions (ops/_build.py
// _POOL_WARP_CHAINS), by the thread variant's record instantiation (DMAX 8,
// 16, 32, 40, 64): where the two variants' times cross on one H100
// (pool_sweep.py, 100 steps, a 2-component target).  The warp variant's
// time grows with the waves of C chains (32 one-warp blocks an SM), the
// thread variant's hardly until its blocks pass the SMs, and its step
// grows with D faster (past DMAX 32 its state sits in shared memory): to
// D = 8 the thread variant is as fast or faster at every C; to D = 64 the
// warp variant at every C measured (65,536).
__host__ __device__ constexpr long long pool_warp_chains(int D) {
  return D <= 8 ? 0 : D <= 16 ? 4096 : D <= 32 ? 8192 : D <= 40 ? 32768
         : D <= kPoolWarpDMax ? (1LL << 62) : 0;
}

// The variant of a pool of C chains in D dimensions (ops/_build.py
// pool_variant): 1, a warp a chain, where C <= pool_warp_chains(D); else 0,
// a thread a chain.
__host__ __device__ constexpr int pool_variant(int C, int D) {
  return C <= pool_warp_chains(D) ? 1 : 0;
}

// Shared memory of the thread variant's record instantiation for D <= 64:
// the target's Kt records and, past DMAX 32, the state's and the proposal's
// columns.  pool_thread_records: whether that instantiation takes the pool
// (else the looped kernel does).
__host__ __device__ inline size_t pool_thread_rec_smem(int Kt, int D) {
  const int dmax = eval_dmax_for(D);
  return sizeof(float) * (static_cast<size_t>(Kt) * rec_floats(D) +
                          (dmax > 32 ? 2 * static_cast<size_t>(dmax) * kThreads : 0));
}
__host__ __device__ inline bool pool_thread_records(int Kt, int D) {
  return D <= kRecDMax && pool_thread_rec_smem(Kt, D) <= kSmemLimit;
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
mcmc_pool_kernel(uint32_t s0, uint32_t s1, const float* __restrict__ x0T,
                 const float* __restrict__ e0, const float* __restrict__ cholr,
                 float dof_prop, const float* __restrict__ tmix,
                 float* __restrict__ points, int* __restrict__ accepts,
                 int* __restrict__ nan_counts, float* __restrict__ xfT,
                 float* __restrict__ ef, int C, int n_steps, int Kt, int D,
                 int student_t_prop, int t_student_t) {
  extern __shared__ float4 smem4[];
  constexpr int below = eval_dmax_below(DMAX);
  __builtin_assume(D > below && D <= DMAX);   // dispatch_records'
  constexpr bool kCols = DMAX > 32;           // x and the proposal in columns
  float* recs = reinterpret_cast<float*>(smem4);
  stage_records(recs, tmix, Kt, D);
  __syncthreads();
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float* xcol = recs + Kt * rec_floats(D) + threadIdx.x;   // x_d at xcol[d kThreads]
  float* pcol = xcol + DMAX * kThreads;

  float x[kCols ? 1 : DMAX];
  if constexpr (kCols) {
    for (int d = 0; d < D; ++d) xcol[d * kThreads] = x0T[static_cast<long long>(d) * C + c];
  } else {
    load_particle<DMAX>(x0T, C, c, D, x);
  }
  float e = e0[c];
  int acc = 0, nans = 0;
  for (int step = 0; step < n_steps; ++step) {
    Philox rng(s0, s1, (static_cast<uint64_t>(step) << 32) | static_cast<uint32_t>(c));
    float z[DMAX], prop[DMAX];
    draw_normals<DMAX>(rng, D, z);
    const float scale = student_t_prop ? student_t_scale(dof_prop, rng) : 1.0f;
    if constexpr (kCols) {
      // row d of L z, j ascending, into the proposal's column
      for (int d = 0; d < D; ++d) {
        const float* Lrow = cholr + static_cast<long long>(d) * D * C + c;
        float s = 0.0f;
#pragma unroll
        for (int j = 0; j < DMAX; ++j)
          if (j <= d) s = fmaf(Lrow[static_cast<long long>(j) * C], z[j], s);
        pcol[d * kThreads] = fmaf(scale, s, xcol[d * kThreads]);
      }
#pragma unroll
      for (int d = 0; d < DMAX; ++d) prop[d] = d < D ? pcol[d * kThreads] : 0.0f;
    } else {
#pragma unroll
      for (int d = 0; d < DMAX; ++d) {
        float s = 0.0f;
        if (d < D) {
#pragma unroll
          for (int j = 0; j <= d; ++j)
            s = fmaf(cholr[(static_cast<long long>(d) * D + j) * C + c], z[j], s);
        }
        prop[d] = d < D ? fmaf(scale, s, x[d]) : 0.0f;
      }
    }
    WeightedLse lse;
    records_lse<DMAX>(lse, recs, Kt, D, t_student_t != 0, prop);
    const float e_prop = lse.value();
    const float log_u = logf(rng.uniform_pos());
    const float log_rho = e_prop - e;
    const bool is_nan = isnan(log_rho);
    if (!is_nan && log_rho >= log_u) {
#pragma unroll
      for (int d = 0; d < DMAX; ++d) {
        if constexpr (kCols) {
          if (d < D) xcol[d * kThreads] = prop[d];
        } else {
          x[d] = prop[d];
        }
      }
      e = e_prop;
      ++acc;
    }
    nans += is_nan ? 1 : 0;
    float* out = points + static_cast<long long>(step) * D * C + c;
    if constexpr (kCols) {
      for (int d = 0; d < D; ++d) out[static_cast<long long>(d) * C] = xcol[d * kThreads];
    } else {
      store_particle<DMAX>(out - c, C, c, D, x);
    }
  }
  if constexpr (kCols) {
    for (int d = 0; d < D; ++d) xfT[static_cast<long long>(d) * C + c] = xcol[d * kThreads];
  } else {
    store_particle<DMAX>(xfT, C, c, D, x);
  }
  ef[c] = e;
  accepts[c] = acc;
  nan_counts[c] = nans;
}

template <bool OPS_SMEM>
__global__ void __launch_bounds__(kThreads)
mcmc_pool_looped_kernel(uint32_t s0, uint32_t s1, const float* __restrict__ x0T,
                        const float* __restrict__ e0, const float* __restrict__ cholr,
                        float dof_prop, const float* __restrict__ tmix_src,
                        float* __restrict__ points, int* __restrict__ accepts,
                        int* __restrict__ nan_counts, float* __restrict__ xfT,
                        float* __restrict__ ef, int C, int n_steps, int Kt, int D,
                        int student_t_prop, int t_student_t) {
  extern __shared__ float smem[];
  const float* tmix = stage_operands<OPS_SMEM>(smem, tmix_src,
                                               MixLayout{Kt, D}.eval_size());
  __syncthreads();
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;

  float x[kDMax], prop[kDMax], z[kDMax];
  load_particle<kDMax>(x0T, C, c, D, x);
  float e = e0[c];
  int acc = 0, nans = 0;
  for (int step = 0; step < n_steps; ++step) {
    Philox rng(s0, s1, (static_cast<uint64_t>(step) << 32) | static_cast<uint32_t>(c));
    draw_normals<kDMax>(rng, D, z);
    const float scale = student_t_prop ? student_t_scale(dof_prop, rng) : 1.0f;
    for (int d = 0; d < D; ++d) {
      float s = 0.0f;
      for (int j = 0; j <= d; ++j)
        s = fmaf(cholr[(static_cast<long long>(d) * D + j) * C + c], z[j], s);
      prop[d] = fmaf(scale, s, x[d]);
    }
    const float e_prop = mixture_logpdf<kDMax>(tmix, Kt, D, t_student_t != 0, prop);
    const float log_u = logf(rng.uniform_pos());
    const float log_rho = e_prop - e;
    const bool is_nan = isnan(log_rho);
    if (!is_nan && log_rho >= log_u) {
      for (int d = 0; d < D; ++d) x[d] = prop[d];
      e = e_prop;
      ++acc;
    }
    nans += is_nan ? 1 : 0;
    store_particle<kDMax>(points + static_cast<long long>(step) * D * C, C, c, D, x);
  }
  store_particle<kDMax>(xfT, C, c, D, x);
  ef[c] = e;
  accepts[c] = acc;
  nan_counts[c] = nans;
}

// the warp variant's shared memory: the target's Kt records (staged) and
// three slices of D + 8 floats (the Philox words, then x - mu; the normals;
// the proposal)
__host__ __device__ inline size_t pool_warp_smem(int Kt, int D, bool staged) {
  return sizeof(float) * ((staged ? static_cast<size_t>(Kt) * rec_floats(D) : 0) +
                          3 * (static_cast<size_t>(D) + 8));
}
// whether the warp variant stages the target's records
__host__ __device__ inline bool pool_warp_staged(int Kt, int D) {
  return pool_warp_smem(Kt, D, true) <= kSmemLimit;
}

// DMAX 32 (one row a lane) or 64 (two); OPS_SMEM: the target's records in
// shared memory and the lane's rows of L_c in registers, else the target's
// packed operands and L_c read from device memory each step
template <int DMAX, bool OPS_SMEM>
__global__ void __launch_bounds__(32)
mcmc_pool_warp_kernel(uint32_t s0, uint32_t s1, const float* __restrict__ x0T,
                      const float* __restrict__ e0, const float* __restrict__ cholr,
                      float dof_prop, const float* __restrict__ tmix,
                      float* __restrict__ points, int* __restrict__ accepts,
                      int* __restrict__ nan_counts, float* __restrict__ xfT,
                      float* __restrict__ ef, int C, int n_steps, int Kt, int D,
                      int student_t_prop, int t_student_t) {
  static_assert(DMAX == 32 || DMAX == 64, "one or two rows a lane");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int F = rec_floats(D), D4 = pad4(D);
  float* recs = smem;
  float* slices = smem + (OPS_SMEM ? Kt * F : 0);
  const int S = D + 8;
  uint32_t* words = reinterpret_cast<uint32_t*>(slices);
  float* xm = slices;           // the words' slice, free once the normals are drawn
  float* z = slices + S;
  float* prop = slices + 2 * S;
  if (OPS_SMEM) {
    stage_records(recs, tmix, Kt, D);
    __syncthreads();
  }
  const MixLayout TL{Kt, D};
  const int c = blockIdx.x, lane = threadIdx.x;
  const int d1 = lane + 32;     // the lane's second row (DMAX 64)
  const bool has0 = lane < D, has1 = DMAX > 32 && d1 < D;

  // rows lane and lane + 32 of L_c, entries above the diagonal 0
  const float* Lr0 = cholr + static_cast<long long>(lane) * D * C + c;   // L[lane, j] at Lr0[j C]
  const float* Lr1 = cholr + static_cast<long long>(d1) * D * C + c;
  constexpr int R0 = OPS_SMEM ? 32 : 1, R1 = OPS_SMEM && DMAX > 32 ? DMAX : 1;
  float L0[R0], L1[R1];
  if constexpr (OPS_SMEM) {
#pragma unroll
    for (int j = 0; j < R0; ++j)
      L0[j] = has0 && j <= lane ? Lr0[static_cast<long long>(j) * C] : 0.0f;
#pragma unroll
    for (int j = 0; j < R1; ++j)
      L1[j] = has1 && j <= d1 ? Lr1[static_cast<long long>(j) * C] : 0.0f;
  }
  float x0 = has0 ? x0T[static_cast<long long>(lane) * C + c] : 0.0f;
  float x1 = has1 ? x0T[static_cast<long long>(d1) * C + c] : 0.0f;
  float e = e0[c];
  int acc = 0, nans = 0;

  for (int step = 0; step < n_steps; ++step) {
    const uint64_t ctr = (static_cast<uint64_t>(step) << 32) | static_cast<uint32_t>(c);
    warp_normals(s0, s1, ctr, 0, D, words, z);
    float scale = 1.0f, log_u = 0.0f;
    if (lane == 0) {
      Philox rng = stream_at(s0, s1, ctr, normal_words_end(0, D));
      if (student_t_prop) scale = student_t_scale(dof_prop, rng);
      log_u = logf(rng.uniform_pos());
    }
    scale = from_lane0(scale);

    // the proposal: row d of L z, FMA order j ascending (the thread variant's)
    float s = 0.0f, s1v = 0.0f;
    if constexpr (OPS_SMEM) {
#pragma unroll
      for (int j = 0; j < 32; ++j)
        if (has0 && j <= lane) s = fmaf(L0[j], z[j], s);
#pragma unroll
      for (int j = 0; j < R1; ++j)
        if (has1 && j <= d1) s1v = fmaf(L1[j], z[j], s1v);
    } else {
      for (int j = 0; has0 && j <= lane; ++j) s = fmaf(Lr0[static_cast<long long>(j) * C], z[j], s);
      for (int j = 0; has1 && j <= d1; ++j) s1v = fmaf(Lr1[static_cast<long long>(j) * C], z[j], s1v);
    }
    const float p0 = fmaf(scale, s, x0);
    const float p1 = fmaf(scale, s1v, x1);
    if (has0) prop[lane] = p0;
    if (has1) prop[d1] = p1;
    __syncwarp();

    // the target's log-density at the proposal
    WeightedLse lse;
    for (int k = 0; k < Kt; ++k) {
      float maha, ln, w, dof;
      if (OPS_SMEM) {
        const float* r = recs + k * F;
        maha = warp_maha([&](int i) { return r + D4 + 4 + tri_row(i); }, r, prop, xm, D, true);
        const float4 p = *reinterpret_cast<const float4*>(r + D4);
        ln = p.x;
        w = p.y;
        dof = p.z;
      } else {
        const float* U = tmix + TL.U() + static_cast<long long>(k) * D * D;
        maha = warp_maha([&](int i) { return U + static_cast<long long>(i) * D; },
                         tmix + TL.mu() + k * D, prop, xm, D, true);
        ln = tmix[TL.ln() + k];
        w = tmix[TL.w() + k];
        dof = tmix[TL.dof() + k];
      }
      lse.add(component_logpdf(maha, ln, dof, D, t_student_t != 0), w);
    }
    const float e_prop = lse.value();   // alike on every lane

    // lane 0 decides: bit 0 accept, bit 1 a NaN log_rho
    int verdict = 0;
    if (lane == 0) {
      const float log_rho = e_prop - e;
      const bool is_nan = isnan(log_rho);
      verdict = (!is_nan && log_rho >= log_u ? 1 : 0) | (is_nan ? 2 : 0);
    }
    verdict = from_lane0(verdict);
    if (verdict & 1) {
      x0 = p0;
      x1 = p1;
      e = e_prop;
      ++acc;
    }
    nans += verdict >> 1;
    float* out = points + static_cast<long long>(step) * D * C + c;
    if (has0) out[static_cast<long long>(lane) * C] = x0;
    if (has1) out[static_cast<long long>(d1) * C] = x1;
  }
  if (has0) xfT[static_cast<long long>(lane) * C + c] = x0;
  if (has1) xfT[static_cast<long long>(d1) * C + c] = x1;
  if (lane == 0) {
    ef[c] = e;
    accepts[c] = acc;
    nan_counts[c] = nans;
  }
}

}  // namespace pmc

// the variant pool_variant elects for C chains in D dimensions: 1 a warp a
// chain, 0 a thread a chain (checked against ops/_build.py)
extern "C" int pmc_mcmc_pool_variant(int C, int D) { return pmc::pool_variant(C, D); }

// shared memory the launcher asks for (checked against ops/_build.py): the
// thread variant (0) pool_thread_rec_smem where its record instantiation
// takes the pool, else the looped kernel's (the target's evaluation
// operands if they fit, else none); the warp variant (1) pool_warp_smem
extern "C" long long pmc_mcmc_pool_smem_bytes(int Kt, int D, int variant) {
  using namespace pmc;
  if (variant == 1) return static_cast<long long>(pool_warp_smem(Kt, D, pool_warp_staged(Kt, D)));
  if (pool_thread_records(Kt, D)) return static_cast<long long>(pool_thread_rec_smem(Kt, D));
  const size_t ops = sizeof(float) * MixLayout{Kt, D}.eval_size();
  return static_cast<long long>(ops <= kSmemLimit ? ops : 0);
}

// x0T, xfT: (D, C); e0, ef, accepts, nan_counts: (C,); cholr: (D*D, C);
// points: (n_steps, D, C); tmix: the target's packed operands; variant: 0 a
// thread a chain, 1 a warp a chain (D <= 64)
extern "C" int pmc_fused_mcmc_pool(unsigned int s0, unsigned int s1,
                                   const float* x0T, const float* e0,
                                   const float* cholr, float dof_prop,
                                   const float* tmix, float* points,
                                   int* accepts, int* nan_counts, float* xfT,
                                   float* ef, int C, int n_steps, int Kt, int D,
                                   int student_t_prop, int t_student_t, int variant,
                                   void* stream) {
  using namespace pmc;
  const size_t smem = pmc_mcmc_pool_smem_bytes(Kt, D, variant);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto launch = [&](auto kernel, int n_blocks, int threads) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<n_blocks, threads, smem, s>>>(s0, s1, x0T, e0, cholr, dof_prop, tmix, points,
                                           accepts, nan_counts, xfT, ef, C, n_steps, Kt, D,
                                           student_t_prop, t_student_t);
    return static_cast<int>(cudaGetLastError());
  };
  if (variant == 1) {
    if (D > kPoolWarpDMax) return static_cast<int>(cudaErrorInvalidValue);
    const bool staged = pool_warp_staged(Kt, D);
    if (D <= 32)
      return staged ? launch(mcmc_pool_warp_kernel<32, true>, C, 32)
                    : launch(mcmc_pool_warp_kernel<32, false>, C, 32);
    return staged ? launch(mcmc_pool_warp_kernel<64, true>, C, 32)
                  : launch(mcmc_pool_warp_kernel<64, false>, C, 32);
  }
  const int n_blocks = (C + kThreads - 1) / kThreads;
  if (pool_thread_records(Kt, D)) {
    auto body = [&](auto dmax, auto) {
      return launch(mcmc_pool_kernel<decltype(dmax)::value>, n_blocks, kThreads);
    };
    return dispatch_records(D, body, EvalInsts());
  }
  if (D > kDMax) return static_cast<int>(cudaErrorInvalidValue);
  return smem > 0 ? launch(mcmc_pool_looped_kernel<true>, n_blocks, kThreads)
                  : launch(mcmc_pool_looped_kernel<false>, n_blocks, kThreads);
}
