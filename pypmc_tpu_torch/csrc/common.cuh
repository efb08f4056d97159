// Device code shared by the mixture kernels of pypmc_tpu_torch: the packed
// mixture layout, a Philox-4x32-10 counter generator, uniform, Box-Muller
// and Marsaglia-Tsang draws, the whitened component log-pdf, the dense
// projection of the general-matrix kernels and the weighted log-sum-exp.
//
// Particles are carried transposed, xT (D, N) row-major, so that thread n
// reads x[i] = xT[i * N + n]: neighbouring threads read neighbouring
// addresses.  Every kernel keeps one particle's coordinates in a per-thread
// array of DMAX floats.  For DMAX = 8, 16 or 32 (and 40 or 64 in the record
// kernels) the loops over the dimension are
// unrolled to DMAX with a guard on the runtime D, so the arrays stay in
// registers; the DMAX = 128 instantiation loops to D, and its arrays live in
// local memory.  From D = 65 fused_logq, fused_maha, fused_rho and the
// three draws run the block-tiled product engine of tiled.cuh instead, to
// any D to kWideDMax (fused_transform from transform.cu
// kTransformTiledDMin, fused_transform_rng and fused_propose_logq from
// tiled.cuh kDrawTiledDMin).
//
// A block stages its mixture operands in shared memory when they fit there
// beside the kernel's own shared memory (OPS_SMEM); otherwise it reads them
// from device memory, where every thread of a warp reads the same element
// at once (one cached load).  The record kernels (D <= 64) stream 16-byte
// component records through shared memory in chunks instead (eval_plan);
// those of the draws stage each component's mu and L at an odd stride
// (draw_plan).
#pragma once

#include <cmath>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace pmc {

constexpr int kThreads = 128;   // threads per block, one particle each
constexpr int kDMax = 128;      // the thread kernels' largest D (ops/_build.py D_MAX)
constexpr int kWideDMax = 4096; // the tiled kernels' largest D (ops/_build.py WIDE_D_MAX)
constexpr size_t kSmemLimit = 232448;   // bytes of shared memory a block may use
// a block's share of an SM's 228 KB where two blocks share it (each also
// reserves 1 KB)
constexpr size_t kHalfSmem = 228 * 1024 / 2 - 1024;

// Trip count of a loop over the dimension: DMAX (a constant, so the loop
// unrolls) in the register instantiations, the runtime D in the looped one.
template <int DMAX>
__device__ __forceinline__ int dim_loop(int D) {
  return DMAX < kDMax ? DMAX : D;
}

// Packed mixture operands, one flat float32 buffer per mixture
// (built by pypmc_tpu_torch.density.core._kernel_operands):
//   mu (K, D) | U = L^{-1} (K, D, D) | log_norm (K) | weights (K) |
//   dof (K) | psi = digamma((D + dof) / 2) (K) |
//   L (K, D, D) | cumw (K)
// The evaluation kernels read only the part before L.
struct MixLayout {
  int K, D;
  __host__ __device__ int mu() const { return 0; }
  __host__ __device__ int U() const { return K * D; }
  __host__ __device__ int ln() const { return K * D + K * D * D; }
  __host__ __device__ int w() const { return ln() + K; }
  __host__ __device__ int dof() const { return ln() + 2 * K; }
  __host__ __device__ int psi() const { return ln() + 3 * K; }
  __host__ __device__ int L() const { return ln() + 4 * K; }
  __host__ __device__ int cumw() const { return L() + K * D * D; }
  __host__ __device__ int eval_size() const { return L(); }
  __host__ __device__ int size() const { return cumw() + K; }
};

__device__ __forceinline__ void load_to_shared(float* dst, const float* src,
                                               int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// The n operand floats a block reads: copied to ``smem`` if OPS_SMEM, else
// ``src`` itself.  Call __syncthreads() before reading them.
template <bool OPS_SMEM>
__device__ __forceinline__ const float* stage_operands(float* smem,
                                                       const float* src, int n) {
  if (!OPS_SMEM) return src;
  load_to_shared(smem, src, n);
  return smem;
}

// ---------------------------------------------------------------------
// Philox-4x32-10 (Salmon et al., SC'11).  Key = the two host seed words,
// counter = (particle index lo, hi, draw block, 0): a particle's stream
// depends only on the seed and its global index, never on the launch
// configuration.  The key is read through ``Key`` at each refill: held
// (ValueKey, Philox), or read where it lies (SharedKey, below Seed).
// ---------------------------------------------------------------------
struct ValueKey {
  uint32_t w0, w1;
  __device__ __forceinline__ uint32_t k0() const { return w0; }
  __device__ __forceinline__ uint32_t k1() const { return w1; }
};

template <typename Key>
struct PhiloxT {
  Key key;
  uint32_t c0, c1, c2;
  uint32_t b0, b1, b2, b3;
  int pos;

  __device__ PhiloxT(Key k, uint64_t n)
      : key(k), c0(static_cast<uint32_t>(n)), c1(static_cast<uint32_t>(n >> 32)), c2(0),
        pos(4) {}

  // the stream from its ``word``-th word on: what next() gives after
  // ``word`` calls (a block is 4 words; block b is counter c2 = b)
  __device__ __forceinline__ void seek(int word) {
    c2 = static_cast<uint32_t>(word / 4);
    pos = 4;
    if (word % 4 != 0) {
      refill();
      pos = word % 4;
    }
  }

  __device__ __forceinline__ void refill() {
    uint32_t x0 = c0, x1 = c1, x2 = c2, x3 = 0u, a = key.k0(), b = key.k1();
#pragma unroll
    for (int r = 0; r < 10; ++r) {
      const uint32_t hi0 = __umulhi(0xD2511F53u, x0);
      const uint32_t lo0 = 0xD2511F53u * x0;
      const uint32_t hi1 = __umulhi(0xCD9E8D57u, x2);
      const uint32_t lo1 = 0xCD9E8D57u * x2;
      x0 = hi1 ^ x1 ^ a;
      x1 = lo1;
      x2 = hi0 ^ x3 ^ b;
      x3 = lo0;
      a += 0x9E3779B9u;
      b += 0xBB67AE85u;
    }
    b0 = x0; b1 = x1; b2 = x2; b3 = x3;
    pos = 0;
    ++c2;
  }

  __device__ __forceinline__ uint32_t next() {
    if (pos == 4) refill();
    const uint32_t v = pos == 0 ? b0 : pos == 1 ? b1 : pos == 2 ? b2 : b3;
    ++pos;
    return v;
  }

  // [0, 1): the categorical draw against tail-sum thresholds
  __device__ static float u01(uint32_t v) {
    return static_cast<float>(v >> 8) * (1.0f / 16777216.0f);
  }
  // (0, 1]: safe for log
  __device__ static float u01_pos(uint32_t v) {
    return static_cast<float>((v >> 8) + 1u) * (1.0f / 16777216.0f);
  }
  // two independent standard normals from two words (Box-Muller, both halves)
  __device__ static void box_muller(uint32_t a, uint32_t b, float& z0, float& z1) {
    const float r = sqrtf(-2.0f * logf(u01_pos(a)));
    float s, c;
    sincospif(2.0f * u01(b), &s, &c);
    z0 = r * c;
    z1 = r * s;
  }
  __device__ float uniform() { return u01(next()); }
  __device__ float uniform_pos() { return u01_pos(next()); }
  __device__ void normal_pair(float& z0, float& z1) {
    const uint32_t a = next();
    box_muller(a, next(), z0, z1);
  }
};

struct Philox : PhiloxT<ValueKey> {
  __device__ Philox(uint32_t s0, uint32_t s1, uint64_t n) : PhiloxT<ValueKey>({s0, s1}, n) {}
};

// A launch's two Philox seed words: by value (s0, s1), or read from device
// memory where ``words`` is given (two 64-bit integers, the low 32 bits of
// each).  A CUDA graph replays its launches with the arguments of their
// capture, so a replayed step reads its words from a table the host filled
// before the run.  Read where a stream is made (a volatile load, so the
// compiler keeps no register for it across a particle loop).
struct Seed {
  uint32_t s0, s1;
  const long long* words;

  __device__ __forceinline__ uint32_t word(int i) const {
    return static_cast<uint32_t>(*static_cast<const volatile long long*>(words + i));
  }
  __device__ __forceinline__ uint32_t w0() const { return words == nullptr ? s0 : word(0); }
  __device__ __forceinline__ uint32_t w1() const { return words == nullptr ? s1 : word(1); }
};

// A launch's seed words in shared memory (store_seed_key, then a barrier),
// read at each refill by a stream keyed with SharedKey: a kernel's streams
// then hold no key between refills, as with the words by value (kernel
// parameters).  A load the compiler shares between refills is a key held;
// a volatile one orders the kernel's other shared-memory accesses around
// it: an asm load is neither.
__device__ __forceinline__ uint32_t* seed_key() {
  __shared__ uint32_t key[2];
  return key;
}

__device__ __forceinline__ void store_seed_key(Seed seed) {
  seed_key()[0] = seed.w0();
  seed_key()[1] = seed.w1();
}

__device__ __forceinline__ uint32_t seed_key_word(int i) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];"
               : "=r"(v)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(seed_key() + i))));
  return v;
}

// FLIP is xored into the second word: the stream of another draw keyed by
// the same seed (draw.cu's), from the words stored once
template <uint32_t FLIP = 0>
struct SharedKeyT {
  __device__ __forceinline__ uint32_t k0() const { return seed_key_word(0); }
  __device__ __forceinline__ uint32_t k1() const { return seed_key_word(1) ^ FLIP; }
};
using SharedKey = SharedKeyT<>;

// Particle n's stream in a kernel instantiated for the words by value
// (SEED_PTR false: keyed by the kernel parameters, as free as constants)
// or from a seed tensor (true: SharedKey, after store_seed_key and a
// barrier), bits FLIP of the second word flipped; the key's loads cost an
// issue-bound draw a few percent, so only a replayed launch pays them
template <bool SEED_PTR, uint32_t FLIP = 0>
__device__ __forceinline__ auto particle_stream(Seed seed, uint64_t n) {
  if constexpr (SEED_PTR) {
    return PhiloxT<SharedKeyT<FLIP>>({}, n);
  } else {
    return Philox(seed.s0, seed.s1 ^ FLIP, n);
  }
}

// log of a chi-square draw with ``dof`` degrees of freedom: Marsaglia-Tsang
// for Gamma(a + 1), a = dof / 2, with the shape boost U^(1/a) applied in log
// space.  Each round accepts with probability >= 0.951, so the loop runs
// until acceptance; the cap only stops a non-finite dof from spinning.
template <typename Rng>
__device__ __forceinline__ float log_chi2(float dof, Rng& rng) {
  const float a = 0.5f * dof;
  const float d = a + 1.0f - 1.0f / 3.0f;
  const float c = 1.0f / sqrtf(9.0f * d);
  float log_g = logf(d);
  float z, z_next = 0.0f;
  for (int r = 0; r < 100; ++r) {
    if ((r & 1) == 0) rng.normal_pair(z, z_next); else z = z_next;
    const float u = rng.uniform_pos();
    const float one_plus_cz = 1.0f + c * z;
    if (one_plus_cz > 0.0f) {
      const float log_v = 3.0f * logf(one_plus_cz);
      // margin d (1 - v + log v) = d (log_v - expm1(log_v)): no
      // catastrophic cancellation for large d
      if (logf(u) < 0.5f * z * z + d * (log_v - expm1f(log_v))) {
        log_g = logf(d) + log_v;
        break;
      }
    }
  }
  return CUDART_LN2_F + log_g + logf(rng.uniform_pos()) / a;
}

// ---------------------------------------------------------------------
// evaluation
// ---------------------------------------------------------------------

// Squared Mahalanobis distance of x to component (mu, U = L^{-1}), with the
// whitened difference diff = U (x - mu) left in ``diff`` (lower-triangular
// product, FP32 FMA).
template <int DMAX>
__device__ __forceinline__ float whiten(const float* U, const float* mu,
                                        const float (&x)[DMAX], int D,
                                        float (&diff)[DMAX]) {
  float xm[DMAX];
#pragma unroll
  for (int j = 0; j < dim_loop<DMAX>(D); ++j) xm[j] = j < D ? x[j] - mu[j] : 0.0f;
  float maha = 0.0f;
#pragma unroll
  for (int i = 0; i < dim_loop<DMAX>(D); ++i) {
    float s = 0.0f;
    if (i < D) {
#pragma unroll
      for (int j = 0; j <= i; ++j) s = fmaf(U[i * D + j], xm[j], s);
    }
    diff[i] = s;
    maha = fmaf(s, s, maha);
  }
  return maha;
}

// Squared norm of diff = A (x - m) for one row-major (D, D) matrix A, with
// diff left in ``diff``.  Every entry of A is read, so a lower, an upper or
// a full matrix gives the right product (whiten above reads only the lower
// triangle).
template <int DMAX>
__device__ __forceinline__ float project(const float* A, const float* m,
                                         const float (&x)[DMAX], int D,
                                         float (&diff)[DMAX]) {
  float xm[DMAX];
#pragma unroll
  for (int j = 0; j < dim_loop<DMAX>(D); ++j) xm[j] = j < D ? x[j] - m[j] : 0.0f;
  float maha = 0.0f;
#pragma unroll
  for (int i = 0; i < dim_loop<DMAX>(D); ++i) {
    float s = 0.0f;
    if (i < D) {
#pragma unroll
      for (int j = 0; j < dim_loop<DMAX>(D); ++j)
        if (j < D) s = fmaf(A[i * D + j], xm[j], s);
    }
    diff[i] = s;
    maha = fmaf(s, s, maha);
  }
  return maha;
}

// The Student-t term's FMA is stated: left to contract it, the compiler
// fused it in some kernels (the looped DMAX 16 instantiations) and not in
// others (where it merged the two branches' products), so that the same
// component gave log-densities a few ulp apart.  The Gaussian term's
// product is exact.
__device__ __forceinline__ float component_logpdf(float maha, float log_norm,
                                                  float dof, int D,
                                                  bool student_t) {
  if (student_t)
    return fmaf(-0.5f * (dof + static_cast<float>(D)), log1pf(maha / dof), log_norm);
  return log_norm - 0.5f * maha;
}

// streaming weighted log-sum-exp, log sum_k w_k exp(v_k)
struct WeightedLse {
  float m = -INFINITY, s = 0.0f;
  __device__ void add(float v, float w) {
    if (v > m) {
      s = s * expf(m - v) + w;
      m = v;
    } else {
      s = fmaf(w, expf(v - m), s);
    }
  }
  __device__ float value() const { return logf(s) + m; }
};

// ---------------------------------------------------------------------
// Component records for 16-byte loads (the K-blocked kernels and those of
// fused_logq and fused_maha stage their operands in shared memory this way;
// every thread of a warp reads the same record, so each load is one
// broadcast LDS.128).  One record of rec_floats(D) floats a component,
// 16-byte aligned:
//   mu (D, zero-padded to pad4(D)) | log_norm, weight, dof,
//   log(dof / 2) - psi (0 in fused_logq's, which does not read it) |
//   U = L^{-1} row by row, row i its i + 1 entries zero-padded to
//   pad4(i + 1), starting at tri_row(i)
// A VB record (vb_rec_floats) holds m | c, 0, 0, 0 | A row by row, each row
// zero-padded to pad4(D) (fused_maha's: c = 0).  whiten_rec and project_rec
// read them in the FMA order of whiten and project, so the results are the
// same bit for bit.
// ---------------------------------------------------------------------
__host__ __device__ constexpr int pad4(int n) { return (n + 3) / 4 * 4; }
// 4 * sum_{r < i} ceil((r + 1) / 4)
__host__ __device__ constexpr int tri_row(int i) {
  return 4 * (i / 4 + 1) * (2 * (i / 4) + i % 4);
}
__host__ __device__ inline int rec_floats(int D) { return pad4(D) + 4 + tri_row(D); }
__host__ __device__ inline int vb_rec_floats(int D) { return pad4(D) + 4 + D * pad4(D); }

// cp.async (sm_80 on): a 4-byte copy from device to shared memory that does
// not hold up the thread; a copy that is not ``valid`` reads nothing and
// writes 0
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The records of components k0 .. k0 + kc - 1 at dst by cp.async: kc
// records of rec_floats(D) (tri) or vb_rec_floats(D) floats, from mu (K, D),
// M (K, D, D) row-major (U = L^{-1}, or A) and nscal scalars a component,
// K floats apart from scal (log_norm, weight, dof; or VB's c).  Pads, the
// scalars past nscal and, for tri, M's upper triangle are 0.  One record row
// a warp at a time, so that each row is read coalesced.  Commit after, and wait and
// __syncthreads() before reading.
__device__ inline void stage_records_async(float* dst, const float* mu, const float* M,
                                           const float* scal, int nscal, int K, int k0,
                                           int kc, int D, bool tri) {
  const int D4 = pad4(D), F = tri ? rec_floats(D) : vb_rec_floats(D);
  const int lane = threadIdx.x % 32;
  for (int row = threadIdx.x / 32; row < kc * (D + 1); row += blockDim.x / 32) {
    const int c = row / (D + 1), i = row - c * (D + 1) - 1;
    const long long k = k0 + c;
    float* rec = dst + c * F;
    if (i < 0) {   // mu | the scalars
      for (int t = lane; t < D4 + 4; t += 32) {
        const bool valid = t < D || (t >= D4 && t - D4 < nscal);
        const float* src = !valid ? mu : t < D4 ? mu + k * D + t : scal + (t - D4) * K + k;
        cp_async_f32(rec + t, src, valid);
      }
    } else {       // row i of M
      const int len = tri ? pad4(i + 1) : D4, used = tri ? i + 1 : D;
      float* out = rec + D4 + 4 + (tri ? tri_row(i) : i * D4);
      const float* src = M + (k * D + i) * D;
      for (int t = lane; t < len; t += 32) cp_async_f32(out + t, t < used ? src + t : mu, t < used);
    }
  }
}

// K records at dst from the evaluation part of a packed K-component mixture
// (MixLayout), the fourth scalar log(dof / 2) - psi; all threads of the
// block, __syncthreads() before reading.
__device__ inline void stage_records(float* dst, const float* mix, int K, int D) {
  const MixLayout L{K, D};
  stage_records_async(dst, mix + L.mu(), mix + L.U(), mix + L.ln(), 3, K, 0, K, D, true);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int F = rec_floats(D), D4 = pad4(D);
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    dst[k * F + D4 + 3] = logf(0.5f * mix[L.dof() + k]) - mix[L.psi() + k];
}

// K VB records at dst from ops = A (K, D, D) | m (K, D) | c (K); all
// threads of the block, __syncthreads() before reading.
__device__ inline void stage_vb_records(float* dst, const float* ops, int K, int D) {
  const float* m = ops + K * D * D;
  stage_records_async(dst, m, ops, m + K * D, 1, K, 0, K, D, false);
  cp_async_commit();
  cp_async_wait<0>();
}

// x - mu with mu the record's first pad4(D) floats (0 past D)
template <int DMAX>
__device__ __forceinline__ void centre_rec(const float* rec, const float (&x)[DMAX], int D,
                                           float (&xm)[DMAX]) {
  const float4* mu4 = reinterpret_cast<const float4*>(rec);
#pragma unroll
  for (int q = 0; q < DMAX / 4; ++q) {
    const float4 m = 4 * q < D ? mu4[q] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    xm[4 * q] = x[4 * q] - m.x;
    xm[4 * q + 1] = x[4 * q + 1] - m.y;
    xm[4 * q + 2] = x[4 * q + 2] - m.z;
    xm[4 * q + 3] = x[4 * q + 3] - m.w;
  }
}

// whiten on a record (DMAX <= 64, x zero past D): returns maha and hands
// each diff_i, i < D, to emit(i, diff_i), i ascending.  Up to DMAX = 32 the
// rows are unrolled.  Past it a loop over groups of 2 rows, which take the
// same number of float4s, keeps the code small and gives independent FMA
// chains to hide the loads' latency (a row's loads cannot be issued ahead
// of the branch that ends it), while the loop within a row stays unrolled,
// so that xm stays in registers.
template <int DMAX, typename Emit>
__device__ __forceinline__ float whiten_rec(const float* rec, const float (&x)[DMAX], int D,
                                            Emit&& emit) {
  static_assert(DMAX <= 64 && DMAX % 4 == 0, "records are read by unrolled loops");
  float xm[DMAX];
  centre_rec<DMAX>(rec, x, D, xm);
  const float* U = rec + pad4(D) + 4;
  float maha = 0.0f;
  if constexpr (DMAX <= 32) {
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      if (i < D) {
        float s = 0.0f;
        const float4* row = reinterpret_cast<const float4*>(U + tri_row(i));
#pragma unroll
        for (int q = 0; q <= i / 4; ++q) {
          const float4 u = row[q];
          s = fmaf(u.x, xm[4 * q], s);
          if (4 * q + 1 <= i) s = fmaf(u.y, xm[4 * q + 1], s);
          if (4 * q + 2 <= i) s = fmaf(u.z, xm[4 * q + 2], s);
          if (4 * q + 3 <= i) s = fmaf(u.w, xm[4 * q + 3], s);
        }
        emit(i, s);
        maha = fmaf(s, s, maha);
      }
    }
  } else {
    for (int i = 0; i < D; i += 2) {
      // rows i and i + 1 (i even): g + 1 float4s each, row i + 1's from
      // tri_row(i) + 4 (g + 1); the last one the diagonal block
      const int g = i / 4;
      const float4* r0 = reinterpret_cast<const float4*>(U + tri_row(i));
      const float4* r1 = r0 + (g + 1);
      const bool two = i + 1 < D;
      float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
      for (int q = 0; q < DMAX / 4; ++q) {
        if (q > g) break;
        const float4 u = r0[q];
        const float4 v = two ? r1[q] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        s0 = fmaf(u.x, xm[4 * q], s0);
        if (4 * q + 1 <= i) s0 = fmaf(u.y, xm[4 * q + 1], s0);
        if (4 * q + 2 <= i) s0 = fmaf(u.z, xm[4 * q + 2], s0);
        if (4 * q + 3 <= i) s0 = fmaf(u.w, xm[4 * q + 3], s0);
        s1 = fmaf(v.x, xm[4 * q], s1);
        if (4 * q + 1 <= i + 1) s1 = fmaf(v.y, xm[4 * q + 1], s1);
        if (4 * q + 2 <= i + 1) s1 = fmaf(v.z, xm[4 * q + 2], s1);
        if (4 * q + 3 <= i + 1) s1 = fmaf(v.w, xm[4 * q + 3], s1);
      }
      emit(i, s0);
      maha = fmaf(s0, s0, maha);
      if (two) {
        emit(i + 1, s1);
        maha = fmaf(s1, s1, maha);
      }
    }
  }
  return maha;
}

// project on a VB record (DMAX <= 64, x zero past D), emitting as whiten_rec.
// Up to DMAX = 32 the rows are unrolled; past it a loop over the rows keeps
// the code small, while the loop within a row stays unrolled, so that xm
// stays in registers (groups of rows bought nothing here: every row is D
// long, so its loads can be issued together).
template <int DMAX, typename Emit>
__device__ __forceinline__ float project_rec(const float* rec, const float (&x)[DMAX], int D,
                                             Emit&& emit) {
  static_assert(DMAX <= 64 && DMAX % 4 == 0, "records are read by unrolled loops");
  float xm[DMAX];
  centre_rec<DMAX>(rec, x, D, xm);
  const int D4 = pad4(D);
  const float* A = rec + D4 + 4;
  float maha = 0.0f;
#pragma unroll (DMAX <= 32 ? DMAX : 1)
  for (int i = 0; i < (DMAX <= 32 ? DMAX : D); ++i) {
    if (i < D) {
      float s = 0.0f;
      const float4* row = reinterpret_cast<const float4*>(A + i * D4);
#pragma unroll
      for (int q = 0; q < DMAX / 4; ++q) {
        if (4 * q < D) {
          const float4 u = row[q];
          s = fmaf(u.x, xm[4 * q], s);
          if (4 * q + 1 < D) s = fmaf(u.y, xm[4 * q + 1], s);
          if (4 * q + 2 < D) s = fmaf(u.z, xm[4 * q + 2], s);
          if (4 * q + 3 < D) s = fmaf(u.w, xm[4 * q + 3], s);
        }
      }
      emit(i, s);
      maha = fmaf(s, s, maha);
    }
  }
  return maha;
}

// add the weighted component densities of K records to acc, k ascending,
// handing each component's log-density to each(k, log q_k)
template <int DMAX, typename Each>
__device__ __forceinline__ void records_lse(WeightedLse& acc, const float* recs, int K, int D,
                                            bool student_t, const float (&x)[DMAX],
                                            Each&& each) {
  const int F = rec_floats(D), D4 = pad4(D);
  for (int k = 0; k < K; ++k) {
    const float* r = recs + k * F;
    const float maha = whiten_rec<DMAX>(r, x, D, [](int, float) {});
    const float4 p = *reinterpret_cast<const float4*>(r + D4);   // ln, w, dof, .
    const float ind = component_logpdf(maha, p.x, p.z, D, student_t);
    each(k, ind);
    acc.add(ind, p.y);
  }
}
template <int DMAX>
__device__ __forceinline__ void records_lse(WeightedLse& acc, const float* recs, int K, int D,
                                            bool student_t, const float (&x)[DMAX]) {
  records_lse<DMAX>(acc, recs, K, D, student_t, x, [](int, float) {});
}

// mixture_logpdf on K records
template <int DMAX>
__device__ float records_logpdf(const float* recs, int K, int D, bool student_t,
                                const float (&x)[DMAX]) {
  WeightedLse acc;
  records_lse<DMAX>(acc, recs, K, D, student_t, x);
  return acc.value();
}

// mixture log-density of one particle; ``mix`` is the packed layout
template <int DMAX>
__device__ float mixture_logpdf(const float* mix, int K, int D, bool student_t,
                                const float (&x)[DMAX]) {
  const MixLayout L{K, D};
  WeightedLse acc;
  float diff[DMAX];
  for (int k = 0; k < K; ++k) {
    const float maha = whiten<DMAX>(mix + L.U() + k * D * D,
                                    mix + L.mu() + k * D, x, D, diff);
    acc.add(component_logpdf(maha, mix[L.ln() + k], mix[L.dof() + k], D,
                             student_t),
            mix[L.w() + k]);
  }
  return acc.value();
}

template <int DMAX>
__device__ __forceinline__ void load_particle(const float* xT, long long N,
                                              long long n, int D,
                                              float (&x)[DMAX]) {
#pragma unroll
  for (int i = 0; i < dim_loop<DMAX>(D); ++i) x[i] = i < D ? xT[i * N + n] : 0.0f;
}

template <int DMAX>
__device__ __forceinline__ void store_particle(float* xT, long long N,
                                               long long n, int D,
                                               const float (&x)[DMAX]) {
#pragma unroll
  for (int i = 0; i < dim_loop<DMAX>(D); ++i)
    if (i < D) xT[i * N + n] = x[i];
}

// ---------------------------------------------------------------------
// proposal draw
// ---------------------------------------------------------------------

// D standard normals into z (Box-Muller pairs; entries past D are 0).
template <int DMAX, typename Rng>
__device__ __forceinline__ void draw_normals(Rng& rng, int D, float (&z)[DMAX]) {
#pragma unroll
  for (int i = 0; i < dim_loop<DMAX>(D); i += 2) {
    z[i] = 0.0f;
    if (i + 1 < DMAX) z[i + 1] = 0.0f;
    if (i < D) {
      float z0, z1;
      rng.normal_pair(z0, z1);
      z[i] = z0;
      if (i + 1 < DMAX) z[i + 1] = z1;
    }
  }
}

// Words of the normals of draw_normals: Box-Muller pairs on words off + 2p,
// off + 2p + 1 of the stream, ceil(D / 2) pairs; the stream goes on (the
// Student-t scale's chi-square) at word normal_words_end(off, D).
__host__ __device__ constexpr int normal_words_end(int off, int D) {
  return off + 2 * ((D + 1) / 2);
}

// Student-t proposal scale sqrt(dof / chi2(dof)), in log space.
template <typename Rng>
__device__ __forceinline__ float student_t_scale(float dof, Rng& rng) {
  return expf(0.5f * (logf(dof) - log_chi2(dof, rng)));
}

// x = mu + scale * (L z) for one component: L (D, D) row-major lower
// triangular, the product in FP32 FMA.
template <int DMAX>
__device__ __forceinline__ void affine_transform(const float* Lk, const float* mu,
                                                 int D, const float (&z)[DMAX],
                                                 float scale, float (&x)[DMAX]) {
#pragma unroll
  for (int i = 0; i < dim_loop<DMAX>(D); ++i) {
    float s = 0.0f;
    if (i < D) {
#pragma unroll
      for (int j = 0; j <= i; ++j) s = fmaf(Lk[i * D + j], z[j], s);
    }
    x[i] = i < D ? fmaf(scale, s, mu[i]) : 0.0f;
  }
}

// One draw from component ``lat`` of a mixture given by its means mu
// (K, D), Cholesky factors L (K, D, D) and dofs (K): Box-Muller normals z,
// for Student-t the scale sqrt(dof / chi2(dof)), then x = mu + scale * L z.
template <int DMAX, typename Rng>
__device__ __forceinline__ void draw_component(const float* mu, const float* L,
                                               const float* dof, int lat, int D,
                                               bool student_t, Rng& rng,
                                               float (&x)[DMAX]) {
  float z[DMAX];
  draw_normals<DMAX>(rng, D, z);
  const float scale = student_t ? student_t_scale(dof[lat], rng) : 1.0f;
  affine_transform<DMAX>(L + lat * D * D, mu + lat * D, D, z, scale, x);
}

// Draw one particle from the mixture: the component by inverse CDF on the
// TAIL-SUM thresholds cumw[k] = 1 - sum_{j>k} w_j (a dead component has an
// empty interval and is never drawn), then draw_component.
template <int DMAX>
__device__ int propose_particle(const float* mix, int K, int D, bool student_t,
                                Philox& rng, float (&x)[DMAX]) {
  const MixLayout L{K, D};
  const float u = rng.uniform();
  int lat = 0;
  for (int k = 0; k < K - 1; ++k) lat += u >= mix[L.cumw() + k] ? 1 : 0;
  draw_component<DMAX>(mix + L.mu(), mix + L.L(), mix + L.dof(), lat, D,
                       student_t, rng, x);
  return lat;
}

// ---------------------------------------------------------------------
// The record kernels of fused_logq and fused_maha (D <= 64): one thread a
// particle, kept in registers, against the components' records streamed
// through shared memory in chunks.
// ---------------------------------------------------------------------
constexpr int kEvalThreads = 256;   // threads of a record kernel's block (ops/_build.py)
constexpr int kRecDMax = 64;        // the largest D of the record kernels

// The record instantiations, DMAX ascending, each with the blocks of
// kEvalThreads an SM it is compiled for: x and x - mu take 2 DMAX registers a
// thread (ptxas on sm_90a: DMAX 48 spilled at 2 blocks, DMAX 16 at 4).  40 is
// the pipeline's D.  dispatch_records walks this list and eval_dmax_below and
// eval_min_blocks read it, so that a kernel's assumption on D is what the
// dispatch gives it.
template <int DMAX, int MIN_BLOCKS> struct EvalInst {};
template <typename... Insts> struct EvalList {};
using EvalInsts = EvalList<EvalInst<8, 4>, EvalInst<16, 3>, EvalInst<32, 2>, EvalInst<40, 2>,
                           EvalInst<kRecDMax, 1>>;

template <int... DS, int... BS>
__host__ __device__ constexpr int dmax_below(EvalList<EvalInst<DS, BS>...>, int DMAX) {
  int below = 0;
  ((below = DS < DMAX ? DS : below), ...);
  return below;
}
template <int... DS, int... BS>
__host__ __device__ constexpr int min_blocks(EvalList<EvalInst<DS, BS>...>, int DMAX) {
  int blocks = 0;
  ((blocks = DS == DMAX ? BS : blocks), ...);
  return blocks;
}

template <int... DS, int... BS>
__host__ __device__ constexpr int dmax_for(EvalList<EvalInst<DS, BS>...>, int D) {
  int dmax = 0;
  ((dmax = dmax == 0 && D <= DS ? DS : dmax), ...);
  return dmax;
}

// the DMAX of the record instantiation dispatch_records takes for D (0 past
// the last)
__host__ __device__ constexpr int eval_dmax_for(int D) {
  return dmax_for(EvalInsts(), D);
}
// the largest D of the record instantiation below DMAX (0 below the first)
__host__ __device__ constexpr int eval_dmax_below(int DMAX) {
  return dmax_below(EvalInsts(), DMAX);
}
// blocks of kEvalThreads an SM the record kernel at DMAX is compiled for
__host__ __device__ constexpr int eval_min_blocks(int DMAX) {
  return min_blocks(EvalInsts(), DMAX);
}

struct EvalPlan {
  int kc;        // components a chunk
  int buffers;   // chunk buffers in shared memory, 1 or 2
  size_t smem;   // shared memory a block asks for
};

// The shared-memory plan of the record kernels (D <= 64) of fused_logq
// (maha false), fused_rho (whose records are fused_logq's) and fused_maha
// (mirrored by ops/_build.py eval_plan; their tiled kernels past D = 64 have
// their own, tiled.cuh): the records of the whole mixture in one buffer
// where they fit an SM's half, else two buffers of the largest equal chunks
// that do, one filled while the other is read.
__host__ __device__ inline EvalPlan eval_plan(int K, int D, bool maha) {
  const size_t rec = sizeof(float) * (maha ? vb_rec_floats(D) : rec_floats(D));
  if (K * rec <= kHalfSmem) return {K, 1, K * rec};
  const int most = static_cast<int>(kHalfSmem / (2 * rec));
  const int n_chunks = (K + most - 1) / most;
  const int kc = (K + n_chunks - 1) / n_chunks;
  return {kc, 2, 2 * kc * rec};
}

// The loop of a record kernel.  The block walks its particle tiles
// (grid-stride), each thread one particle in registers (0 past N), and for
// each tile the component chunks of ``plan``: stage(dst, k0, kc) issues a
// chunk's copies (stage_records_async), eval(recs, k0, kc, x, n) evaluates
// it, chunks in ascending order (a thread with n >= N must not write).  One
// chunk is staged once for all tiles; more are double-buffered, the next
// chunk's copy in flight while this one is evaluated.
template <int DMAX, typename Stage, typename Eval>
__device__ __forceinline__ void stream_records(float* smem, const float* xT, long long N,
                                               int K, int D, int F, EvalPlan plan,
                                               Stage&& stage, Eval&& eval) {
  const int n_tiles = static_cast<int>((N + blockDim.x - 1) / blockDim.x);
  const int n_chunks = (K + plan.kc - 1) / plan.kc;
  const auto fill = [&](int c, int b) {
    stage(smem + b * plan.kc * F, c * plan.kc, min(plan.kc, K - c * plan.kc));
  };
  int tile = blockIdx.x;
  if (tile >= n_tiles) return;
  fill(0, 0);
  cp_async_commit();
  if (n_chunks == 1) {
    cp_async_wait<0>();
    __syncthreads();
  }
  int s = 0;   // chunks evaluated so far; buffer s & 1 holds the next
  for (; tile < n_tiles; tile += gridDim.x) {
    const long long n = static_cast<long long>(tile) * blockDim.x + threadIdx.x;
    float x[DMAX];
#pragma unroll
    for (int i = 0; i < DMAX; ++i) x[i] = 0.0f;
    if (n < N) load_particle<DMAX>(xT, N, n, D, x);
    for (int c = 0; c < n_chunks; ++c) {
      const float* recs = smem;
      if (n_chunks > 1) {
        if (c + 1 < n_chunks || tile + gridDim.x < n_tiles) fill((c + 1) % n_chunks, (s + 1) & 1);
        cp_async_commit();
        cp_async_wait<1>();   // all but the newest group: chunk c has landed
        __syncthreads();
        recs = smem + (s & 1) * plan.kc * F;
      }
      eval(recs, c * plan.kc, min(plan.kc, K - c * plan.kc), x, n);
      if (n_chunks > 1) {
        __syncthreads();      // buffer s & 1 is refilled next
        ++s;
      }
    }
  }
}

// body(DMAX, true) at the first record instantiation with D <= DMAX; its
// result, or cudaErrorInvalidValue past the last
template <typename Body, int... DS, int... BS>
int dispatch_records(int D, Body& body, EvalList<EvalInst<DS, BS>...>) {
  int err = static_cast<int>(cudaErrorInvalidValue);
  (void)((D <= DS && (err = body(std::integral_constant<int, DS>(), std::true_type()), true)) ||
         ...);
  return err;
}

// ---------------------------------------------------------------------
// The record kernels of the draws (D <= 64): fused_transform's,
// fused_transform_rng's and fused_propose_logq's.  One thread a particle,
// z in registers at the record instantiations' DMAX, each x_i formed in
// affine_transform's FMA order, so that the output is the looped kernels'
// bit for bit.  A block stages each component's mu and the lower triangle
// of L by row at an odd stride (transform_rec_floats), so that the lanes
// of a warp that read different components' words at one offset hit
// distinct banks (at the looped kernels' stride of D * D floats, 0 mod 32
// for every D divisible by 8, they hit one), where the plan's records fit
// half an SM; else it reads mu and L from device memory.
// ---------------------------------------------------------------------

// floats of one component's draw record: mu (D) | L's lower triangle by
// row (row i at D + i (i + 1) / 2, its i + 1 entries), made odd (the last
// word of an even count is a pad, never read)
__host__ __device__ inline int transform_rec_floats(int D) { return (D + D * (D + 1) / 2) | 1; }

struct DrawPlan {
  int variant;    // 0 the looped kernel, 1 the record kernel, 2 the tiled product (tiled.cuh)
  bool staged;    // the record kernel's records in shared memory
  int threads;    // a block
  size_t smem;    // shared memory a block asks for
};

// A draw kernel's plan (mirrored by ops/_build.py): up to D = 64 the record
// kernel, its ``rec_floats`` floats staged where they fit half an SM (two
// blocks), else read from device memory; past it (or ``looped``) the looped
// kernel, its ``ops_floats`` operands staged where they fit kSmemLimit,
// which has a kernel to D = 128 (the draws elect their tiled products past
// D = 64 before they ask this).
inline DrawPlan draw_plan(int D, size_t rec_floats, size_t ops_floats, bool looped) {
  if (D > kRecDMax || looped) {
    const size_t ops = sizeof(float) * ops_floats;
    return {0, ops <= kSmemLimit, kThreads, ops <= kSmemLimit ? ops : 0};
  }
  const size_t recs = sizeof(float) * rec_floats;
  return {1, recs <= kHalfSmem, kEvalThreads, recs <= kHalfSmem ? recs : 0};
}

// whether a draw launcher with ``variant`` (-1 the plan's kernel, 0 the
// looped kernel, 1 the record kernel) takes the record kernel
inline bool takes_rec(const DrawPlan& plan, int variant) {
  return variant == 1 || (variant < 0 && plan.variant == 1);
}

// a plan for ops/_build.py's mirror: out = {variant, records staged, a draw
// record's floats (the record kernel; else 0), threads a block}; the shared
// memory a block
inline long long draw_plan_out(const DrawPlan& plan, int D, int* out) {
  out[0] = plan.variant;
  out[1] = plan.staged ? 1 : 0;
  out[2] = plan.variant == 1 ? transform_rec_floats(D) : 0;
  out[3] = plan.threads;
  return static_cast<long long>(plan.smem);
}

// The draw records of all K components at dst by cp.async, from mu (K, D)
// and L (K, D, D): one record row (mu, or row i of L) a warp at a time, so
// that each is read coalesced.  Commit after, and wait and __syncthreads()
// before reading.
__device__ inline void stage_transform_records(float* dst, const float* mu, const float* L,
                                               int K, int D) {
  const int F = transform_rec_floats(D), lane = threadIdx.x % 32;
  for (int row = threadIdx.x / 32; row < K * (D + 1); row += blockDim.x / 32) {
    const int k = row / (D + 1), i = row - k * (D + 1) - 1;
    const int len = i < 0 ? D : i + 1;
    float* out = dst + k * F + (i < 0 ? 0 : D + i * (i + 1) / 2);
    const float* src = i < 0 ? mu + k * D : L + (static_cast<long long>(k) * D + i) * D;
    for (int t = lane; t < len; t += 32) cp_async_f32(out + t, src + t, true);
  }
}

// n floats at dst by cp.async, a thread a word
__device__ __forceinline__ void stage_row_async(float* dst, const float* src, int n) {
  for (int t = threadIdx.x; t < n; t += blockDim.x) cp_async_f32(dst + t, src + t, true);
}

// x = mu + scale * (L z) for one component, row i emitted as emit(i, x_i) as
// soon as it is formed, in affine_transform's FMA order; mu(i) and l(i, j)
// read the component's operands
template <int DMAX, typename Mu, typename Lij, typename Emit>
__device__ __forceinline__ void lower_affine(const float (&z)[DMAX], float scale, int D,
                                             Mu&& mu, Lij&& l, Emit&& emit) {
#pragma unroll
  for (int i = 0; i < DMAX; ++i) {
    if (i < D) {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j <= i; ++j) s = fmaf(l(i, j), z[j], s);
      emit(i, fmaf(scale, s, mu(i)));
    }
  }
}

// lower_affine on component lat's draw record, one of K at recs (STAGED),
// else on mu (K, D) and L (K, D, D) in device memory
template <int DMAX, bool STAGED, typename Emit>
__device__ __forceinline__ void rec_affine(const float (&z)[DMAX], float scale,
                                           const float* recs, const float* mu, const float* L,
                                           int lat, int D, Emit&& emit) {
  if constexpr (STAGED) {
    const float* rec = recs + lat * transform_rec_floats(D);
    const float* tri = rec + D;
    lower_affine<DMAX>(
        z, scale, D, [&](int i) { return rec[i]; },
        [&](int i, int j) { return tri[i * (i + 1) / 2 + j]; }, emit);
  } else {
    const float* m = mu + lat * D;
    const float* Lk = L + static_cast<long long>(lat) * D * D;
    lower_affine<DMAX>(
        z, scale, D, [&](int i) { return __ldg(m + i); },
        [&](int i, int j) { return __ldg(Lk + i * D + j); }, emit);
  }
}

// draw_component by rec_affine: component lat's normals, for Student-t the
// scale sqrt(dof / chi2(dof)) (dof() reads lat's dof), then x, emit(i, x_i)
template <int DMAX, bool STAGED, typename Dof, typename Emit, typename Rng>
__device__ __forceinline__ void draw_rec(Rng& rng, const float* recs, const float* mu,
                                         const float* L, int lat, int D, bool student_t,
                                         Dof&& dof, Emit&& emit) {
  float z[DMAX];
  draw_normals<DMAX>(rng, D, z);
  const float scale = student_t ? student_t_scale(dof(), rng) : 1.0f;
  rec_affine<DMAX, STAGED>(z, scale, recs, mu, L, lat, D, emit);
}

// Call body(kernel) with the record kernel of Kernels (a struct with
// get<DMAX, STAGED>(), the kernel of that instantiation) for D and the
// plan's staging, its shared memory set first as the kernel's limit;
// body's result, or the error of the dispatch or of setting the limit.
template <typename Kernels, typename Body>
int with_rec_kernel(const DrawPlan& plan, int D, Body&& body) {
  if (plan.variant != 1) return static_cast<int>(cudaErrorInvalidValue);
  auto each = [&](auto dmax, auto) {
    constexpr int DMAX = decltype(dmax)::value;
    const auto kernel = plan.staged ? Kernels::template get<DMAX, true>()
                                    : Kernels::template get<DMAX, false>();
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(plan.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    return body(kernel);
  };
  return dispatch_records(D, each, EvalInsts());
}

// blocks of the record kernel of Kernels under ``plan`` that fit on one SM at
// once (0 where the plan takes another kernel, -1 on an error)
template <typename Kernels>
int rec_per_sm(const DrawPlan& plan, int D) {
  if (plan.variant != 1) return 0;
  int n = 0;
  const int err = with_rec_kernel<Kernels>(plan, D, [&](auto kernel) {
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, plan.threads, plan.smem));
  });
  return err == 0 ? n : -1;
}

// one wave of blocks of ``per_sm`` an SM over N particles, ``per_block`` a
// block, on the current device (at least 1)
inline int wave_blocks(int per_sm, long long N, int per_block) {
  int dev = 0, n_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (N + per_block - 1) / per_block;
  const long long room = static_cast<long long>(per_sm > 0 ? per_sm : 1) * n_sm;
  return static_cast<int>(want < room ? (want > 0 ? want : 1) : room);
}

// Dispatch a kernel template on DMAX for the runtime dimension D.
#define PMC_DISPATCH_D(D, ...)                      \
  do {                                              \
    if ((D) <= 8) {                                 \
      constexpr int DMAX = 8;                       \
      __VA_ARGS__;                                  \
    } else if ((D) <= 16) {                         \
      constexpr int DMAX = 16;                      \
      __VA_ARGS__;                                  \
    } else if ((D) <= 32) {                         \
      constexpr int DMAX = 32;                      \
      __VA_ARGS__;                                  \
    } else if ((D) <= kDMax) {                      \
      constexpr int DMAX = kDMax;                   \
      __VA_ARGS__;                                  \
    } else {                                        \
      return static_cast<int>(cudaErrorInvalidValue); \
    }                                               \
  } while (0)

// Instantiate a kernel template for operands in shared memory (``fit``) or
// in device memory.
#define PMC_DISPATCH_OPS(fit, ...)                  \
  do {                                              \
    if (fit) {                                      \
      constexpr bool OPS_SMEM = true;               \
      __VA_ARGS__;                                  \
    } else {                                        \
      constexpr bool OPS_SMEM = false;              \
      __VA_ARGS__;                                  \
    }                                               \
  } while (0)

}  // namespace pmc
