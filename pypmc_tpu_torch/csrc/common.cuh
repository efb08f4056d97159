// Device code shared by the mixture kernels of pypmc_tpu_torch: the packed
// mixture layout, a Philox-4x32-10 counter generator, uniform, Box-Muller
// and Marsaglia-Tsang draws, the whitened component log-pdf, the dense
// projection of the general-matrix kernels and the weighted log-sum-exp.
//
// Particles are carried transposed, xT (D, N) row-major, so that thread n
// reads x[i] = xT[i * N + n]: neighbouring threads read neighbouring
// addresses.  Every kernel keeps one particle's coordinates in a per-thread
// array of DMAX floats.  For DMAX = 8, 16 or 32 the loops over the dimension
// are unrolled to DMAX with a guard on the runtime D, so the arrays stay in
// registers; the DMAX = 128 instantiation (33 <= D <= 128) loops to D, and
// its arrays live in local memory.
//
// A block stages its mixture operands in shared memory when they fit there
// beside the kernel's own shared memory (OPS_SMEM); otherwise it reads them
// from device memory, where every thread of a warp reads the same element
// at once (one cached load).
#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace pmc {

constexpr int kThreads = 128;   // threads per block, one particle each
constexpr int kDMax = 128;      // the largest dimension (ops/_build.py D_MAX)
constexpr size_t kSmemLimit = 232448;   // bytes of shared memory a block may use

// Trip count of a loop over the dimension: DMAX (a constant, so the loop
// unrolls) up to DMAX = 32, the runtime D above.
template <int DMAX>
__device__ __forceinline__ int dim_loop(int D) {
  return DMAX <= 32 ? DMAX : D;
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
// configuration.
// ---------------------------------------------------------------------
struct Philox {
  uint32_t k0, k1, c0, c1, c2;
  uint32_t b0, b1, b2, b3;
  int pos;

  __device__ Philox(uint32_t s0, uint32_t s1, uint64_t n)
      : k0(s0), k1(s1), c0(static_cast<uint32_t>(n)),
        c1(static_cast<uint32_t>(n >> 32)), c2(0), pos(4) {}

  __device__ void refill() {
    uint32_t x0 = c0, x1 = c1, x2 = c2, x3 = 0u, a = k0, b = k1;
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

  __device__ uint32_t next() {
    if (pos == 4) refill();
    const uint32_t v = pos == 0 ? b0 : pos == 1 ? b1 : pos == 2 ? b2 : b3;
    ++pos;
    return v;
  }

  // [0, 1): the categorical draw against tail-sum thresholds
  __device__ float uniform() {
    return static_cast<float>(next() >> 8) * (1.0f / 16777216.0f);
  }
  // (0, 1]: safe for log
  __device__ float uniform_pos() {
    return static_cast<float>((next() >> 8) + 1u) * (1.0f / 16777216.0f);
  }
  // two independent standard normals (Box-Muller, both halves)
  __device__ void normal_pair(float& z0, float& z1) {
    const float r = sqrtf(-2.0f * logf(uniform_pos()));
    float s, c;
    sincospif(2.0f * uniform(), &s, &c);
    z0 = r * c;
    z1 = r * s;
  }
};

// log of a chi-square draw with ``dof`` degrees of freedom: Marsaglia-Tsang
// for Gamma(a + 1), a = dof / 2, with the shape boost U^(1/a) applied in log
// space.  Each round accepts with probability >= 0.951, so the loop runs
// until acceptance; the cap only stops a non-finite dof from spinning.
__device__ __forceinline__ float log_chi2(float dof, Philox& rng) {
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

__device__ __forceinline__ float component_logpdf(float maha, float log_norm,
                                                  float dof, int D,
                                                  bool student_t) {
  if (student_t)
    return log_norm - 0.5f * (dof + static_cast<float>(D)) * log1pf(maha / dof);
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
// Component records for 16-byte loads (the K-blocked kernels stage their
// operands in shared memory this way; every thread of a warp reads the same
// record, so each load is one broadcast LDS.128).  One record of
// rec_floats(D) floats a component, 16-byte aligned:
//   mu (D, zero-padded to pad4(D)) | log_norm, weight, dof,
//   log(dof / 2) - psi |
//   U = L^{-1} row by row, row i its i + 1 entries zero-padded to
//   pad4(i + 1), starting at tri_row(i)
// A VB record (vb_rec_floats) holds m | c, 0, 0, 0 | A row by row, each row
// zero-padded to pad4(D).  whiten_rec and project_rec read them in the FMA
// order of whiten and project, so the results are the same bit for bit.
// ---------------------------------------------------------------------
__host__ __device__ constexpr int pad4(int n) { return (n + 3) / 4 * 4; }
// 4 * sum_{r < i} ceil((r + 1) / 4)
__host__ __device__ constexpr int tri_row(int i) {
  return 4 * (i / 4 + 1) * (2 * (i / 4) + i % 4);
}
__host__ __device__ inline int rec_floats(int D) { return pad4(D) + 4 + tri_row(D); }
__host__ __device__ inline int vb_rec_floats(int D) { return pad4(D) + 4 + D * pad4(D); }

// K records at dst from the evaluation part of a packed K-component mixture
// (MixLayout); all threads of the block, __syncthreads() before reading.
__device__ inline void stage_records(float* dst, const float* mix, int K, int D) {
  const MixLayout L{K, D};
  const int F = rec_floats(D), D4 = pad4(D);
  for (int idx = threadIdx.x; idx < K * F; idx += blockDim.x) {
    const int k = idx / F;
    int r = idx - k * F;
    float v = 0.0f;
    if (r < D4) {
      if (r < D) v = mix[L.mu() + k * D + r];
    } else if (r < D4 + 4) {
      const int q = r - D4;
      if (q < 3) v = mix[(q == 0 ? L.ln() : q == 1 ? L.w() : L.dof()) + k];
      else v = logf(0.5f * mix[L.dof() + k]) - mix[L.psi() + k];
    } else {
      r -= D4 + 4;
      int i = 0;
      while (tri_row(i + 1) <= r) ++i;
      const int j = r - tri_row(i);
      if (j <= i) v = mix[L.U() + k * D * D + i * D + j];
    }
    dst[idx] = v;
  }
}

// K VB records at dst from ops = A (K, D, D) | m (K, D) | c (K)
__device__ inline void stage_vb_records(float* dst, const float* ops, int K, int D) {
  const int F = vb_rec_floats(D), D4 = pad4(D);
  const float* m = ops + K * D * D;
  const float* c = m + K * D;
  for (int idx = threadIdx.x; idx < K * F; idx += blockDim.x) {
    const int k = idx / F;
    int r = idx - k * F;
    float v = 0.0f;
    if (r < D4) {
      if (r < D) v = m[k * D + r];
    } else if (r < D4 + 4) {
      if (r == D4) v = c[k];
    } else {
      r -= D4 + 4;
      const int i = r / D4, j = r - i * D4;
      if (j < D) v = ops[k * D * D + i * D + j];
    }
    dst[idx] = v;
  }
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

// whiten on a record (DMAX <= 32, x zero past D): returns maha and hands
// each diff_i, i < D, to emit(i, diff_i) as it is formed
template <int DMAX, typename Emit>
__device__ __forceinline__ float whiten_rec(const float* rec, const float (&x)[DMAX], int D,
                                            Emit&& emit) {
  static_assert(DMAX <= 32 && DMAX % 4 == 0, "records are read by unrolled loops");
  float xm[DMAX];
  centre_rec<DMAX>(rec, x, D, xm);
  const float* U = rec + pad4(D) + 4;
  float maha = 0.0f;
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
  return maha;
}

// project on a VB record (DMAX <= 32, x zero past D), emitting as whiten_rec
template <int DMAX, typename Emit>
__device__ __forceinline__ float project_rec(const float* rec, const float (&x)[DMAX], int D,
                                             Emit&& emit) {
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

// mixture_logpdf on K records
template <int DMAX>
__device__ float records_logpdf(const float* recs, int K, int D, bool student_t,
                                const float (&x)[DMAX]) {
  const int F = rec_floats(D), D4 = pad4(D);
  WeightedLse acc;
  for (int k = 0; k < K; ++k) {
    const float* r = recs + k * F;
    const float maha = whiten_rec<DMAX>(r, x, D, [](int, float) {});
    const float4 p = *reinterpret_cast<const float4*>(r + D4);   // ln, w, dof, .
    acc.add(component_logpdf(maha, p.x, p.z, D, student_t), p.y);
  }
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
template <int DMAX>
__device__ __forceinline__ void draw_normals(Philox& rng, int D, float (&z)[DMAX]) {
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

// Student-t proposal scale sqrt(dof / chi2(dof)), in log space.
__device__ __forceinline__ float student_t_scale(float dof, Philox& rng) {
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
template <int DMAX>
__device__ __forceinline__ void draw_component(const float* mu, const float* L,
                                               const float* dof, int lat, int D,
                                               bool student_t, Philox& rng,
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
