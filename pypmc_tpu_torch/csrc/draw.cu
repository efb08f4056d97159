// draw_proposal_inputs: the random inputs of n draws from a mixture -- each
// particle's component and, for the transform routes, its D standard
// normals and its Student-t scale -> latent (N,) int32 [, zT (D, N),
// scale (N,)], in float32 or float64.
//
// Replaces no Pallas kernel: it is the counterpart of jax.random in the JAX
// package's propose_T (pypmc_tpu/density/core.py:293-320: one uniform
// against the tail-sum thresholds, jax.random.normal, jax.random.chisquare),
// which XLA runs on the device inside the jitted PMC step and inside the
// lax.scan of pmc_run_sharded(scan_steps=True).  Drawn here from the step's
// seed words -- by value, or read from a 2-word int64 tensor on the card, so
// that a CUDA graph replaying the step draws anew -- where the port drew
// them with torch.rand, torch.randn and a chi-square from a generator seeded
// on the host every step.
//
// Bound on the H100: it reads the K thresholds (and dofs), the same for
// every particle, and writes 4 + (D + 1) sizeof(T) bytes a particle (at
// D = 40, N = 2^20, float32: 176 MB, 0.053 ms); the draw is ~D Philox words
// (twice that in float64: 53-bit uniforms from two words), ten rounds of
// integer multiplies a block of four, and a logarithm, a square root and a
// sine and cosine a normal pair -- integer- and SFU-bound like the other
// draws.  One thread a particle, grid-stride over one wave of blocks; the
// thresholds and dofs through the read-only cache (every lane reads the
// same word: one broadcast); zT written as D coalesced rows.
//
// Particle n's stream is Philox keyed by (s0, s1 ^ kDrawStreamBit) and
// counted by n (common.cuh's counter layout), so it is never the stream of
// another kernel's particle n: the draw kernels key theirs by (s0, s1),
// fused_transform_rng in propose_T by (s0, s1 ^ 1).  Words: the component's
// uniform, the normals in pairs (Box-Muller), then the chi-square's
// Marsaglia-Tsang rounds (common.cuh log_chi2's, in T) and its boost.
//
// fused_draw_transform and fused_draw_transform_rng (draw_transform_rec_
// kernel, D <= 64, float32): propose_T's draw and transform in one launch
// on the card's record routes, each bit for bit the two launches it
// replaces.  The normals-in-memory route (RNG false) was draw_kernel, then
// transform_rec_kernel on zT and scale (4 + 4 (D + 1) bytes a particle
// written and read again: at K = 32, D = 40, N = 2^20, 336 MB of the two
// launches' traffic); here particle n opens draw_kernel's stream, takes its
// component from the first word against the thresholds, draws its D
// normals into registers and its Student-t scale with draw_kernel's
// formula (log_chi2_t, the chi-square clamped to tiny), and forms x by
// rec_affine, each x_i stored as soon as it is formed: only latent and xT
// reach device memory.  The fused_transform_rng route (RNG true) was
// draw_kernel's components-only form, then transform_rng_rec_kernel keyed
// by the words with bit 0 of the second flipped; here the component comes
// from word 0 of draw_kernel's stream and the rest from the transform's
// stream, drawn as before.  The block stages the transform's records, then
// the K thresholds and the K dofs (draw_transform_plan), by cp.async; past
// half an SM (K > 33 at D = 40) it reads them from device memory.  A seed
// tensor's words are stored once in shared memory and both streams' keys
// read there at each refill with their bits flipped (common.cuh
// SharedKeyT), so a replayed graph needs no flipped copy of its seed row.
// What bounds it on the H100: instruction issue, not its 4 (D + 1) bytes a
// particle.  At DMAX 40 its code is ~7,100 SASS instructions a particle,
// ~4,200 of them the draw's (Philox rounds, Box-Muller, the chi-square):
// at 4 warp-instructions a clock an SM, an issue floor of 0.22 ms for 2^20
// particles against 0.05 ms of bytes; it runs at ~1.4x that floor (0.31 ms
// at K = 32, the two launches it replaces 0.39 ms).
#include "common.cuh"

namespace pmc {

constexpr int kDrawThreads = 256;          // ops/_build.py DRAW_THREADS
constexpr uint32_t kDrawStreamBit = 2u;    // flipped in the second seed word

// The uniforms, normals and elementary functions of a draw in T.
template <typename T>
struct Real;

template <>
struct Real<float> {
  template <typename Rng>
  __device__ static float uniform(Rng& r) { return Philox::u01(r.next()); }
  template <typename Rng>
  __device__ static float uniform_pos(Rng& r) { return Philox::u01_pos(r.next()); }
  template <typename Rng>
  __device__ static void normal_pair(Rng& r, float& z0, float& z1) { r.normal_pair(z0, z1); }
  __device__ static float log(float x) { return logf(x); }
  __device__ static float expm1(float x) { return expm1f(x); }
  __device__ static float exp(float x) { return expf(x); }
  __device__ static float sqrt(float x) { return sqrtf(x); }
  __device__ static float fma(float a, float b, float c) { return fmaf(a, b, c); }
  static constexpr float kTiny = 1.17549435e-38f;    // torch.finfo(float32).tiny
  static constexpr float kLn2 = CUDART_LN2_F;
};

// 53-bit uniforms from two words (the high 27 and 26 bits), Box-Muller in
// double
template <>
struct Real<double> {
  template <typename Rng>
  __device__ static uint64_t bits53(Rng& r) {
    const uint32_t a = r.next() >> 5, b = r.next() >> 6;
    return (static_cast<uint64_t>(a) << 26) | b;
  }
  // [0, 1)
  template <typename Rng>
  __device__ static double uniform(Rng& r) {
    return static_cast<double>(bits53(r)) * 0x1.0p-53;
  }
  // (0, 1]: safe for log
  template <typename Rng>
  __device__ static double uniform_pos(Rng& r) {
    return static_cast<double>(bits53(r) + 1u) * 0x1.0p-53;
  }
  template <typename Rng>
  __device__ static void normal_pair(Rng& r, double& z0, double& z1) {
    const double rad = ::sqrt(-2.0 * ::log(uniform_pos(r)));
    double s, c;
    ::sincospi(2.0 * uniform(r), &s, &c);
    z0 = rad * c;
    z1 = rad * s;
  }
  __device__ static double log(double x) { return ::log(x); }
  __device__ static double expm1(double x) { return ::expm1(x); }
  __device__ static double exp(double x) { return ::exp(x); }
  __device__ static double sqrt(double x) { return ::sqrt(x); }
  __device__ static double fma(double a, double b, double c) { return ::fma(a, b, c); }
  static constexpr double kTiny = 2.2250738585072014e-308;   // torch.finfo(float64).tiny
  static constexpr double kLn2 = CUDART_LN2;
};

// log of a chi-square draw with ``dof`` degrees of freedom in T:
// common.cuh log_chi2 (Marsaglia-Tsang for Gamma(dof / 2 + 1), the shape
// boost U^(2 / dof) in log space), the margin written without cancellation.
// Its two FMAs are stated: draw_kernel and draw_transform_rec_kernel draw
// the same scale bit for bit only if the compiler contracts both alike.
template <typename T, typename Rng>
__device__ __forceinline__ T log_chi2_t(T dof, Rng& rng) {
  using R = Real<T>;
  const T a = T(0.5) * dof;
  const T d = a + T(1) - T(1) / T(3);
  const T c = T(1) / R::sqrt(T(9) * d);
  T log_g = R::log(d);
  T z, z_next = T(0);
  for (int r = 0; r < 100; ++r) {
    if ((r & 1) == 0) R::normal_pair(rng, z, z_next); else z = z_next;
    const T u = R::uniform_pos(rng);
    const T one_plus_cz = R::fma(c, z, T(1));
    if (one_plus_cz > T(0)) {
      const T log_v = T(3) * R::log(one_plus_cz);
      if (R::log(u) < R::fma(T(0.5) * z, z, d * (log_v - R::expm1(log_v)))) {
        log_g = R::log(d) + log_v;
        break;
      }
    }
  }
  return R::kLn2 + log_g + R::log(R::uniform_pos(rng)) / a;
}

// A Student-t scale sqrt(nu / max(chi2(nu), tiny)) in T: the proposal
// inputs' (plain_draw_proposal_inputs' formula)
template <typename T, typename Rng>
__device__ __forceinline__ T draw_scale(T nu, Rng& rng) {
  using R = Real<T>;
  const T chi2 = R::exp(log_chi2_t<T>(nu, rng));
  return R::sqrt(nu / (chi2 > R::kTiny ? chi2 : R::kTiny));
}

// the component of a uniform u against the K tail-sum thresholds thr(k):
// the count of those below it (the last is 1, never below)
template <typename T, typename Thr>
__device__ __forceinline__ int draw_index(T u, int K, Thr&& thr) {
  int lat = 0;
  for (int k = 0; k < K - 1; ++k) lat += u >= thr(k) ? 1 : 0;
  return lat;
}

// SEED_PTR: the words from seed.words (a seed tensor's row), read once a
// thread; else the kernel parameters.  zT and scale null: the components
// only; dof null: a Gaussian mixture (scale 1).
template <typename T, bool SEED_PTR>
__global__ void __launch_bounds__(kDrawThreads)
draw_kernel(const Seed seed, const T* __restrict__ cumw, const T* __restrict__ dof,
            int* __restrict__ latent, T* __restrict__ zT, T* __restrict__ scale,
            long long N, int K, int D) {
  using R = Real<T>;
  const uint32_t k0 = SEED_PTR ? seed.word(0) : seed.s0;
  const uint32_t k1 = (SEED_PTR ? seed.word(1) : seed.s1) ^ kDrawStreamBit;
  for (long long n = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       n < N; n += static_cast<long long>(gridDim.x) * blockDim.x) {
    Philox rng(k0, k1, static_cast<uint64_t>(n));
    const int lat = draw_index(R::uniform(rng), K, [&](int k) { return __ldg(cumw + k); });
    latent[n] = lat;
    if (zT == nullptr) continue;
    for (int i = 0; i < D; i += 2) {
      T z0, z1;
      R::normal_pair(rng, z0, z1);
      zT[i * N + n] = z0;
      if (i + 1 < D) zT[(i + 1) * N + n] = z1;
    }
    scale[n] = dof != nullptr ? draw_scale<T>(__ldg(dof + lat), rng) : T(1);
  }
}

template <typename T>
int launch_draw(const Seed& seed, const void* cumw, const void* dof, int* latent, void* zT,
                void* scale, long long N, int K, int D, int n_blocks, cudaStream_t s) {
  const auto kernel = seed.words == nullptr ? &draw_kernel<T, false> : &draw_kernel<T, true>;
  kernel<<<n_blocks, kDrawThreads, 0, s>>>(
      seed, static_cast<const T*>(cumw), static_cast<const T*>(dof), latent,
      static_cast<T*>(zT), static_cast<T*>(scale), N, K, D);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// propose_T's draw and transform in one launch (D <= 64)
// ---------------------------------------------------------------------
constexpr uint32_t kTransformRngBit = 1u;   // propose_T's fused_transform_rng stream

// The plan of draw_transform_rec_kernel for (K, D) (mirrored by
// ops/_build.py draw_transform_plan): transform_plan's record kernel, its
// records the K draw records, the K thresholds and the K dofs; past D = 64
// no kernel of this plan runs (the launcher refuses it).
inline DrawPlan draw_transform_plan(int K, int D) {
  return draw_plan(D, static_cast<size_t>(K) * (transform_rec_floats(D) + 2), 0, false);
}

// mix: the packed mixture (MixLayout: mu, dof, L and cumw read); RNG: the
// fused_transform_rng route's streams, else draw_kernel's alone.  A
// Gaussian mixture (student_t 0) draws no scale.
template <int DMAX, bool STAGED, bool SEED_PTR, bool RNG>
__global__ void __launch_bounds__(kEvalThreads, eval_min_blocks(DMAX))
draw_transform_rec_kernel(const Seed seed, const float* __restrict__ mix,
                          int* __restrict__ latent, float* __restrict__ xT, long long N, int K,
                          int D, int student_t) {
  extern __shared__ float smem[];
  constexpr int below = eval_dmax_below(DMAX);
  __builtin_assume(D > below && D <= DMAX);   // the dispatch's
  const MixLayout lay{K, D};
  const float* mu = mix + lay.mu();
  const float* L = mix + lay.L();
  const float* cumw = mix + lay.cumw();
  const float* dof = mix + lay.dof();
  float* cumw_row = smem + K * transform_rec_floats(D);
  float* dof_row = cumw_row + K;
  if constexpr (SEED_PTR) {
    if (threadIdx.x == 0) store_seed_key(seed);
    if constexpr (!STAGED) __syncthreads();
  }
  if constexpr (STAGED) {
    stage_transform_records(smem, mu, L, K, D);
    stage_row_async(cumw_row, cumw, K);
    stage_row_async(dof_row, dof, K);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  for (long long n = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       n < N; n += static_cast<long long>(gridDim.x) * blockDim.x) {
    auto pick = particle_stream<SEED_PTR, kDrawStreamBit>(seed, static_cast<uint64_t>(n));
    const int lat = draw_index(Real<float>::uniform(pick), K, [&](int k) {
      return STAGED ? cumw_row[k] : __ldg(cumw + k);
    });
    latent[n] = lat;
    const auto nu = [&] { return STAGED ? dof_row[lat] : __ldg(dof + lat); };
    const auto emit = [&](int i, float v) { xT[i * N + n] = v; };
    if constexpr (RNG) {
      auto rng = particle_stream<SEED_PTR, kTransformRngBit>(seed, static_cast<uint64_t>(n));
      draw_rec<DMAX, STAGED>(rng, smem, mu, L, lat, D, student_t != 0, nu, emit);
    } else {
      float z[DMAX];
      draw_normals<DMAX>(pick, D, z);
      const float s = student_t != 0 ? draw_scale<float>(nu(), pick) : 1.0f;
      rec_affine<DMAX, STAGED>(z, s, smem, mu, L, lat, D, emit);
    }
  }
}

template <bool RNG, bool SEED_PTR = false>
struct DrawTransformRecKernels {
  template <int DMAX, bool STAGED>
  static auto get() {
    return &draw_transform_rec_kernel<DMAX, STAGED, SEED_PTR, RNG>;
  }
};

}  // namespace pmc

// seed_words: null (the words s0, s1) or two int64 on the card, read in the
// kernel; cumw (K,), dof (K,) (null: Gaussian) and zT (D, N), scale (N,)
// (both null: the components only) in float32, or float64 where is_double
extern "C" int pmc_draw_proposal_inputs(unsigned int s0, unsigned int s1,
                                        const long long* seed_words, const void* cumw,
                                        const void* dof, int* latent, void* zT, void* scale,
                                        long long N, int K, int D, int is_double,
                                        int n_blocks, void* stream) {
  using namespace pmc;
  if (K < 1 || D < 1 || (zT == nullptr) != (scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const Seed seed{s0, s1, seed_words};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double != 0
      ? launch_draw<double>(seed, cumw, dof, latent, zT, scale, N, K, D, n_blocks, s)
      : launch_draw<float>(seed, cumw, dof, latent, zT, scale, N, K, D, n_blocks, s);
}

// the plan of fused_draw_transform(_rng) for (K, D), checked against
// ops/_build.py draw_transform_plan (draw_plan_out)
extern "C" long long pmc_draw_transform_plan(int K, int D, int* out) {
  return pmc::draw_plan_out(pmc::draw_transform_plan(K, D), D, out);
}

// blocks of fused_draw_transform's (rng 0) or fused_draw_transform_rng's
// (rng 1) kernel for (K, D) that fit on one SM at once (0 past D = 64, -1 on
// an error)
extern "C" int pmc_draw_transform_per_sm(int K, int D, int rng) {
  using namespace pmc;
  const DrawPlan plan = draw_transform_plan(K, D);
  return rng != 0 ? rec_per_sm<DrawTransformRecKernels<true>>(plan, D)
                  : rec_per_sm<DrawTransformRecKernels<false>>(plan, D);
}

// seed_words: null (the words s0, s1) or two int64 on the card, read in the
// kernel; mix: the packed float32 mixture; latent (N,), xT (D, N); rng: the
// fused_transform_rng route's streams (1) or the normals-in-memory route's
// (0); an error past D = 64
extern "C" int pmc_fused_draw_transform(unsigned int s0, unsigned int s1,
                                        const long long* seed_words, const float* mix,
                                        int* latent, float* xT, long long N, int K, int D,
                                        int student_t, int rng, int n_blocks, void* stream) {
  using namespace pmc;
  if (K < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const Seed seed{s0, s1, seed_words};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DrawPlan plan = draw_transform_plan(K, D);
  const auto launch = [&](auto kernel) {
    kernel<<<n_blocks, plan.threads, plan.smem, s>>>(seed, mix, latent, xT, N, K, D, student_t);
    return static_cast<int>(cudaGetLastError());
  };
  if (rng != 0)
    return seed_words == nullptr
        ? with_rec_kernel<DrawTransformRecKernels<true, false>>(plan, D, launch)
        : with_rec_kernel<DrawTransformRecKernels<true, true>>(plan, D, launch);
  return seed_words == nullptr
      ? with_rec_kernel<DrawTransformRecKernels<false, false>>(plan, D, launch)
      : with_rec_kernel<DrawTransformRecKernels<false, true>>(plan, D, launch);
}
