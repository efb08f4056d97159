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
#include "common.cuh"

namespace pmc {

constexpr int kDrawThreads = 256;          // ops/_build.py DRAW_THREADS
constexpr uint32_t kDrawStreamBit = 2u;    // flipped in the second seed word

// The uniforms, normals and elementary functions of a draw in T.
template <typename T>
struct Real;

template <>
struct Real<float> {
  __device__ static float uniform(Philox& r) { return Philox::u01(r.next()); }
  __device__ static float uniform_pos(Philox& r) { return Philox::u01_pos(r.next()); }
  __device__ static void normal_pair(Philox& r, float& z0, float& z1) { r.normal_pair(z0, z1); }
  __device__ static float log(float x) { return logf(x); }
  __device__ static float expm1(float x) { return expm1f(x); }
  __device__ static float exp(float x) { return expf(x); }
  __device__ static float sqrt(float x) { return sqrtf(x); }
  static constexpr float kTiny = 1.17549435e-38f;    // torch.finfo(float32).tiny
  static constexpr float kLn2 = CUDART_LN2_F;
};

// 53-bit uniforms from two words (the high 27 and 26 bits), Box-Muller in
// double
template <>
struct Real<double> {
  __device__ static uint64_t bits53(Philox& r) {
    const uint32_t a = r.next() >> 5, b = r.next() >> 6;
    return (static_cast<uint64_t>(a) << 26) | b;
  }
  // [0, 1)
  __device__ static double uniform(Philox& r) {
    return static_cast<double>(bits53(r)) * 0x1.0p-53;
  }
  // (0, 1]: safe for log
  __device__ static double uniform_pos(Philox& r) {
    return static_cast<double>(bits53(r) + 1u) * 0x1.0p-53;
  }
  __device__ static void normal_pair(Philox& r, double& z0, double& z1) {
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
  static constexpr double kTiny = 2.2250738585072014e-308;   // torch.finfo(float64).tiny
  static constexpr double kLn2 = CUDART_LN2;
};

// log of a chi-square draw with ``dof`` degrees of freedom in T:
// common.cuh log_chi2 (Marsaglia-Tsang for Gamma(dof / 2 + 1), the shape
// boost U^(2 / dof) in log space), the margin written without cancellation
template <typename T>
__device__ __forceinline__ T log_chi2_t(T dof, Philox& rng) {
  using R = Real<T>;
  const T a = T(0.5) * dof;
  const T d = a + T(1) - T(1) / T(3);
  const T c = T(1) / R::sqrt(T(9) * d);
  T log_g = R::log(d);
  T z, z_next = T(0);
  for (int r = 0; r < 100; ++r) {
    if ((r & 1) == 0) R::normal_pair(rng, z, z_next); else z = z_next;
    const T u = R::uniform_pos(rng);
    const T one_plus_cz = T(1) + c * z;
    if (one_plus_cz > T(0)) {
      const T log_v = T(3) * R::log(one_plus_cz);
      if (R::log(u) < T(0.5) * z * z + d * (log_v - R::expm1(log_v))) {
        log_g = R::log(d) + log_v;
        break;
      }
    }
  }
  return R::kLn2 + log_g + R::log(R::uniform_pos(rng)) / a;
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
    const T u = R::uniform(rng);
    int lat = 0;
    for (int k = 0; k < K - 1; ++k) lat += u >= __ldg(cumw + k) ? 1 : 0;
    latent[n] = lat;
    if (zT == nullptr) continue;
    for (int i = 0; i < D; i += 2) {
      T z0, z1;
      R::normal_pair(rng, z0, z1);
      zT[i * N + n] = z0;
      if (i + 1 < D) zT[(i + 1) * N + n] = z1;
    }
    T s = T(1);
    if (dof != nullptr) {
      const T nu = __ldg(dof + lat);
      const T chi2 = R::exp(log_chi2_t<T>(nu, rng));
      s = R::sqrt(nu / (chi2 > R::kTiny ? chi2 : R::kTiny));
    }
    scale[n] = s;
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
