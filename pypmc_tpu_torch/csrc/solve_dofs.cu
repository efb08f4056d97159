// solve_dofs: the [HOD12] eq. (16) degree-of-freedom update of every
// Student-t component of a PMC update -- the root in nu of
//   const_k + log(nu / 2) - digamma(nu / 2) = 0
// by a fixed number of bisection steps on [mindof, maxdof] -> dofs (K,).
//
// Replaces no Pallas kernel: the JAX package runs this bisection as a
// lax.fori_loop inside its one jitted PMC step
// (pypmc_tpu/mix_adapt/pmc.py:349-376, _solve_dofs, the loop at :367),
// where the port issued ~13 tensor operations a bisection step from the
// host, ~1,300 launches a PMC update at 100 steps.
//
// Semantics, those of the plain version (ops/kernels.py plain_solve_dofs)
// exactly: f_lo = condition(mindof), f_hi = condition(maxdof); each step
// goes right where condition(mid) > 0 (the condition decreases in nu);
// the root is the last bracket's midpoint, mindof where f_lo < 0, maxdof
// where f_hi > 0, and the old dof where it is not finite.  A NaN const
// never goes right, so its root falls to within an ulp of mindof (in
// float32 from ~51 steps on, in float64 from ~80), as in both packages.
//
// Bound on the H100: neither bytes (3 K values) nor operations (K (steps +
// 2) conditions of ~30-60 FP32 operations: ~0.1 ns at K = 10) but the
// serial chain.  Each step depends on the last: a log and a digamma (a
// division for each unit of nu / 2 below 10, then the asymptotic series,
// a log and a division), ~100-400 clocks of dependent latency, so 100
// steps take ~6-25 us at ~1.7 GHz at any K up to a block.  Design: one
// thread a component, the bracket in registers, one block of up to 1,024
// threads (more blocks past it), templated on float and double.  The digamma is
// PyTorch's CUDA digamma (ATen/native/cuda/Math.cuh, the jiterator's
// digamma_string) operation for operation, so the condition equals the
// plain version's on the card wherever the compiler contracts the same way.
#include <cmath>
#include <cuda_runtime.h>

namespace pmc {

__device__ __forceinline__ float log_of(float x) { return logf(x); }
__device__ __forceinline__ double log_of(double x) { return log(x); }

// torch.special.digamma on CUDA (the jiterator's digamma_string)
template <typename T>
__device__ T torch_digamma(T x) {
  constexpr double PI_f64 = 3.14159265358979323846;
  if (x == 0) {
    return copysign(static_cast<T>(INFINITY), -x);
  }
  T result = 0;
  if (x < 0) {
    if (x == trunc(x)) {
      return static_cast<T>(NAN);
    }
    double q, r;
    r = modf(static_cast<double>(x), &q);
    result = static_cast<T>(-PI_f64 / tan(PI_f64 * r));
    x = 1 - x;
  }
  while (x < static_cast<T>(10)) {
    result -= static_cast<T>(1) / x;
    x += static_cast<T>(1);
  }
  if (x == static_cast<T>(10)) {
    return result + static_cast<T>(2.25175258906672110764);
  }
  T y = 0;
  if (x < static_cast<T>(1.0e17)) {
    const T A[] = {
        static_cast<T>(8.33333333333333333333E-2), static_cast<T>(-2.10927960927960927961E-2),
        static_cast<T>(7.57575757575757575758E-3), static_cast<T>(-4.16666666666666666667E-3),
        static_cast<T>(3.96825396825396825397E-3), static_cast<T>(-8.33333333333333333333E-3),
        static_cast<T>(8.33333333333333333333E-2),
    };
    const T z = static_cast<T>(1) / (x * x);
    T polevl_result = 0;
    for (int i = 0; i <= 6; i++) {
      polevl_result = polevl_result * z + A[i];
    }
    y = z * polevl_result;
  }
  return log_of(x) - (static_cast<T>(0.5) / x) - y + result;
}

// const + log(nu / 2) - digamma(nu / 2), in the plain version's order
template <typename T>
__device__ __forceinline__ T dof_condition(T c, T nu) {
  const T half = static_cast<T>(0.5) * nu;
  return c + log_of(half) - torch_digamma(half);
}

template <typename T>
__global__ void solve_dofs_kernel(const T* __restrict__ c, const T* __restrict__ old_dofs,
                                  T* __restrict__ out, int K, int steps, T mindof, T maxdof) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const T ck = c[k];
  const T f_lo = dof_condition(ck, mindof);
  const T f_hi = dof_condition(ck, maxdof);
  T lo = mindof, hi = maxdof;
  for (int s = 0; s < steps; ++s) {
    const T mid = static_cast<T>(0.5) * (lo + hi);
    const bool go_right = dof_condition(ck, mid) > 0;
    lo = go_right ? mid : lo;
    hi = go_right ? hi : mid;
  }
  T root = static_cast<T>(0.5) * (lo + hi);
  root = f_lo < 0 ? mindof : root;
  root = f_hi > 0 ? maxdof : root;
  out[k] = isfinite(root) ? root : old_dofs[k];
}

template <typename T>
int launch_solve_dofs(const void* c, const void* old_dofs, void* out, int K, int steps,
                      double mindof, double maxdof, cudaStream_t s) {
  const int threads = K < 1024 ? (K + 31) / 32 * 32 : 1024;
  const int blocks = (K + threads - 1) / threads;
  solve_dofs_kernel<T><<<blocks, threads, 0, s>>>(
      static_cast<const T*>(c), static_cast<const T*>(old_dofs), static_cast<T*>(out), K,
      steps, static_cast<T>(mindof), static_cast<T>(maxdof));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pmc

// c, old_dofs, out: K values of float (is_double 0) or double (1)
extern "C" int pmc_solve_dofs(const void* c, const void* old_dofs, void* out, int K,
                              int steps, double mindof, double maxdof, int is_double,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K < 1) return 0;
  return is_double ? pmc::launch_solve_dofs<double>(c, old_dofs, out, K, steps, mindof, maxdof, s)
                   : pmc::launch_solve_dofs<float>(c, old_dofs, out, K, steps, mindof, maxdof, s);
}
