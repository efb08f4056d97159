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
// a log and a division).  The first design (solve_dofs_serial_kernel, kept
// as variant 0) ran one thread a component through the 102 dependent
// conditions; a warp of 32 components diverged in the digamma's
// recurrence, ~1,200 clocks a step.  The design (solve_dofs_warp_kernel,
// variant 1): one warp a component, the bracket held alike in every lane;
// each round covers the next kLevels = 5 levels of the bisection tree, lane
// j the tree's node j of those 31 (breadth first), whose bracket it derives
// from the round's by the midpoint updates the serial walk makes on that
// path (at most four, no digamma) before it evaluates the condition at the
// node's midpoint; one ballot gives every node's go-right bit and every
// lane walks the taken path.  f_lo and f_hi ride on spare lanes (lane 31
// of the first rounds, or a round of their own).  100 steps are 20 rounds
// of conditions evaluated in parallel, and the lanes of a warp diverge only
// while its bracket is still wide; the digamma's recurrence is unrolled, so
// its reciprocals do not wait on each other's sums.  Each midpoint and
// each condition is the
// same floating-point operation on the same operands as in the serial
// walk, (lo + hi) then the product with 0.5 (nothing to contract), so the
// roots equal the serial kernel's bit for bit.  Both kernels are templated
// on float and double.  The digamma is PyTorch's CUDA digamma
// (ATen/native/cuda/Math.cuh, the jiterator's digamma_string) operation
// for operation, so the condition equals the plain version's on the card
// wherever the compiler contracts the same way.
#include <cmath>
#include <cuda_runtime.h>

namespace pmc {

__device__ __forceinline__ float log_of(float x) { return logf(x); }
__device__ __forceinline__ double log_of(double x) { return log(x); }

// torch.special.digamma on CUDA (the jiterator's digamma_string); with
// UNROLLED its recurrence's at most 10 passes are unrolled (x > 0 or NaN
// there, so x reaches 10 within 10): the same operations on the same
// values, each reciprocal issued without waiting for the last sum
template <typename T, bool UNROLLED = false>
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
  if constexpr (UNROLLED) {
#pragma unroll
    for (int i = 0; i < 10; ++i) {
      const bool more = x < static_cast<T>(10);
      const T inv = static_cast<T>(1) / x;
      result = more ? result - inv : result;
      x = more ? x + static_cast<T>(1) : x;
    }
  } else {
    while (x < static_cast<T>(10)) {
      result -= static_cast<T>(1) / x;
      x += static_cast<T>(1);
    }
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
template <typename T, bool UNROLLED = false>
__device__ __forceinline__ T dof_condition(T c, T nu) {
  const T half = static_cast<T>(0.5) * nu;
  return c + log_of(half) - torch_digamma<T, UNROLLED>(half);
}

template <typename T>
__device__ __forceinline__ T midpoint(T lo, T hi) {
  return static_cast<T>(0.5) * (lo + hi);
}

template <typename T>
__device__ __forceinline__ T final_root(T lo, T hi, bool below, bool above, T mindof,
                                        T maxdof, T old) {
  T root = midpoint(lo, hi);
  root = below ? mindof : root;
  root = above ? maxdof : root;
  return isfinite(root) ? root : old;
}

// variant 0: one thread a component, the steps one after another (PR 14)
template <typename T>
__global__ void solve_dofs_serial_kernel(const T* __restrict__ c, const T* __restrict__ old_dofs,
                                         T* __restrict__ out, int K, int steps, T mindof,
                                         T maxdof) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const T ck = c[k];
  const T f_lo = dof_condition(ck, mindof);
  const T f_hi = dof_condition(ck, maxdof);
  T lo = mindof, hi = maxdof;
  for (int s = 0; s < steps; ++s) {
    const T mid = midpoint(lo, hi);
    const bool go_right = dof_condition(ck, mid) > 0;
    lo = go_right ? mid : lo;
    hi = go_right ? hi : mid;
  }
  out[k] = final_root(lo, hi, f_lo < 0, f_hi > 0, mindof, maxdof, old_dofs[k]);
}

constexpr int kLevels = 5;          // bisection levels a round: 31 nodes, lane 31 spare
constexpr int kWarpThreads = 128;   // 4 components a block

// variant 1: one warp a component, kLevels levels of the bisection a round
template <typename T>
__global__ void solve_dofs_warp_kernel(const T* __restrict__ c, const T* __restrict__ old_dofs,
                                       T* __restrict__ out, int K, int steps, T mindof,
                                       T maxdof) {
  const int lane = threadIdx.x & 31;
  const int k = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (k >= K) return;   // the whole warp
  const T ck = c[k];
  T lo = mindof, hi = maxdof;
  bool below = false, above = false;   // f_lo < 0, f_hi > 0
  int ends = 0;                        // of f_lo and f_hi, those evaluated
  for (int s = 0; s < steps || ends < 2;) {
    const int levels = min(kLevels, steps - s);   // 0: a round of f_lo, f_hi alone
    const int nodes = (1 << levels) - 1;
    const int end = ends + lane - nodes;          // the end condition of a spare lane
    // node `lane` of the round's tree, breadth first (lane + 1 is a leading
    // 1 and the path's go-right bits from the root down): the midpoint of
    // its bracket; a spare lane's mindof or maxdof (past them, unused)
    T nu = end == 0 ? mindof : maxdof;
    if (lane < nodes) {
      T a = lo, b = hi;
      for (int i = 30 - __clz(lane + 1); i >= 0; --i) {
        const T mid = midpoint(a, b);
        const bool right = ((lane + 1) >> i) & 1;
        a = right ? mid : a;
        b = right ? b : mid;
      }
      nu = midpoint(a, b);
    }
    const T f = dof_condition<T, true>(ck, nu);
    const bool bit = lane < nodes ? f > 0 : end == 0 ? f < 0 : end == 1 && f > 0;
    const unsigned bits = __ballot_sync(0xffffffffu, bit);
    for (int l = 0, node = 0; l < levels; ++l) {
      const T mid = midpoint(lo, hi);
      const bool right = (bits >> node) & 1u;
      lo = right ? mid : lo;
      hi = right ? hi : mid;
      node = 2 * node + 1 + right;
    }
    const int spare = min(32 - nodes, 2 - ends);
    for (int e = ends; e < ends + spare; ++e) {
      const bool v = (bits >> (nodes + e - ends)) & 1u;
      below = e == 0 ? v : below;
      above = e == 1 ? v : above;
    }
    ends += spare;
    s += levels;
  }
  if (lane == 0) out[k] = final_root(lo, hi, below, above, mindof, maxdof, old_dofs[k]);
}

template <typename T>
int launch_solve_dofs(const void* c, const void* old_dofs, void* out, int K, int steps,
                      double mindof, double maxdof, int variant, cudaStream_t s) {
  const T* ct = static_cast<const T*>(c);
  const T* old = static_cast<const T*>(old_dofs);
  T* o = static_cast<T*>(out);
  if (variant == 0) {
    const int threads = K < 1024 ? (K + 31) / 32 * 32 : 1024;
    solve_dofs_serial_kernel<T><<<(K + threads - 1) / threads, threads, 0, s>>>(
        ct, old, o, K, steps, static_cast<T>(mindof), static_cast<T>(maxdof));
  } else {
    const int per_block = kWarpThreads / 32;
    solve_dofs_warp_kernel<T><<<(K + per_block - 1) / per_block, kWarpThreads, 0, s>>>(
        ct, old, o, K, steps, static_cast<T>(mindof), static_cast<T>(maxdof));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pmc

// c, old_dofs, out: K values of float (is_double 0) or double (1); variant
// 0 the serial kernel, 1 the warp kernel
extern "C" int pmc_solve_dofs(const void* c, const void* old_dofs, void* out, int K,
                              int steps, double mindof, double maxdof, int is_double,
                              int variant, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K < 1) return 0;
  return is_double ? pmc::launch_solve_dofs<double>(c, old_dofs, out, K, steps, mindof, maxdof,
                                                    variant, s)
                   : pmc::launch_solve_dofs<float>(c, old_dofs, out, K, steps, mindof, maxdof,
                                                   variant, s);
}
