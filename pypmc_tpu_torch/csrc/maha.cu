// fused_maha: ||A_k (x - m_k)||^2 of transposed particles xT (D, N) for K
// general (D, D) matrices A_k -> (K, N), n fastest.
//
// Replaces the Pallas kernel pypmc_tpu/ops/pallas_kernels.py:858
// (fused_maha, body _maha_kernel).  The TPU kernel takes b_k = A_k m_k and
// a coordinate center to keep its split-precision product accurate; here
// the difference x - m_k is formed first and multiplied in FP32 FMA, so
// there is no cancellation to guard against.
//
// Bound on the H100: per particle it reads D floats, writes K, and does
// K D^2 FMAs -- at K = 32, D = 40 51,200 FMAs for 160 bytes read and 128
// written: FMA-bound.  A is read whole: the callers pass lower (inverse
// Cholesky factors) and upper (transposed Cholesky factors of Wishart
// scales) matrices alike.
// Design, 9 <= D <= 64 (from mma.cuh kMahaMmaDMin)
// (maha_mma_kernel): the tensor-core product of mma.cuh, mma.sync m16n8k8 in
// three split TF32 products, 32 particles a warp (16 past D = 40), the
// components split once as they are staged; elsewhere to D = 64 it is forced
// (variant "mma"), as the record kernel is where it is not elected.
// Design, D > 64 (maha_mma_tiled_kernel, after mma_split_kernel<false>):
// the paneled tensor-core product of mma_tiled.cuh, A split once a launch into
// the wrapper's scratch, 128 particles x 128 rows of A_k a block, 64 x 32 a
// warp, 32-deep panels in a ring of three cp.async buffers; elected at every
// D past 64, the tiled kernel below forcible (variant "tiled").
// Design, D <= 64 (maha_kernel, the record kernel): 256 threads a block,
// one particle a thread,
// x and x - m_k in registers (DMAX 8 to 64), the components as 16-byte VB
// records (common.cuh vb_rec_floats: m | 4 zeros | A's rows padded to
// float4s; at D = 40 6,576 B) read by broadcast LDS.128 in project's FMA
// order -- 10 LDS.128 a row of A at D = 40 where a scalar load a FMA took 40
// -- and each (k, n) result written once, coalesced.  The records stream
// through shared memory (common.cuh eval_plan, stream_records): the whole
// set where it fits an SM's half, else chunks in two buffers filled by
// cp.async while the other is read (K = 32, D = 40: 8 components a chunk,
// 2 x 52,608 B, 2 blocks an SM).  Every block walks all chunks for its
// particles; the output has no reduction over k.  What holds it (measured
// on one H100): a broadcast LDS.128 takes ~4 clocks of the SM's 128 B a
// clock of shared-memory data path, so each A word read feeds one FMA, ~1/4
// of the FP32 peak; two particles a thread would halve that but take 2 x
// 80 registers at D = 40, past the 128 that 16 warps an SM allow.  At every
// D, forced only (variant "tiled"), maha_tiled_kernel, the block-tiled FP32
// product engine of tiled.cuh: A is read whole, a tile of 128 particles
// shares every panel of A_k that a block stages, and each (k, n) result is
// written once, coalesced.
#include "tiled.cuh"

namespace pmc {

template <int DMAX>
__global__ void __launch_bounds__(kEvalThreads, eval_min_blocks(DMAX))
maha_kernel(const float* __restrict__ xT, const float* __restrict__ ops,
            float* __restrict__ out, long long N, int K, int D) {
  extern __shared__ float4 smem4[];
  constexpr int below = eval_dmax_below(DMAX);
  __builtin_assume(D > below && D <= DMAX);   // dispatch_records'
  const float* m = ops + K * D * D;
  const int F = vb_rec_floats(D);
  stream_records<DMAX>(
      reinterpret_cast<float*>(smem4), xT, N, K, D, F, eval_plan(K, D, true),
      [&](float* dst, int k0, int kc) {
        stage_records_async(dst, m, ops, m, 0, K, k0, kc, D, false);
      },
      [&](const float* recs, int k0, int kc, const float (&x)[DMAX], long long n) {
        for (int c = 0; c < kc; ++c) {
          const float v = project_rec<DMAX>(recs + c * F, x, D, [](int, float) {});
          if (n < N) out[static_cast<long long>(k0 + c) * N + n] = v;
        }
      });
}

// DP: D padded to 8 (dispatch_mma); two blocks an SM (mma_plan's shared
// memory)
template <int DP>
__global__ void __launch_bounds__(mma_threads(DP), 2)
maha_mma_kernel(const float* __restrict__ xT, const float* __restrict__ ops,
                float* __restrict__ out, long long N, int K, int D) {
  extern __shared__ float4 smem4[];
  __builtin_assume(D > DP - 8 && D <= DP);   // dispatch_mma's
  mma_maha<DP>(reinterpret_cast<float*>(smem4), xT, ops, ops + static_cast<long long>(K) * D * D,
               out, N, K, D);
}

// split: mma_split_kernel<false>'s output for ops' A; one block an SM
__global__ void __launch_bounds__(kMtThreads, 1)
maha_mma_tiled_kernel(const float* __restrict__ xT, const float* __restrict__ ops,
                      const float4* __restrict__ split, float* __restrict__ out, long long N,
                      int K, int D) {
  extern __shared__ float4 smem4[];
  const float* m = ops + static_cast<long long>(K) * D * D;
  mma_tiled_maha(reinterpret_cast<float*>(smem4), xT, ops, m, split, out, N, K, D);
}

__global__ void __launch_bounds__(kTileThreads, 2)
maha_tiled_kernel(const float* __restrict__ xT, const float* __restrict__ ops,
                  float* __restrict__ out, long long N, int K, int D) {
  extern __shared__ float4 smem4[];
  const float* m = ops + static_cast<long long>(K) * D * D;
  tiled_eval<false>(reinterpret_cast<float*>(smem4), xT, ops, m, N, K, D,
                    [&](int k, long long n, float v) {
                      if (n < N) out[k * N + n] = v;
                    });
}

// fused_maha's kernels for with_eval_variant
struct MahaKernels {
  static constexpr bool maha = true;
  template <int DMAX>
  static auto rec() { return maha_kernel<DMAX>; }
  static auto tiled() { return maha_tiled_kernel; }
  template <int DP>
  static auto mma() { return maha_mma_kernel<DP>; }
};

}  // namespace pmc

// shared memory the elected kernel asks for (checked against ops/_build.py)
extern "C" long long pmc_maha_smem_bytes(int K, int D) {
  return static_cast<long long>(pmc::eval_variant_smem(K, D, true));
}

// blocks of variant's kernel (-1 the elected one) that fit on one SM at once
// (registers, shared memory and threads), for the wrapper's grid; -1 on an
// error
extern "C" int pmc_maha_per_sm(int K, int D, int variant) {
  using namespace pmc;
  if (eval_mma_tiled(D, variant, true)) {
    if (!eval_has_variant(D, kEvalMma, true)) return -1;
    return mma_tiled_per_sm(maha_mma_tiled_kernel);
  }
  return eval_variant_per_sm<MahaKernels>(K, D, variant);
}

// the kernel fused_maha elects at D (1 record, 2 tiled, 3 tensor-core;
// checked against ops/_build.py eval_variant)
extern "C" int pmc_maha_variant(int D) { return pmc::maha_variant(D); }

// the tensor-core kernel's plan at (K, D <= 64): out = {components a chunk,
// chunks, x tiles, particles a block tile, floats of a split component};
// the shared memory a block
extern "C" long long pmc_maha_mma_plan(int K, int D, int* out) {
  const pmc::MmaPlan plan = pmc::mma_plan(K, D);
  out[0] = plan.kc;
  out[1] = plan.n_chunks;
  out[2] = plan.x_buffers;
  out[3] = pmc::mma_tile(D);
  out[4] = pmc::mma_split_floats(D);
  return static_cast<long long>(plan.smem);
}

// the tensor-core kernel's plan past D = 64: out = {particles a tile, rows
// a row tile, depth of a panel, threads a block, step buffers}; the shared
// memory a block
extern "C" long long pmc_maha_mma_tiled_plan(int* out) {
  out[0] = pmc::kMtP;
  out[1] = pmc::kMtM;
  out[2] = pmc::kMtK;
  out[3] = pmc::kMtThreads;
  out[4] = pmc::kMtStages;
  return static_cast<long long>(pmc::kMmaTiledSmem);
}

// floats of the split operand the tensor-core kernel past D = 64 takes
extern "C" long long pmc_maha_mma_scratch_floats(int K, int D) {
  return pmc::mma_scratch_floats(K, D);
}

// variant: -1 the elected kernel (maha_variant), 1 the record, 2 the tiled,
// 3 the tensor-core kernel; scratch: mma_scratch_floats(K, D) floats, 16-byte
// aligned, where that is the tensor-core kernel past D = 64 (else unused)
extern "C" int pmc_fused_maha(const float* xT, const float* ops, float* scratch, float* out,
                              long long N, int K, int D, int variant, int n_blocks,
                              void* stream) {
  using namespace pmc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (eval_mma_tiled(D, variant, true))
    return launch_mma_tiled<false>(maha_mma_tiled_kernel, ops, scratch, K, D, n_blocks, s,
                                   [&](const float4* split) {
                                     maha_mma_tiled_kernel<<<n_blocks, kMtThreads, kMmaTiledSmem,
                                                             s>>>(xT, ops, split, out, N, K, D);
                                   });
  const int bad = with_eval_variant<MahaKernels>(K, D, variant, [&](auto kernel, int threads,
                                                                     size_t smem) {
    kernel<<<n_blocks, threads, smem, s>>>(xT, ops, out, N, K, D);
    return 0;
  });
  if (bad != 0) return bad;
  return static_cast<int>(cudaGetLastError());
}
