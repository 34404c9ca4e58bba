// Throughput probe: K chained iterations of one arithmetic mix over a
// tile of f32 values, each element's chain kept in a register.
//
// Replaces the TPU Pallas kernel ops/vpu_calibration.py:_chain_kernel of
// the JAX package (transformer_recommenders_tpu), which runs the chain over
// a VMEM-resident tile to measure the TPU's vector-unit rate.  On the H100
// the same chains measure the rates at which an SM dispatches instructions:
//   fma     0.999 * x * (2 - x)          FP32 pipes: FADD, FMUL, FMUL
//   exp     expf(x * 1e-8)               FP32 pipes around one MUFU.EX2
//   select  x > 0.5 ? x * 0.999 : x + 0.001   compare, select, FMUL, FADD
// counted, as the JAX package counts them (OPS_PER_ITER), as 3, 2 and 4
// element operations per iteration.  The bodies cannot fold: the damped
// logistic map squares its polynomial degree at each step (see the JAX
// module's docstring for the affine bodies that folded), the exp chain is
// a transcendental of a transcendental, and the select's branch depends on
// the value.  Built without --use_fast_math, so expf is the accurate
// sequence, not a bare MUFU.EX2.
//
// What bounds it: only instruction dispatch.  An element's chain is serial
// (about 4 cycles of latency per FP32 step), so the rate comes from how many
// independent chains an SM holds: blocks of 256 threads, 8 resident per SM
// (2048 threads, at most 32 registers each), each thread two chains.  A
// block then covers 512 elements, one row of the calibration tile, so a
// tile of (8 x SMs, 512) is exactly one full wave; the load and the store
// are one coalesced pass each, outside the chain.  Any other size (the
// JAX package's (1024, 512)) runs too, with a partial wave.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kPerThread = 2;  // independent chains per thread

enum Mix { kFma = 0, kExp = 1, kSelect = 2 };

template <int kMix>
__device__ __forceinline__ float step(float x) {
  if constexpr (kMix == kFma) {
    return 0.999f * x * (2.f - x);
  } else if constexpr (kMix == kExp) {
    return expf(x * 1e-8f);
  } else {
    return x > 0.5f ? x * 0.999f : x + 0.001f;
  }
}

template <int kMix>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    vpu_chain_kernel(const float* __restrict__ x, float* __restrict__ y, int n, int iters) {
  const int base = blockIdx.x * (kThreads * kPerThread) + threadIdx.x;
  float v[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = base + j * kThreads;
    v[j] = i < n ? x[i] : 0.f;
  }
#pragma unroll 8
  for (int k = 0; k < iters; ++k) {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) v[j] = step<kMix>(v[j]);
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = base + j * kThreads;
    if (i < n) y[i] = v[j];
  }
}

}  // namespace

// y = iters chained steps of ``mix`` (0 fma, 1 exp, 2 select) over the n
// f32 values of x; iters must be a multiple of 8, as in the JAX kernel
extern "C" int vpu_chain(const float* x, float* y, int n, int iters, int mix, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (iters < 0 || iters % 8 != 0) return cudaErrorInvalidValue;
  const int per_block = kThreads * kPerThread;
  const int blocks = (n + per_block - 1) / per_block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mix) {
    case kFma: vpu_chain_kernel<kFma><<<blocks, kThreads, 0, s>>>(x, y, n, iters); break;
    case kExp: vpu_chain_kernel<kExp><<<blocks, kThreads, 0, s>>>(x, y, n, iters); break;
    case kSelect: vpu_chain_kernel<kSelect><<<blocks, kThreads, 0, s>>>(x, y, n, iters); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
