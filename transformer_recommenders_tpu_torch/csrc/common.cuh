// Shared device helpers for the port's kernels: activation-type traits
// (bf16 or f32 storage, f32 arithmetic), the counter-based dropout hash
// and warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace xrt {

// premix constants of ops/hash_dropout.py
constexpr uint32_t kPremixIdx = 0x9E3779B1u;
constexpr uint32_t kPremixSeed = 0x85EBCA77u;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// keep iff fmix32(idx*PREMIX_IDX + seed*PREMIX_SEED) >= threshold, all
// arithmetic modulo 2**32
__device__ __forceinline__ bool keep(uint32_t idx, uint32_t seed,
                                     uint32_t threshold) {
  return fmix32(idx * kPremixIdx + seed * kPremixSeed) >= threshold;
}

// Activations are stored as T and computed on in f32; ``round`` gives the
// f32 value of the nearest T (round-to-nearest-even, as a JAX astype).
template <typename T>
struct Act;

template <>
struct Act<float> {
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Act<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// --- score tiles of the InfoNCE kernels (bf16 operands, f32 sums) ---

__device__ __forceinline__ float bf(__nv_bfloat16 v) { return __bfloat162float(v); }

// rows [row0, row0 + nrows) of a (rows_total, D) bf16 matrix into f32
// shared memory with leading dimension ld, zero past rows_total
__device__ inline void load_rows(const __nv_bfloat16* __restrict__ src, int rows_total, int D,
                                 int row0, int nrows, float* dst, int ld) {
  for (int i = threadIdx.x; i < nrows * D; i += blockDim.x) {
    const int r = i / D, k = i % D;
    dst[r * ld + k] = row0 + r < rows_total ? bf(src[(size_t)(row0 + r) * D + k]) : 0.f;
  }
}

// four scores' chains a . b[j * bstride], each one fmaf chain over k in
// order.  A product of two bf16 values is exact in f32, so the chain
// rounds the same wherever it runs and whichever operand comes first.
__device__ __forceinline__ void dot4(const float* a, const float* b, int bstride, int D,
                                     float acc[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j] = 0.f;
  for (int k = 0; k < D; ++k) {
    const float av = a[k];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] = fmaf(av, b[j * bstride + k], acc[j]);
  }
}

// pos of query rows [r0, r0 + nrows), their q rows staged in sq (leading
// dimension ld): the chain of products with each row's positive, read
// from device memory, in the order of dot4, then times scale (one
// unfused multiply; exact at scale 1).  Zero past R.
__device__ inline void positives(const float* sq, int ld, const __nv_bfloat16* __restrict__ p,
                                 int R, int D, int r0, int nrows, float scale, float* spos) {
  for (int t = threadIdx.x; t < nrows; t += blockDim.x) {
    const int r = r0 + t;
    float pos = 0.f;
    if (r < R) {
      const __nv_bfloat16* row = p + (size_t)r * D;
      float acc = 0.f;
      for (int k = 0; k < D; ++k) acc = fmaf(sq[t * ld + k], bf(row[k]), acc);
      pos = __fmul_rn(acc, scale);
    }
    spos[t] = pos;
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace xrt
