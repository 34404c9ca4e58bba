// Hash dropout in one pass (#16): y[i] = keep(i) ? T(float(x[i]) / divisor)
// : 0 over the logical row-major index i of x (mod 2**32), for f32 or bf16
// x, with the fmix32 keep of common.cuh (the fused layer's in-kernel
// dropout, so the streams are the same by construction) and a true IEEE
// division by the divisor (1 - rate rounded to x's dtype, as the JAX
// package divides; a product with the reciprocal is not always the
// correctly rounded quotient).
//
// No TPU kernel: the JAX package writes this as one elementwise expression
// (models/transformer.py _dropout_from_seed over _linear_iota) that XLA
// fuses into the softmax and the products around it.  The port's plain
// version does the uint32 arithmetic in int64 with 16-bit product halves,
// about 30 passes over int64 tensors a mask.  Here it is one pass, bound
// by device-memory bytes (x read once, y written once): the hash is ~12
// integer operations and the division ~10 an element, under the bytes'
// time on the H100 for either dtype.  A contiguous x is read and y written
// 16 bytes a thread (a scalar tail, and scalar where x's view is not
// 16-byte aligned); a strided x (a permuted einsum output) is read by its
// sizes and strides, y written contiguous, with no copy before.  The seed
// term is read through a device pointer where the site's seed lives on
// the card (a CUDA graph's replays each read their own), else taken by
// value.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDims = 8;  // ops/hash_dropout.py _MAX_DIMS

struct Layout {  // sizes and strides (elements) of x, outermost first
  int ndim;
  long long size[kMaxDims];
  long long stride[kMaxDims];
};

struct Drop {
  const long long* seed_ptr;  // the seed term on the card, or null
  uint32_t seed_value;        // else this one
  uint32_t threshold;
  float divisor;

  __device__ __forceinline__ uint32_t term() const {
    return seed_ptr ? static_cast<uint32_t>(__ldg(seed_ptr)) : seed_value;
  }
};

template <typename T>
__device__ __forceinline__ T drop_one(T v, uint32_t idx, uint32_t term, const Drop& d) {
  return xrt::Act<T>::store(xrt::keep_premixed(idx, term, d.threshold)
                                ? __fdiv_rn(xrt::Act<T>::load(v), d.divisor)
                                : 0.f);
}

// contiguous x at a 16-byte aligned address: 16 bytes a thread a step
template <typename T>
__global__ void __launch_bounds__(kThreads)
    hash_dropout_vec_kernel(const T* __restrict__ x, T* __restrict__ y, long long n, Drop d) {
  constexpr int kV = 16 / sizeof(T);
  const uint32_t term = d.term();
  const long long nvec = n / kV;
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = first; i < nvec; i += step) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(x) + i);
    const T* v = reinterpret_cast<const T*>(&raw);
    uint4 o;
    T* w = reinterpret_cast<T*>(&o);
    const uint32_t base = static_cast<uint32_t>(i * kV);
#pragma unroll
    for (int j = 0; j < kV; ++j) w[j] = drop_one(v[j], base + j, term, d);
    reinterpret_cast<uint4*>(y)[i] = o;
  }
  for (long long e = nvec * kV + first; e < n; e += step)
    y[e] = drop_one(x[e], static_cast<uint32_t>(e), term, d);
}

// x by its sizes and strides; IdxT: 32-bit where n fits (the divisions
// that unravel the index are the kernel's longest instructions)
template <typename T, typename IdxT>
__global__ void __launch_bounds__(kThreads)
    hash_dropout_strided_kernel(const T* __restrict__ x, T* __restrict__ y, IdxT n, Layout L,
                                Drop d) {
  const uint32_t term = d.term();
  const IdxT step = (IdxT)gridDim.x * blockDim.x;
  for (IdxT e = (IdxT)blockIdx.x * blockDim.x + threadIdx.x; e < n; e += step) {
    IdxT rest = e;
    long long off = 0;
    for (int k = L.ndim - 1; k >= 0; --k) {
      const IdxT size = (IdxT)L.size[k];
      const IdxT q = rest / size;
      off += (long long)(rest - q * size) * L.stride[k];
      rest = q;
    }
    y[e] = drop_one(__ldg(x + off), static_cast<uint32_t>(e), term, d);
  }
}

// blocks of kThreads for ``work`` items: one wave of full SMs at most (a
// grid-stride loop takes the rest)
int grid_for(long long work) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (work + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * (2048 / kThreads);
  return (int)std::max(1LL, std::min(want, cap));
}

template <typename T>
cudaError_t launch(const void* xv, void* yv, long long n, int ndim, const long long* sizes,
                   const long long* strides, const Drop& d, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  const bool contiguous = ndim == 1 && strides[0] == 1;
  if (contiguous && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(y) & 15) == 0) {
    hash_dropout_vec_kernel<T><<<grid_for(n / (16 / sizeof(T)) + 1), kThreads, 0, s>>>(x, y, n, d);
    return cudaGetLastError();
  }
  Layout L;
  L.ndim = ndim;
  for (int k = 0; k < ndim; ++k) {
    L.size[k] = sizes[k];
    L.stride[k] = strides[k];
  }
  if (n <= 0x7FFFFFFFLL)
    hash_dropout_strided_kernel<T, uint32_t><<<grid_for(n), kThreads, 0, s>>>(x, y, (uint32_t)n, L,
                                                                              d);
  else
    hash_dropout_strided_kernel<T, unsigned long long>
        <<<grid_for(n), kThreads, 0, s>>>(x, y, (unsigned long long)n, L, d);
  return cudaGetLastError();
}

}  // namespace

// x: n elements, f32 or (is_bf16) bf16, of ndim <= kMaxDims (sizes,
// strides: host arrays, dims of one stride merged by the caller; one dim
// of stride 1 is a contiguous x); y: n contiguous elements of x's dtype;
// seed_ptr: the site's seed term (one int64 on the card) or null for
// seed_value; threshold and divisor as ops/hash_dropout.py gives them
extern "C" int hash_dropout(const void* x, void* y, long long n, int is_bf16, int ndim,
                            const long long* sizes, const long long* strides,
                            const long long* seed_ptr, uint32_t seed_value, uint32_t threshold,
                            float divisor, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (ndim < 1 || ndim > kMaxDims) return cudaErrorInvalidValue;
  const Drop d{seed_ptr, seed_value, threshold, divisor};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, y, n, ndim, sizes, strides, d, s)
                 : launch<float>(x, y, n, ndim, sizes, strides, d, s);
}
