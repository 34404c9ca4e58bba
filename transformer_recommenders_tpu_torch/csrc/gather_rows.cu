// Embedding-row gather and its gradient.
//
// gather_rows_fwd: out[r, :] = OutT(table[idx[r], :]); an index outside
// [0, N) gives a zero row.  Replaces the TPU Pallas kernel
// ops/gather_matmul.py:_fwd_kernel of the JAX package, which computes the
// same rows as a one-hot (rows x N) MXU matmul because row gathers are slow
// on a TPU.  On the H100 a gather is a plain copy: it is bound by
// device-memory bytes (R*D table entries read, R*D OutT written, R int32 or
// int64 indices), so the kernel is a row copy with one warp per row and
// 16-byte vector loads where an f32 row allows them.  A bf16 output of an
// f32 table rounds each entry to nearest even, exactly what the one-hot
// matmul's f32 accumulation of bf16 table values gives; a bf16 table is
// copied as it is.
//
// gather_rows_bwd: dtable[n, :] = TabT(sum over r with idx[r] == n of
// g[r, :]), summed in f32.  Replaces ops/gather_matmul.py:_bwd_kernel, the
// transposed one-hot matmul (scatter-add as onehot^T @ g).  Bound by bytes
// as well (R*D cotangents read, N*D written).  The kernel is deterministic
// and uses no atomics: the wrapper sorts the indices once (stable, so equal
// indices keep their row order), and one warp per table row finds its
// segment of the sorted indices by binary search and sums the rows of that
// segment in increasing row order.  Every table row is written exactly
// once (zero where no index names it), so dtable needs no clearing, and
// an index outside [0, N) matches no table row.
#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;

template <typename TabT, typename OutT, typename IdxT>
__global__ void gather_rows_kernel(const TabT* __restrict__ table,
                                   const IdxT* __restrict__ idx, OutT* __restrict__ out,
                                   int N, int D, int R) {
  const int r = blockIdx.x * kRowsPerBlock + threadIdx.y;
  if (r >= R) return;
  const IdxT i = idx[r];
  const bool valid = i >= 0 && i < N;
  const TabT* src = table + (size_t)(valid ? i : 0) * D;
  OutT* dst = out + (size_t)r * D;
  if constexpr (sizeof(TabT) == 4) {
    if ((D & 3) == 0 && (reinterpret_cast<uintptr_t>(table) & 15) == 0) {
      const float4* src4 = reinterpret_cast<const float4*>(src);
      for (int c = threadIdx.x; c < D / 4; c += 32) {
        const float4 v = valid ? __ldg(src4 + c) : make_float4(0.f, 0.f, 0.f, 0.f);
        dst[4 * c + 0] = xrt::Act<OutT>::store(v.x);
        dst[4 * c + 1] = xrt::Act<OutT>::store(v.y);
        dst[4 * c + 2] = xrt::Act<OutT>::store(v.z);
        dst[4 * c + 3] = xrt::Act<OutT>::store(v.w);
      }
      return;
    }
  }
  for (int c = threadIdx.x; c < D; c += 32)
    dst[c] = xrt::Act<OutT>::store(valid ? xrt::Act<TabT>::load(src[c]) : 0.f);
}

// first position in sorted[0, R) whose value is >= key
__device__ __forceinline__ int lower_bound(const long long* __restrict__ sorted, int R,
                                           long long key) {
  int lo = 0, hi = R;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sorted[mid] < key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// one warp per table row n; lanes split the D columns
template <typename GT, typename TabT>
__global__ void gather_rows_bwd_kernel(const GT* __restrict__ g,
                                       const long long* __restrict__ sorted_idx,
                                       const long long* __restrict__ order,
                                       TabT* __restrict__ dtable, int N, int D, int R) {
  const int n = blockIdx.x * kRowsPerBlock + threadIdx.y;
  if (n >= N) return;
  const int begin = lower_bound(sorted_idx, R, n);
  const int end = lower_bound(sorted_idx, R, (long long)n + 1);
  TabT* dst = dtable + (size_t)n * D;
  for (int c = threadIdx.x; c < D; c += 32) {
    float acc = 0.f;
    for (int j = begin; j < end; ++j)
      acc += xrt::Act<GT>::load(g[(size_t)order[j] * D + c]);
    dst[c] = xrt::Act<TabT>::store(acc);
  }
}

template <typename TabT, typename OutT, typename IdxT>
cudaError_t launch_fwd(const void* table, const void* idx, void* out, int N, int D, int R,
                       cudaStream_t stream) {
  const dim3 block(32, kRowsPerBlock);
  const dim3 grid((R + kRowsPerBlock - 1) / kRowsPerBlock);
  gather_rows_kernel<TabT, OutT, IdxT><<<grid, block, 0, stream>>>(
      static_cast<const TabT*>(table), static_cast<const IdxT*>(idx),
      static_cast<OutT*>(out), N, D, R);
  return cudaGetLastError();
}

template <typename TabT, typename OutT>
cudaError_t launch_fwd_idx(const void* table, const void* idx, void* out, int N, int D, int R,
                           int idx_is_64, cudaStream_t s) {
  return idx_is_64 ? launch_fwd<TabT, OutT, long long>(table, idx, out, N, D, R, s)
                   : launch_fwd<TabT, OutT, int>(table, idx, out, N, D, R, s);
}

template <typename GT, typename TabT>
cudaError_t launch_bwd(const void* g, const long long* sorted_idx, const long long* order,
                       void* dtable, int N, int D, int R, cudaStream_t stream) {
  const dim3 block(32, kRowsPerBlock);
  const dim3 grid((N + kRowsPerBlock - 1) / kRowsPerBlock);
  gather_rows_bwd_kernel<GT, TabT><<<grid, block, 0, stream>>>(
      static_cast<const GT*>(g), sorted_idx, order, static_cast<TabT*>(dtable), N, D, R);
  return cudaGetLastError();
}

}  // namespace

// table is f32 or (table_is_bf16) bf16; idx holds int32 or (idx_is_64)
// int64 indices
extern "C" int gather_rows_fwd(const void* table, const void* idx, void* out, int N, int D,
                               int R, int table_is_bf16, int out_is_bf16, int idx_is_64,
                               void* stream) {
  if (R <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_is_bf16)
    return out_is_bf16
               ? launch_fwd_idx<__nv_bfloat16, __nv_bfloat16>(table, idx, out, N, D, R, idx_is_64, s)
               : launch_fwd_idx<__nv_bfloat16, float>(table, idx, out, N, D, R, idx_is_64, s);
  return out_is_bf16 ? launch_fwd_idx<float, __nv_bfloat16>(table, idx, out, N, D, R, idx_is_64, s)
                     : launch_fwd_idx<float, float>(table, idx, out, N, D, R, idx_is_64, s);
}

// g: (R, D) cotangent rows, f32 or (g_is_bf16) bf16; sorted_idx and order:
// the indices sorted stably and the row each came from; dtable: (N, D), f32
// or (dtable_is_bf16) bf16
extern "C" int gather_rows_bwd(const void* g, const long long* sorted_idx,
                               const long long* order, void* dtable, int N, int D, int R,
                               int g_is_bf16, int dtable_is_bf16, void* stream) {
  if (N <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_is_bf16)
    return dtable_is_bf16
               ? launch_bwd<__nv_bfloat16, __nv_bfloat16>(g, sorted_idx, order, dtable, N, D, R, s)
               : launch_bwd<__nv_bfloat16, float>(g, sorted_idx, order, dtable, N, D, R, s);
  return dtable_is_bf16
             ? launch_bwd<float, __nv_bfloat16>(g, sorted_idx, order, dtable, N, D, R, s)
             : launch_bwd<float, float>(g, sorted_idx, order, dtable, N, D, R, s);
}
