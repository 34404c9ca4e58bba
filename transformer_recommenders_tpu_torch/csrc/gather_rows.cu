// Embedding-row gather and its gradient.
//
// gather_rows_fwd: out[r, :] = OutT(table[idx[r], :]); an index outside
// [0, N) gives a zero row.  Replaces the TPU Pallas kernel
// ops/gather_matmul.py:_fwd_kernel of the JAX package, which computes the
// same rows as a one-hot (rows x N) MXU matmul because row gathers are slow
// on a TPU.  On the H100 a gather is a plain copy, bound by device-memory
// bytes (each index read once, each distinct table row read once, R*D OutT
// written) and, at the main path's sizes (1-6 MB), by the latency of one
// launch and two dependent memory round trips (the index, then the row).
// So the kernel works on a flat space of items, each 16 bytes of output
// (8 bf16 or 4 f32 values of one row), with every access 16 bytes wide
// whatever the dtypes: an f32 -> bf16 item loads two float4 and stores one
// uint4 of 8 values rounded to nearest even (__float22bfloat162_rn, what
// the one-hot matmul's f32 accumulation of bf16 table values gives), a
// bf16 -> bf16 or f32 -> f32 item is a uint4 copy.  The grid is at most one
// wave (about two blocks an SM, up to eight where the work is larger), and
// each thread takes kGatherItems items a pass: it loads all their indices,
// then issues all their row loads (read-only path, __ldg) before any store,
// so every load of a thread is in flight at once.  An item whose row or
// output does not allow a 16-byte access (a width that is not a multiple
// of the item, a table view not 16-byte aligned) is copied element by
// element with the same rounding, so the rows are the same bits either way.
//
// gather_rows_launch_floor launches an empty kernel with the forward's
// grid: the launch cost under the kernel's time.
//
// gather_rows_bwd: dtable[n, :] = TabT(sum over r with idx[r] == n of
// g[r, :]), summed in f32.  Replaces ops/gather_matmul.py:_bwd_kernel, the
// transposed one-hot matmul (scatter-add as onehot^T @ g).  Bound by bytes
// as well (R*D cotangents read, N*D written).  The wrapper sorts the
// indices once (stable, so equal indices keep their row order); the sorted
// positions are a list of segments, one per named table row, and a
// batch's padding row 0 owns a long one (every trailing zero of the batch,
// about a third of the rows of a train step).  So the sum is a
// deterministic segmented reduction in two passes, with no atomics:
//   1. one block per chunk of kChunk sorted positions: the block stages the
//      chunk's cotangent rows in shared memory, then each thread walks the
//      chunk in order for its columns, summing each run of equal indices in
//      f32.  A run that the chunk holds whole is its
//      table row's sum and is written there; a run that goes on into the
//      chunk before or after is written to the chunk's partials: slot 0
//      for its first run, slot 1 for its last;
//   2. one warp per table row: the segment's bounds by binary search; a
//      segment inside one chunk was written by pass 1, an empty one is
//      written zero, and a segment across chunks adds its chunks' partials
//      in chunk order.
// Every table row is written exactly once, so dtable needs no clearing,
// and an index outside [0, N) matches no table row.  The plain version
// (gather_rows_backward_reference) sums in the same order.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;  // pass 2 of the backward: table rows a block
constexpr int kGatherThreads = 256;
constexpr int kGatherItems = 4;  // items a thread has in flight

// One item: the 16 output bytes at elements [e0, e0 + kE) of output row r.
template <typename TabT, typename OutT>
struct GatherItem {
  static constexpr int kE = 16 / sizeof(OutT);          // output elements an item
  static constexpr int kLoad = kE * (int)sizeof(TabT);  // table bytes an item
  uint4 raw[kLoad > 16 ? 2 : 1];

  __device__ __forceinline__ void load(const TabT* src) {
    if constexpr (kLoad == 32) {
      raw[0] = __ldg(reinterpret_cast<const uint4*>(src));
      raw[1] = __ldg(reinterpret_cast<const uint4*>(src) + 1);
    } else if constexpr (kLoad == 16) {
      raw[0] = __ldg(reinterpret_cast<const uint4*>(src));
    } else {  // bf16 -> f32: 8 table bytes
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(src));
      raw[0] = make_uint4(v.x, v.y, 0u, 0u);
    }
  }
  __device__ __forceinline__ void zero() {
    for (auto& v : raw) v = make_uint4(0u, 0u, 0u, 0u);
  }
  __device__ __forceinline__ uint4 out() const {
    if constexpr (std::is_same<TabT, OutT>::value) {
      return raw[0];
    } else if constexpr (kLoad == 32) {  // f32 -> bf16: 8 values, 4 pairs
      uint4 o;
      uint32_t* w = &o.x;
      const float* f = reinterpret_cast<const float*>(raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 h = __float22bfloat162_rn(make_float2(f[2 * i], f[2 * i + 1]));
        w[i] = *reinterpret_cast<const uint32_t*>(&h);
      }
      return o;
    } else {  // bf16 -> f32: 4 values
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(raw);
      return make_uint4(__float_as_uint(xrt::bf(h[0])), __float_as_uint(xrt::bf(h[1])),
                        __float_as_uint(xrt::bf(h[2])), __float_as_uint(xrt::bf(h[3])));
    }
  }
};

// ItT indexes the items: uint32_t where they all fit in 31 bits (the
// main path's gathers, where a 64-bit division would cost), else 64-bit
template <typename TabT, typename OutT, typename IdxT, typename ItT>
__global__ void __launch_bounds__(kGatherThreads) gather_rows_kernel(
    const TabT* __restrict__ table, const IdxT* __restrict__ idx, OutT* __restrict__ out, int N,
    int D, ItT per_row, ItT total) {
  using Item = GatherItem<TabT, OutT>;
  constexpr int kE = Item::kE;
  const ItT stride = (ItT)gridDim.x * blockDim.x;
  for (ItT base = (ItT)blockIdx.x * blockDim.x + threadIdx.x; base < total;
       base += stride * kGatherItems) {
    IdxT ix[kGatherItems];
#pragma unroll
    for (int u = 0; u < kGatherItems; ++u) {
      const ItT it = base + u * stride;
      ix[u] = it < total ? __ldg(idx + it / per_row) : IdxT(-1);
    }
    Item v[kGatherItems];
    bool vec[kGatherItems];
#pragma unroll
    for (int u = 0; u < kGatherItems; ++u) {
      const ItT it = base + u * stride;
      const ItT r = it / per_row;
      const int e0 = (int)(it - r * per_row) * kE;
      const TabT* src = table + (size_t)ix[u] * D + e0;
      const OutT* dst = out + (size_t)r * D + e0;
      vec[u] = it < total && e0 + kE <= D &&
               (reinterpret_cast<uintptr_t>(src) & (Item::kLoad >= 16 ? 15 : 7)) == 0 &&
               (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
      if (vec[u] && ix[u] >= 0 && ix[u] < N) v[u].load(src);
      else v[u].zero();
    }
#pragma unroll
    for (int u = 0; u < kGatherItems; ++u) {
      const ItT it = base + u * stride;
      if (it >= total) break;
      const ItT r = it / per_row;
      const int e0 = (int)(it - r * per_row) * kE;
      OutT* dst = out + (size_t)r * D + e0;
      if (vec[u]) {
        *reinterpret_cast<uint4*>(dst) = v[u].out();
      } else {  // the scalar tail: a partial item, or an unaligned row
        const bool valid = ix[u] >= 0 && ix[u] < N;
        const TabT* src = table + (size_t)(valid ? ix[u] : 0) * D + e0;
        for (int e = 0; e < kE && e0 + e < D; ++e)
          dst[e] = xrt::Act<OutT>::store(valid ? xrt::Act<TabT>::load(src[e]) : 0.f);
      }
    }
  }
}

__global__ void empty_kernel() {}

constexpr int kChunk = 64;        // sorted positions per block of pass 1 (gather_matmul._CHUNK)
constexpr int kChunkThreads = 128;
constexpr int kBatch = 8;         // pass 2: partial rows loaded at once

// Pass 1: block c sums the runs of sorted positions [c * kChunk, ...).  The
// block first stages the chunk's cotangent rows in shared memory (all its
// loads in flight at once, 16 bytes a thread where D allows), then each
// thread walks the chunk in order for its columns.  partial is
// (2 * chunks, D) f32.
template <typename GT, typename TabT>
__global__ void __launch_bounds__(kChunkThreads) segment_chunk_kernel(
    const GT* __restrict__ g, const long long* __restrict__ sorted_idx,
    const long long* __restrict__ order, TabT* __restrict__ dtable, float* __restrict__ partial,
    int N, int D, int R) {
  extern __shared__ __align__(16) unsigned char smem[];
  GT* rows = reinterpret_cast<GT*>(smem);  // kChunk x D
  __shared__ long long s_idx[kChunk + 2];  // the chunk's indices and one beyond each end
  __shared__ long long s_row[kChunk];
  const int c0 = blockIdx.x * kChunk, len = min(kChunk, R - c0);
  for (int j = threadIdx.x; j < len; j += blockDim.x) {
    s_idx[j + 1] = sorted_idx[c0 + j];
    s_row[j] = order[c0 + j];
  }
  if (threadIdx.x == 0) {
    s_idx[0] = c0 > 0 ? sorted_idx[c0 - 1] : -1;
    s_idx[len + 1] = c0 + len < R ? sorted_idx[c0 + len] : -1;
  }
  __syncthreads();
  constexpr int kVec = 16 / sizeof(GT);
  if (D % kVec == 0 && (reinterpret_cast<uintptr_t>(g) & 15) == 0) {
    const int per_row = D / kVec;
    for (int i = threadIdx.x; i < len * per_row; i += blockDim.x) {
      const int j = i / per_row, v = i % per_row;
      reinterpret_cast<uint4*>(rows)[i] =
          __ldg(reinterpret_cast<const uint4*>(g + (size_t)s_row[j] * D) + v);
    }
  } else {
    for (int i = threadIdx.x; i < len * D; i += blockDim.x)
      rows[i] = g[(size_t)s_row[i / D] * D + i % D];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    float acc = 0.f;
    int start = 0;
    for (int j = 0; j < len; ++j) {
      const long long idx = s_idx[j + 1];
      const float v = xrt::Act<GT>::load(rows[j * D + c]);
      if (j == 0 || idx != s_idx[j]) {
        acc = v;
        start = j;
      } else {
        acc += v;
      }
      const bool run_ends = j + 1 == len || s_idx[j + 2] != idx;
      if (!run_ends || idx < 0 || idx >= N) continue;
      const bool open_left = start == 0 && s_idx[0] == idx;
      const bool open_right = j + 1 == len && s_idx[len + 1] == idx;
      if (!open_left && !open_right)
        dtable[(size_t)idx * D + c] = xrt::Act<TabT>::store(acc);
      else
        partial[((size_t)blockIdx.x * 2 + (start == 0 ? 0 : 1)) * D + c] = acc;
    }
  }
}

// Pass 2: one warp per table row n; the segment's two bounds searched
// together; lanes split the D columns, four at a time where D allows,
// loading kBatch chunks' partials before adding them in chunk order
template <typename TabT>
__global__ void segment_rows_kernel(const long long* __restrict__ sorted_idx,
                                    const float* __restrict__ partial, TabT* __restrict__ dtable,
                                    int N, int D, int R) {
  const int n = blockIdx.x * kRowsPerBlock + threadIdx.y;
  if (n >= N) return;
  int lo = 0, hi = R, lo2 = 0, hi2 = R;  // first position >= n, first > n
  while (lo < hi || lo2 < hi2) {
    if (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (sorted_idx[mid] < n) lo = mid + 1;
      else hi = mid;
    }
    if (lo2 < hi2) {
      const int mid = (lo2 + hi2) >> 1;
      if (sorted_idx[mid] <= n) lo2 = mid + 1;
      else hi2 = mid;
    }
  }
  const int begin = lo, end = lo2;
  const int cb = begin / kChunk, ce = (end - 1) / kChunk;
  if (begin < end && cb == ce) return;  // pass 1 wrote the whole run
  TabT* dst = dtable + (size_t)n * D;
  const size_t first = ((size_t)cb * 2 + (begin == cb * kChunk ? 0 : 1)) * D;
  const int cols = D % 4 == 0 ? 4 : 1;
  for (int c = threadIdx.x * cols; c < D; c += 32 * cols) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if (begin < end) {
      for (int i = 0; i < cols; ++i) acc[i] = partial[first + c + i];
      for (int ch0 = cb + 1; ch0 <= ce; ch0 += kBatch) {
        float v[kBatch][4];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const float* src = partial + (size_t)(ch0 + k) * 2 * D + c;
          if (ch0 + k > ce) continue;
          if (cols == 4) {
            const float4 q = *reinterpret_cast<const float4*>(src);
            v[k][0] = q.x, v[k][1] = q.y, v[k][2] = q.z, v[k][3] = q.w;
          } else {
            v[k][0] = src[0];
          }
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k)
          if (ch0 + k <= ce)
            for (int i = 0; i < cols; ++i) acc[i] += v[k][i];
      }
    }
    for (int i = 0; i < cols; ++i) dst[c + i] = xrt::Act<TabT>::store(acc[i]);
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 132;
}

// The register path's items and grid: at least two blocks an SM where
// every thread gets an item, at most one wave of eight blocks an SM, and
// kGatherItems items a thread in between.
void fwd_grid(int D, int R, size_t out_elem, long long* per_row, long long* total,
              int* blocks) {
  const int e = (int)(16 / out_elem);
  *per_row = (D + e - 1) / e;
  *total = *per_row * R;
  const long long sms = sm_count();
  const long long want = std::max(
      (*total + kGatherThreads * kGatherItems - 1) / (kGatherThreads * kGatherItems), 2 * sms);
  const long long most = (*total + kGatherThreads - 1) / kGatherThreads;
  *blocks = (int)std::max(1LL, std::min({want, most, 8 * sms}));
}

template <typename TabT, typename OutT, typename IdxT>
cudaError_t launch_fwd(const void* table, const void* idx, void* out, int N, int D, int R,
                       cudaStream_t stream) {
  long long per_row, total;
  int blocks;
  fwd_grid(D, R, sizeof(OutT), &per_row, &total, &blocks);
  const TabT* t = static_cast<const TabT*>(table);
  const IdxT* i = static_cast<const IdxT*>(idx);
  OutT* o = static_cast<OutT*>(out);
  if (total < (1LL << 31))
    gather_rows_kernel<TabT, OutT, IdxT, uint32_t><<<blocks, kGatherThreads, 0, stream>>>(
        t, i, o, N, D, (uint32_t)per_row, (uint32_t)total);
  else
    gather_rows_kernel<TabT, OutT, IdxT, unsigned long long>
        <<<blocks, kGatherThreads, 0, stream>>>(t, i, o, N, D, per_row, total);
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
                       void* dtable, float* partial, int N, int D, int R, cudaStream_t stream) {
  const size_t smem = (size_t)kChunk * D * sizeof(GT);
  cudaError_t err = xrt::allow_smem(segment_chunk_kernel<GT, TabT>, smem);
  if (err != cudaSuccess) return err;
  segment_chunk_kernel<GT, TabT><<<(R + kChunk - 1) / kChunk, kChunkThreads, smem, stream>>>(
      static_cast<const GT*>(g), sorted_idx, order, static_cast<TabT*>(dtable), partial, N, D, R);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 block(32, kRowsPerBlock);
  segment_rows_kernel<TabT><<<(N + kRowsPerBlock - 1) / kRowsPerBlock, block, 0, stream>>>(
      sorted_idx, partial, static_cast<TabT*>(dtable), N, D, R);
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

// an empty kernel on gather_rows_fwd's grid for (D, R, output dtype)
extern "C" int gather_rows_launch_floor(int D, int R, int out_is_bf16, void* stream) {
  long long per_row, total;
  int blocks;
  fwd_grid(D, R, out_is_bf16 ? 2 : 4, &per_row, &total, &blocks);
  empty_kernel<<<blocks, kGatherThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

// g: (R, D) cotangent rows, f32 or (g_is_bf16) bf16; sorted_idx and order:
// the indices sorted stably and the row each came from; dtable: (N, D), f32
// or (dtable_is_bf16) bf16; partial: a (2 * ceil(R / kChunk), D) f32
// workspace
extern "C" int gather_rows_bwd(const void* g, const long long* sorted_idx,
                               const long long* order, void* dtable, float* partial, int N, int D,
                               int R, int g_is_bf16, int dtable_is_bf16, void* stream) {
  if (N <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 0) return cudaMemsetAsync(dtable, 0, (size_t)N * D * (dtable_is_bf16 ? 2 : 4), s);
  using bf = __nv_bfloat16;
  if (g_is_bf16)
    return dtable_is_bf16
               ? launch_bwd<bf, bf>(g, sorted_idx, order, dtable, partial, N, D, R, s)
               : launch_bwd<bf, float>(g, sorted_idx, order, dtable, partial, N, D, R, s);
  return dtable_is_bf16
             ? launch_bwd<float, bf>(g, sorted_idx, order, dtable, partial, N, D, R, s)
             : launch_bwd<float, float>(g, sorted_idx, order, dtable, partial, N, D, R, s);
}
