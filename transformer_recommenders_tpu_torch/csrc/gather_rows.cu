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
// transposed one-hot matmul (scatter-add as onehot^T @ g), routing and sum
// both.  Bound by bytes as well (R*D cotangents read, N*D written).  Three
// steps, with no atomics and no host synchronisation (a CUDA graph
// captures them):
//   0. the grouping (gather_rows_group): the rows stably sorted by index,
//      every negative index as -1 and every index >= N as N.  A stable
//      sort's permutation is unique, so on every in-range position this is
//      the permutation of torch.sort(idx, stable=True), and passes 1 and 2
//      sum exactly as they did over that sort's output.  It is an LSD radix
//      sort of the buckets clamp(idx, -1, N) + 1 (12 bits for the
//      flagship's catalog, where torch.sort of int64 indices sorts 64), with
//      no atomics on the ranks and no warp matching: each thread owns
//      consecutive positions and counts them by digit in its own column of
//      a (digit x thread) table in shared memory; an exclusive scan of the
//      table in digit-major order gives every (digit, thread) its first
//      position, and each thread places its positions in order.  So a
//      batch's padding row (a third of the rows) is spread over all
//      threads like any other row.  Where the catalog has at most 65,533
//      rows and the items fit shared memory (the main path's hot and
//      logging steps), one block sorts all there, 4 bits a pass (3 passes
//      at the flagship's catalog), in one launch; else tiles of
//      4,096 positions, 8 bits a pass in three launches (the tiles' digit
//      counts, their scan, the placement).  Its outputs: the sorted
//      indices, the rows (order) and each bucket's bounds (its first
//      position and one past its last);
//   1. one block per chunk of kChunk sorted positions: the block stages the
//      chunk's cotangent rows in shared memory, then each thread walks the
//      chunk in order for its columns, summing each run of equal indices in
//      f32.  A run that the chunk holds whole is its table row's sum and is
//      written there; a run that goes on into the chunk before or after is
//      written to the chunk's partials: slot 0 for its first run, slot 1
//      for its last;
//   2. one warp per table row and group of columns: the segment's bounds
//      from the grouping (or, over indices sorted elsewhere, by binary
//      search); a segment inside one chunk was written by pass 1, an empty
//      one is written zero, and a segment across chunks adds its chunks'
//      partials in chunk order.
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

// ---- the backward's grouping (step 0 above): an LSD radix sort of the
// buckets, stable, each thread owning consecutive positions with its own
// count of each digit (no atomics on the ranks, no warp matching)
constexpr int kSortThreads = 256;   // the one-block sort's threads
constexpr int kSortBits = 4;        // its digit
constexpr int kSortDigits = 1 << kSortBits;
constexpr int kTileThreads = 256;   // the tiled sort: a tile's threads
constexpr int kTileItems = 16;      // positions a thread owns
constexpr int kTile = kTileThreads * kTileItems;  // gather_matmul._GROUP_TILE
constexpr int kTileBits = 8;        // its digit: one per thread of a tile
// a digit's row of counts, padded so that the rows start on the banks in turn
constexpr int kTileRow = kTileThreads + 8;
constexpr int kScanThreads = 1024;  // the tiled sort's scan of the tiles' counts

// the clamped index: -1 below 0, N at or above N (its bucket is one more)
__device__ __forceinline__ int clamp_index(long long v, int N) {
  return v < 0 ? -1 : (v >= N ? N : (int)v);
}

// A tiled pass's input: the caller's indices (the first pass; row r at
// position r) or the last pass's clamped indices and rows
struct SortIn {
  const void* idx;
  int idx_is_64;
  const int* keys;
  const int* rows;
  int N;

  __device__ __forceinline__ int key(int i) const {
    if (keys) return keys[i];
    return clamp_index(idx_is_64 ? __ldg(static_cast<const long long*>(idx) + i)
                                 : (long long)__ldg(static_cast<const int*>(idx) + i),
                       N);
  }
  __device__ __forceinline__ int row(int i) const { return keys ? rows[i] : i; }
};

// the exclusive prefix sum of v over the block's threads, in thread order
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[w] = x;
  __syncthreads();
  if (w == 0) {
    int t = lane < nw ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += y;
    }
    if (lane < nw) warp_sums[lane] = t;
  }
  __syncthreads();
  return x - v + (w ? warp_sums[w - 1] : 0);
}

// The one-block sort, where a bucket and a row fit 16 bits (N <= 65,533;
// R <= 255 * kSortThreads, which also keeps a thread's count of a digit
// under 256) and the items fit shared memory: each item (bucket << 16 |
// row) in shared memory, thread t owning
// positions [t * items, (t + 1) * items) (items a multiple of 4; positions
// at or past R hold bucket 0xffff, whose digits are the largest, so they
// sort last and move no real item).  Position i is stored at word i + i /
// 16 * 4, so that a thread's uint4 loads of its own items fall on other
// banks than its neighbours'.  A pass of kSortBits: each thread counts its
// items by digit in registers (16 8-bit counters in two words) and writes
// them to its column of cnt[digit][thread]; an exclusive scan in
// digit-major order gives every (digit, thread) its first position; each
// thread walks its items again in order and places each at its next
// position.  Then the sorted keys and rows go out, and each bucket's bounds
// from the positions where the bucket changes.
__host__ __device__ __forceinline__ int padded(int i) { return i + ((i >> 4) << 2); }

int smem_optin() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes > 0 ? bytes : 232448;
}

// the bits of the largest bucket, N + 1
int bucket_bits(int N) {
  int bits = 1;
  while (bits < 31 && ((N + 1) >> bits)) ++bits;
  return bits;
}

// the one-block sort's shared memory: the items twice, the counts, the
// buckets' bounds
size_t group_block_smem(int items, int N) {
  return (size_t)padded(kSortThreads * items) * 8 +
         (size_t)kSortDigits * kSortThreads * sizeof(unsigned short) + (size_t)(N + 2) * 8;
}

// the items of positions j * kSortThreads + t (t this thread), sixteen
// loads in flight at once
template <typename IdxT>
__device__ __forceinline__ void load_items(const IdxT* __restrict__ idx, uint32_t* a, int N,
                                           int R, int items) {
  for (int j0 = 0; j0 < items; j0 += 16) {
    IdxT v[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int i = (j0 + u) * kSortThreads + threadIdx.x;
      v[u] = j0 + u < items && i < R ? __ldg(idx + i) : IdxT(0);
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int i = (j0 + u) * kSortThreads + threadIdx.x;
      if (j0 + u >= items) break;
      const uint32_t bucket = (uint32_t)(clamp_index(v[u], N) + 1);
      a[padded(i)] = i < R ? (bucket << 16) | (uint32_t)i : 0xffff0000u;
    }
  }
}

__global__ void __launch_bounds__(kSortThreads) group_block_kernel(
    const void* __restrict__ idx, int idx_is_64, int* __restrict__ keys_out,
    int* __restrict__ rows_out, int* __restrict__ bounds, int N, int R, int items, int bits) {
  extern __shared__ __align__(16) unsigned char group_smem[];
  const int t = threadIdx.x, n = kSortThreads * items, words = padded(n);
  uint32_t* a = reinterpret_cast<uint32_t*>(group_smem);
  uint32_t* b = a + words;
  unsigned short* cnt = reinterpret_cast<unsigned short*>(b + words);  // [digit][thread]
  int* sb = reinterpret_cast<int*>(cnt + kSortDigits * kSortThreads);  // each bucket's bounds
  __shared__ int warp_sums[32];
  for (int m = t; m < N + 2; m += kSortThreads) reinterpret_cast<int2*>(sb)[m] = make_int2(0, 0);
  if (idx_is_64)
    load_items(static_cast<const long long*>(idx), a, N, R, items);
  else
    load_items(static_cast<const int*>(idx), a, N, R, items);
  __syncthreads();
  for (int shift = 16; shift < 16 + bits; shift += kSortBits) {
    unsigned long long lo = 0ull, hi = 0ull;  // digits 0-7 and 8-15, a byte each
    for (int q = t * items; q < (t + 1) * items; q += 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(a + padded(q));
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t d = (w[j] >> shift) & (kSortDigits - 1);
        lo += d < 8 ? 1ull << (8 * (d & 7)) : 0ull;
        hi += d >= 8 ? 1ull << (8 * (d & 7)) : 0ull;
      }
    }
#pragma unroll
    for (int d = 0; d < kSortDigits; ++d)
      cnt[d * kSortThreads + t] = (unsigned short)(((d < 8 ? lo : hi) >> (8 * (d & 7))) & 0xffu);
    __syncthreads();
    // thread t scans entries [t * kSortDigits, (t + 1) * kSortDigits) of
    // the digit-major order, eight counts to a uint4
    uint4* run = reinterpret_cast<uint4*>(cnt + t * kSortDigits);
    int sum = 0;
#pragma unroll
    for (int q = 0; q < kSortDigits / 8; ++q) {
      const uint4 v = run[q];
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += (int)(w[j] & 0xffffu) + (int)(w[j] >> 16);
    }
    int start = block_exclusive_scan(sum, warp_sums);
#pragma unroll
    for (int q = 0; q < kSortDigits / 8; ++q) {
      const uint4 v = run[q];
      uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c0 = (int)(w[j] & 0xffffu), c1 = (int)(w[j] >> 16);
        w[j] = (uint32_t)start | ((uint32_t)(start + c0) << 16);
        start += c0 + c1;
      }
      run[q] = make_uint4(w[0], w[1], w[2], w[3]);
    }
    __syncthreads();
    for (int q = t * items; q < (t + 1) * items; q += 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(a + padded(q));
      const uint32_t x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[padded(cnt[((x[j] >> shift) & (kSortDigits - 1)) * kSortThreads + t]++)] = x[j];
    }
    __syncthreads();
    uint32_t* swap = a;
    a = b;
    b = swap;
  }
  // the keys and rows out, four positions a thread at once; a position
  // whose bucket differs from the one before starts its bucket and ends
  // that one (in shared memory, then copied out in order)
  const bool vec =
      ((reinterpret_cast<uintptr_t>(keys_out) | reinterpret_cast<uintptr_t>(rows_out)) & 15) == 0;
  for (int i0 = 4 * t; i0 < R; i0 += 4 * kSortThreads) {
    const uint4 v = *reinterpret_cast<const uint4*>(a + padded(i0));
    const uint32_t x[4] = {v.x, v.y, v.z, v.w};
    int prev = i0 ? (int)(a[padded(i0 - 1)] >> 16) : -1;
    int k[4], r[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      k[u] = (int)(x[u] >> 16);
      r[u] = (int)(x[u] & 0xffffu);
      if (i0 + u < R && k[u] != prev) {
        sb[2 * k[u]] = i0 + u;
        if (prev >= 0) sb[2 * prev + 1] = i0 + u;
      }
      prev = k[u];
    }
    if (vec && i0 + 4 <= R) {
      *reinterpret_cast<int4*>(keys_out + i0) = make_int4(k[0] - 1, k[1] - 1, k[2] - 1, k[3] - 1);
      *reinterpret_cast<int4*>(rows_out + i0) = make_int4(r[0], r[1], r[2], r[3]);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i0 + u < R) {
          keys_out[i0 + u] = k[u] - 1;
          rows_out[i0 + u] = r[u];
        }
    }
  }
  if (t == 0) sb[2 * (a[padded(R - 1)] >> 16) + 1] = R;
  __syncthreads();
  for (int m = t; m < N + 2; m += kSortThreads)
    reinterpret_cast<int2*>(bounds)[m] = reinterpret_cast<const int2*>(sb)[m];
}

// the one-block sort's items a thread: a multiple of 4
int group_block_items(int R) { return 4 * ((R + 4 * kSortThreads - 1) / (4 * kSortThreads)); }

cudaError_t launch_group_block(const void* idx, int idx_is_64, int* keys, int* rows, int* bounds,
                               int N, int R, cudaStream_t stream) {
  const int items = group_block_items(R);
  const size_t smem = group_block_smem(items, N);
  const int bits = (bucket_bits(N) + kSortBits - 1) / kSortBits * kSortBits;
  cudaError_t err = xrt::allow_smem(group_block_kernel, smem);
  if (err != cudaSuccess) return err;
  group_block_kernel<<<1, kSortThreads, smem, stream>>>(idx, idx_is_64, keys, rows, bounds, N, R,
                                                        items, bits);
  return cudaGetLastError();
}

// The tiled sort, for every other shape: a pass of kTileBits in three
// launches over tiles of kTile positions.  1: each tile's count of each
// digit, hist[digit * tiles + tile]
__global__ void __launch_bounds__(kTileThreads) tile_hist_kernel(SortIn in, int R, int shift,
                                                                 int* __restrict__ hist) {
  __shared__ int h[kTileThreads];
  h[threadIdx.x] = 0;
  __syncthreads();
  const int base = blockIdx.x * kTile;
  for (int j = 0; j < kTileItems; ++j) {
    const int i = base + j * kTileThreads + threadIdx.x;
    if (i < R) atomicAdd(&h[((in.key(i) + 1) >> shift) & (kTileThreads - 1)], 1);
  }
  __syncthreads();
  hist[threadIdx.x * gridDim.x + blockIdx.x] = h[threadIdx.x];
}

// 2: the exclusive scan of hist (digit-major: every (digit, tile) its first
// position), in place, in one block
__global__ void __launch_bounds__(kScanThreads) tile_scan_kernel(int* __restrict__ hist, int n) {
  __shared__ int warp_sums[32];
  const int per = (n + kScanThreads - 1) / kScanThreads;
  const int a = min(n, (int)threadIdx.x * per), b = min(n, a + per);
  int sum = 0;
  for (int i = a; i < b; ++i) sum += hist[i];
  int start = block_exclusive_scan(sum, warp_sums);
  for (int i = a; i < b; ++i) {
    const int v = hist[i];
    hist[i] = start;
    start += v;
  }
}

// 3: each tile places its positions: thread t owns [t * kTileItems, ...)
// of the tile and counts them by digit in its own column of
// cnt[digit][thread]; thread d then turns digit d's row into exclusive
// prefixes; each position goes to its (digit, tile)'s first position plus
// its thread's next rank in the digit
__global__ void __launch_bounds__(kTileThreads) tile_scatter_kernel(
    SortIn in, int R, int shift, const int* __restrict__ first, int* __restrict__ keys_out,
    int* __restrict__ rows_out) {
  extern __shared__ __align__(16) unsigned char group_smem[];
  unsigned short* cnt = reinterpret_cast<unsigned short*>(group_smem);  // [digit][kTileRow]
  const int t = threadIdx.x, i0 = blockIdx.x * kTile + t * kTileItems;
  for (int i = t; i < kTileThreads * kTileRow / 8; i += kTileThreads)
    reinterpret_cast<uint4*>(cnt)[i] = make_uint4(0u, 0u, 0u, 0u);
  int k[kTileItems], r[kTileItems];
#pragma unroll
  for (int j = 0; j < kTileItems; ++j) {
    k[j] = i0 + j < R ? in.key(i0 + j) : 0;
    r[j] = i0 + j < R ? in.row(i0 + j) : 0;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kTileItems; ++j)
    if (i0 + j < R) ++cnt[(((k[j] + 1) >> shift) & (kTileThreads - 1)) * kTileRow + t];
  __syncthreads();
  uint4* row = reinterpret_cast<uint4*>(cnt + t * kTileRow);
  int start = 0;
  for (int q = 0; q < kTileThreads / 8; ++q) {
    uint4 v = row[q];
    unsigned short* e = reinterpret_cast<unsigned short*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = e[j];
      e[j] = (unsigned short)start;
      start += c;
    }
    row[q] = v;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kTileItems; ++j) {
    if (i0 + j >= R) continue;
    const int d = ((k[j] + 1) >> shift) & (kTileThreads - 1);
    const int pos = first[d * gridDim.x + blockIdx.x] + cnt[d * kTileRow + t]++;
    keys_out[pos] = k[j];
    rows_out[pos] = r[j];
  }
}

// each bucket's bounds in the sorted keys: its first position and one past
// its last, by binary search
__global__ void bucket_bounds_kernel(const int* __restrict__ keys, int* __restrict__ bounds,
                                     int K, int R) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  int lo = 0, hi = R, lo2 = 0, hi2 = R;  // first position >= k, first > k
  while (lo < hi || lo2 < hi2) {
    if (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (keys[mid] + 1 < k) lo = mid + 1;
      else hi = mid;
    }
    if (lo2 < hi2) {
      const int mid = (lo2 + hi2) >> 1;
      if (keys[mid] + 1 <= k) lo2 = mid + 1;
      else hi2 = mid;
    }
  }
  reinterpret_cast<int2*>(bounds)[k] = make_int2(lo, lo2);
}

cudaError_t group_tiled(const void* idx, int idx_is_64, int* keys, int* rows, int* bounds,
                        int* tmp_keys, int* tmp_rows, int* hist, int N, int R,
                        cudaStream_t stream) {
  const int tiles = (R + kTile - 1) / kTile;
  const int passes = (bucket_bits(N) + kTileBits - 1) / kTileBits;
  const size_t smem = (size_t)kTileThreads * kTileRow * sizeof(unsigned short);
  cudaError_t err = xrt::allow_smem(tile_scatter_kernel, smem);
  if (err != cudaSuccess) return err;
  SortIn in{idx, idx_is_64, nullptr, nullptr, N};
  for (int p = 0; p < passes; ++p) {
    // the last pass writes keys and rows, the ones before alternate
    int* out_keys = (passes - 1 - p) % 2 ? tmp_keys : keys;
    int* out_rows = (passes - 1 - p) % 2 ? tmp_rows : rows;
    const int shift = p * kTileBits;
    tile_hist_kernel<<<tiles, kTileThreads, 0, stream>>>(in, R, shift, hist);
    tile_scan_kernel<<<1, kScanThreads, 0, stream>>>(hist, tiles * kTileThreads);
    tile_scatter_kernel<<<tiles, kTileThreads, smem, stream>>>(in, R, shift, hist, out_keys,
                                                               out_rows);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    in = SortIn{nullptr, 0, out_keys, out_rows, N};
  }
  bucket_bounds_kernel<<<(N + 2 + 255) / 256, 256, 0, stream>>>(keys, bounds, N + 2, R);
  return cudaGetLastError();
}

constexpr int kChunk = 64;        // sorted positions per block of pass 1 (gather_matmul._CHUNK)
constexpr int kChunkThreads = 128;
constexpr int kWalk = 8;          // pass 1: positions whose values a thread loads at once

// Pass 1: block c sums the runs of sorted positions [c * kChunk, ...).  The
// block first stages the chunk's cotangent rows in shared memory (cp.async,
// all its copies in flight at once, 16 bytes a thread where D allows) and
// works out once, for every position, whether it starts a run and where the
// run's sum goes if it ends there; then each thread walks the chunk in order
// for its columns, kWalk positions' values and flags loaded at once.  A run
// that the chunk holds whole is its table row's sum and is written there; a
// run that goes on into the chunk before or after is written to the chunk's
// partials: slot 0 for its first run, slot 1 for its last.  partial is
// (2 * chunks, D) f32.
template <typename GT, typename TabT, typename IdxT>
__global__ void __launch_bounds__(kChunkThreads) segment_chunk_kernel(
    const GT* __restrict__ g, const IdxT* __restrict__ sorted_idx,
    const IdxT* __restrict__ order, TabT* __restrict__ dtable, float* __restrict__ partial,
    int N, int D, int R) {
  extern __shared__ __align__(16) unsigned char smem[];
  GT* rows = reinterpret_cast<GT*>(smem);  // kChunk x D
  __shared__ long long s_idx[kChunk + 2];  // the chunk's indices and one beyond each end
  __shared__ long long s_row[kChunk];
  // a position's run: bit 0 it starts one; >> 1 where the sum goes if it
  // ends one: table row n as n + 1, the partial slot s as -(s + 1), or 0
  __shared__ int s_walk[kChunk];
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
      xrt::cp_async16(reinterpret_cast<uint4*>(rows) + i,
                      reinterpret_cast<const uint4*>(g + (size_t)s_row[j] * D) + v, true);
    }
    xrt::cp_async_commit();
  } else {
    for (int i = threadIdx.x; i < len * D; i += blockDim.x)
      rows[i] = g[(size_t)s_row[i / D] * D + i % D];
  }
  for (int j = threadIdx.x; j < len; j += blockDim.x) {
    const long long idx = s_idx[j + 1];
    const bool starts = j == 0 || idx != s_idx[j];
    const bool ends = j + 1 == len || s_idx[j + 2] != idx;
    int dest = 0;
    if (ends && idx >= 0 && idx < N) {
      const bool from_first = s_idx[1] == idx;  // the run began at position 0
      const bool open_left = from_first && s_idx[0] == idx;
      const bool open_right = j + 1 == len && s_idx[len + 1] == idx;
      dest = !open_left && !open_right ? (int)idx + 1 : (from_first ? -1 : -2);
    }
    s_walk[j] = dest * 2 + (starts ? 1 : 0);
  }
  xrt::cp_async_wait<0>();
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    float acc = 0.f;
    for (int j0 = 0; j0 < len; j0 += kWalk) {
      float v[kWalk];
      int walk[kWalk];  // 0 past the chunk: adds 0 to a sum that goes nowhere
#pragma unroll
      for (int k = 0; k < kWalk; ++k) {
        v[k] = j0 + k < len ? xrt::Act<GT>::load(rows[(j0 + k) * D + c]) : 0.f;
        walk[k] = j0 + k < len ? s_walk[j0 + k] : 0;
      }
#pragma unroll
      for (int k = 0; k < kWalk; ++k) {
        const int w = walk[k];
        acc = (w & 1) ? v[k] : acc + v[k];
        const int dest = w >> 1;
        if (dest > 0)
          dtable[(size_t)(dest - 1) * D + c] = xrt::Act<TabT>::store(acc);
        else if (dest < 0)
          partial[((size_t)blockIdx.x * 2 - dest - 1) * D + c] = acc;
      }
    }
  }
}

// Pass 2: one warp per table row n; each lane loads kBatch chunks'
// partials of its columns (four at a time where D allows) before adding
// them in chunk order.  With the grouping's bounds (bucket n + 1) the
// warps are also split by group of 32 lanes' columns (gridDim.y), so that
// a long segment's columns are added on several warps at once, and load 16
// chunks at once; over indices sorted elsewhere (torch.sort's, timed
// beside the grouping), the warp searches the segment's two bounds together
// and takes all the columns, 8 chunks at once
template <typename TabT, typename IdxT, int kBatch>
__global__ void segment_rows_kernel(const IdxT* __restrict__ sorted_idx,
                                    const int* __restrict__ bounds,
                                    const float* __restrict__ partial, TabT* __restrict__ dtable,
                                    int N, int D, int R) {
  const int n = blockIdx.x * kRowsPerBlock + threadIdx.y;
  if (n >= N) return;
  int lo = 0, hi = R, lo2 = 0, hi2 = R;  // first position >= n, first > n
  if (bounds) {
    const int2 b = reinterpret_cast<const int2*>(bounds)[n + 1];
    lo = hi = b.x;
    lo2 = hi2 = b.y;
  }
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
  const int c1 = blockIdx.y + 1 == gridDim.y ? D : (blockIdx.y + 1) * 32 * cols;
  for (int c = (blockIdx.y * 32 + threadIdx.x) * cols; c < c1; c += 32 * cols) {
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

template <typename GT, typename TabT, typename IdxT>
cudaError_t launch_bwd(const void* g, const void* sorted_idx, const void* order, const int* bounds,
                       void* dtable, float* partial, int N, int D, int R, cudaStream_t stream) {
  const size_t smem = (size_t)kChunk * D * sizeof(GT);
  cudaError_t err = xrt::allow_smem(segment_chunk_kernel<GT, TabT, IdxT>, smem);
  if (err != cudaSuccess) return err;
  const IdxT* keys = static_cast<const IdxT*>(sorted_idx);
  segment_chunk_kernel<GT, TabT, IdxT>
      <<<(R + kChunk - 1) / kChunk, kChunkThreads, smem, stream>>>(
          static_cast<const GT*>(g), keys, static_cast<const IdxT*>(order),
          static_cast<TabT*>(dtable), partial, N, D, R);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 block(32, kRowsPerBlock);
  const int rows = (N + kRowsPerBlock - 1) / kRowsPerBlock, group = 32 * (D % 4 == 0 ? 4 : 1);
  if (bounds)
    segment_rows_kernel<TabT, IdxT, 16><<<dim3(rows, (D + group - 1) / group), block, 0, stream>>>(
        keys, bounds, partial, static_cast<TabT*>(dtable), N, D, R);
  else
    segment_rows_kernel<TabT, IdxT, 8><<<rows, block, 0, stream>>>(
        keys, nullptr, partial, static_cast<TabT*>(dtable), N, D, R);
  return cudaGetLastError();
}

template <typename GT, typename TabT>
cudaError_t launch_bwd_idx(const void* g, const void* sorted_idx, const void* order,
                           const int* bounds, int idx_is_64, void* dtable, float* partial, int N,
                           int D, int R, cudaStream_t s) {
  return idx_is_64 ? launch_bwd<GT, TabT, long long>(g, sorted_idx, order, bounds, dtable,
                                                     partial, N, D, R, s)
                   : launch_bwd<GT, TabT, int>(g, sorted_idx, order, bounds, dtable, partial, N,
                                               D, R, s);
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

// idx: R int32 or (idx_is_64) int64 indices; ws: a workspace of
// 4 * R + 2 * (N + 2) + kTileThreads * ceil(R / kTile) int32.  Writes the
// indices sorted stably (every negative one as -1, every one >= N as N) to
// ws[0, R), the row each came from to ws[R, 2R) and each bucket's bounds
// (bucket n + 1 for table row n: its first position and one past its last;
// an empty bucket's two are equal) to ws[2R, 2R + 2 * (N + 2)).  One block
// where the shape allows it, else (or with tiled) the tiled sort.
extern "C" int gather_rows_group(const void* idx, int* ws, int N, int R, int idx_is_64,
                                 int tiled, void* stream) {
  if (N <= 0 || R <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* keys = ws;
  int* rows = ws + R;
  int* bounds = ws + 2 * (size_t)R;
  int* tmp_keys = bounds + 2 * (N + 2);
  int* tmp_rows = tmp_keys + R;
  int* hist = tmp_rows + R;
  if (tiled || N > 65533 || group_block_items(R) > 255 ||
      group_block_smem(group_block_items(R), N) + 1024 > (size_t)smem_optin())
    return group_tiled(idx, idx_is_64, keys, rows, bounds, tmp_keys, tmp_rows, hist, N, R, s);
  return launch_group_block(idx, idx_is_64, keys, rows, bounds, N, R, s);
}

// g: (R, D) cotangent rows, f32 or (g_is_bf16) bf16; sorted_idx and order:
// the indices sorted stably and the row each came from, int32 or
// (idx_is_64) int64; bounds: each bucket's, as gather_rows_group writes
// them, or null (pass 2 then searches sorted_idx); dtable: (N, D), f32 or
// (dtable_is_bf16) bf16; partial: a (2 * ceil(R / kChunk), D) f32 workspace
extern "C" int gather_rows_bwd(const void* g, const void* sorted_idx, const void* order,
                               const int* bounds, int idx_is_64, void* dtable, float* partial,
                               int N, int D, int R, int g_is_bf16, int dtable_is_bf16,
                               void* stream) {
  if (N <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 0) return cudaMemsetAsync(dtable, 0, (size_t)N * D * (dtable_is_bf16 ? 2 : 4), s);
  using bf = __nv_bfloat16;
  if (g_is_bf16)
    return dtable_is_bf16 ? launch_bwd_idx<bf, bf>(g, sorted_idx, order, bounds, idx_is_64,
                                                   dtable, partial, N, D, R, s)
                          : launch_bwd_idx<bf, float>(g, sorted_idx, order, bounds, idx_is_64,
                                                      dtable, partial, N, D, R, s);
  return dtable_is_bf16 ? launch_bwd_idx<float, bf>(g, sorted_idx, order, bounds, idx_is_64,
                                                    dtable, partial, N, D, R, s)
                        : launch_bwd_idx<float, float>(g, sorted_idx, order, bounds, idx_is_64,
                                                       dtable, partial, N, D, R, s);
}
