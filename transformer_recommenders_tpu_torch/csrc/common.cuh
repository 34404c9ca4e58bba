// Shared device helpers for the port's kernels: activation-type traits
// (bf16 or f32 storage, f32 arithmetic), the counter-based dropout hash,
// warp reductions, the tensor-core fragments (mma.sync, ldmatrix),
// cp.async staging, the tensor-core score chain of the pool, table and
// pairwise kernels, and the backward loops of the pool and pairwise
// kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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

// keep iff fmix32(idx*PREMIX_IDX + term) >= threshold, all arithmetic
// modulo 2**32, given the site's seed term seed*PREMIX_SEED
// (ops/hash_dropout.seed_terms)
__device__ __forceinline__ bool keep_premixed(uint32_t idx, uint32_t term,
                                              uint32_t threshold) {
  return fmix32(idx * kPremixIdx + term) >= threshold;
}

// keep iff fmix32(idx*PREMIX_IDX + seed*PREMIX_SEED) >= threshold
__device__ __forceinline__ bool keep(uint32_t idx, uint32_t seed,
                                     uint32_t threshold) {
  return keep_premixed(idx, seed * kPremixSeed, threshold);
}

// A layer's three dropout site seeds (attention probs, post-attention
// hidden, post-FFN hidden), uint32 values held as int64 in device memory
// and read by the kernel, so that a CUDA graph replayed with new seeds in
// that memory draws new masks; a null pointer reads 0 (dropout off)
struct Seeds {
  const long long* ptr;
  __device__ __forceinline__ uint32_t operator[](int i) const {
    return ptr ? static_cast<uint32_t>(__ldg(ptr + i)) : 0u;
  }
};

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

__device__ __forceinline__ float bf(__nv_bfloat16 v) { return __bfloat162float(v); }

// ---- tensor-core products (mma.sync m16n8k16: bf16 operands, f32 sums).
// Fragment layouts of the PTX ISA: with g = lane / 4 and t2 = 2 * (lane % 4),
// A holds rows g and g + 8 at k = t2, t2 + 1 and t2 + 8, t2 + 9; B columns g
// at the same k; C rows g and g + 8 at columns t2, t2 + 1.  Each 32-bit
// register packs two bf16, the lower k (or column) in the low half.

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// {M(r, k), M(r, k + 1)} of M(r, k) = m[r * ld + k]: zero unless r < rows
// and k < cols, the high half zero unless k + 1 < cols
__device__ __forceinline__ uint32_t row_pair(const __nv_bfloat16* m, int ld, int r, int k,
                                             int rows, int cols) {
  if (r >= rows || k >= cols) return 0u;
  const __nv_bfloat16* p = m + (size_t)r * ld + k;
  return pack_bf16(p[0], k + 1 < cols ? p[1] : __float2bfloat16_rn(0.f));
}

// {M(k, c), M(k + 1, c)} down column c of M(k, c) = m[k * ld + c]: zero
// unless k < rows and c < cols, the high half zero unless k + 1 < rows
__device__ __forceinline__ uint32_t col_pair(const __nv_bfloat16* m, int ld, int k, int c,
                                             int rows, int cols) {
  if (k >= rows || c >= cols) return 0u;
  const __nv_bfloat16* p = m + (size_t)k * ld + c;
  return pack_bf16(p[0], k + 1 < rows ? p[ld] : __float2bfloat16_rn(0.f));
}

// the two bf16 at m (4-byte aligned) as one word
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* m) {
  return *reinterpret_cast<const uint32_t*>(m);
}

// the A fragment of k-step [k, k + 16) of the 16 rows m[r * ld + ...]
__device__ __forceinline__ void load_a(const __nv_bfloat16* m, int ld, int k, uint32_t a[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = (lane & 3) * 2;
  a[0] = ld32(m + g * ld + k + t2);
  a[1] = ld32(m + (g + 8) * ld + k + t2);
  a[2] = ld32(m + g * ld + k + 8 + t2);
  a[3] = ld32(m + (g + 8) * ld + k + 8 + t2);
}

// the A fragment of the 16 x 16 block at m (row-major in shared memory,
// leading dimension ld, 16-byte aligned rows): a[0..3] as load_a gives them
__device__ __forceinline__ void ldmatrix_x4(uint32_t a[4], const __nv_bfloat16* m, int ld) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* row = m + (lane & 15) * ld + (lane >> 4) * 8;
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

// B fragments of a 16 x 16 block of a row-major matrix in shared memory,
// B(k, n) = m[k * ld + n] (16-byte aligned rows): b[0..1] the n8 tile of
// columns [0, 8), b[2..3] that of [8, 16)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t b[4], const __nv_bfloat16* m, int ld) {
  const int lane = threadIdx.x & 31, mi = lane >> 3;
  const __nv_bfloat16* row = m + ((lane & 7) + (mi & 1) * 8) * ld + (mi >> 1) * 8;
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(addr)
               : "memory");
}

// ---- asynchronous copies into shared memory (cp.async, 16 bytes)

// 16 bytes from src to dst, or 16 zero bytes when !full (src is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n of this thread's committed groups are in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// ---- the score chain of the pool, table and pairwise kernels (on the tensor cores)

// D zero-padded to whole k-steps of 16 (exact: the padding adds 0)
__host__ __device__ __forceinline__ int pad16(int D) { return (D + 15) / 16 * 16; }

// rows [row0, row0 + nrows) x columns [0, D) of a (rows_total, D) bf16
// matrix into shared memory with leading dimension ld (a multiple of 8),
// zero past rows_total: 16-byte cp.async copies where D and src allow (the
// caller commits and waits), else plain loads
__device__ inline void stage_rows_async(const __nv_bfloat16* __restrict__ src, int rows_total,
                                        int D, int row0, int nrows, __nv_bfloat16* dst, int ld) {
  if (D % 8 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int per_row = D / 8;
    for (int i = threadIdx.x; i < nrows * per_row; i += blockDim.x) {
      const int r = i / per_row, c = (i % per_row) * 8;
      const bool in = row0 + r < rows_total;
      cp_async16(dst + r * ld + c, in ? src + (size_t)(row0 + r) * D + c : src, in);
    }
  } else {
    for (int i = threadIdx.x; i < nrows * D; i += blockDim.x) {
      const int r = i / D, k = i % D;
      dst[r * ld + k] =
          row0 + r < rows_total ? src[(size_t)(row0 + r) * D + k] : __float2bfloat16_rn(0.f);
    }
  }
}

// zero columns [D, pad16(D)) of nrows staged rows (never written by
// stage_rows_async, so once per kernel)
__device__ inline void zero_pad_cols(__nv_bfloat16* dst, int nrows, int D, int ld) {
  const int w = pad16(D) - D;
  for (int i = threadIdx.x; i < nrows * w; i += blockDim.x)
    dst[(i / w) * ld + D + i % w] = __float2bfloat16_rn(0.f);
}

// The one chain of every pool score and every pos: a warp's 16 x 8 tile
//   x(i, j) = scale * sum_k A(i, k) B(j, k)
// with the query rows as A (a(ks, frag) gives the A fragment of k-step ks)
// and the pool (or positive) rows as B, b[j * ldb + k] in shared memory,
// bf16, zero in [D, 16 nks).  The accumulator starts at 0 and takes the
// k-steps of 16 in increasing order, then one unfused multiply by scale.
// A product of two bf16 values is exact in f32, and the tensor core's sum
// for one output depends only on that output's row, column and
// accumulator, so a pool row equal to a row's positive scores exactly that
// row's pos in every kernel that calls this.  kKs > 0: the loop unrolled
// over at most kKs steps (A fragments held in registers); 0: a plain loop.
// x[0], x[1]: row g, columns t2, t2 + 1; x[2], x[3]: row g + 8.
template <int kKs, typename LoadA>
__device__ __forceinline__ void score_tile(const LoadA& a, const __nv_bfloat16* b, int ldb,
                                           int nks, float scale, float x[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = (lane & 3) * 2;
  const __nv_bfloat16* bg = b + g * ldb + t2;
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  auto step = [&](int ks) {
    uint32_t af[4];
    a(ks, af);
    const uint32_t bfrag[2] = {ld32(bg + 16 * ks), ld32(bg + 16 * ks + 8)};
    mma_bf16(c, af, bfrag);
  };
  if constexpr (kKs > 0) {
#pragma unroll
    for (int ks = 0; ks < kKs; ++ks)
      if (ks < nks) step(ks);
  } else {
#pragma unroll 4
    for (int ks = 0; ks < nks; ++ks) step(ks);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = __fmul_rn(c[i], scale);
}

// The query fragments of a warp's 16 rows of a score_tile (qw, leading dimension ld):
// held in registers for kKs > 0 (nks <= kKs), else loaded per k-step.
template <int kKs>
struct QueryFrags {
  uint32_t held[kKs > 0 ? kKs : 1][4];
  const __nv_bfloat16* qw;
  int ld;

  __device__ __forceinline__ QueryFrags(const __nv_bfloat16* qw_, int ld_, int nks)
      : qw(qw_), ld(ld_) {
    if constexpr (kKs > 0) {
#pragma unroll
      for (int ks = 0; ks < kKs; ++ks)
        if (ks < nks) load_a(qw, ld, 16 * ks, held[ks]);
    }
  }
  __device__ __forceinline__ void operator()(int ks, uint32_t a[4]) const {
    if constexpr (kKs > 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = held[ks][i];
    } else {
      load_a(qw, ld, 16 * ks, a);
    }
  }
};

// pos of a block's 32 query rows into spos, in the 8-warp tiling of the
// pool, table and pairwise kernels (warp w scores rows 16 (w & 1) and
// columns 8 (w >> 1) of each 32 x 32 tile): score_tile of the rows (qa)
// against their own positives staged in sp, read off the diagonal (row
// 16 mt + g (+ 8) meets column 8 nt + t2 (+ 1))
template <int kKs, typename QA>
__device__ __forceinline__ void diagonal_pos(const QA& qa, const __nv_bfloat16* sp, int ld,
                                             int nks, float scale, float* spos) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t2 = (lane & 3) * 2, mt = warp & 1, nt = warp >> 1;
  float x[4];
  score_tile<kKs>(qa, sp + 8 * nt * ld, ld, nks, scale, x);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (16 * mt + g + 8 * (i >> 1) == 8 * nt + t2 + (i & 1)) spos[8 * nt + t2 + (i & 1)] = x[i];
}

// a running (max, sum of exp(x - max)) merged with another: (m, s) takes
// (m2, s2)
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// ---- loops of tiles split across blocks (blockIdx.y), the splits' partial
// results added in split order by the caller

// the tiles [t0, t1) of split blockIdx.y of ``total`` rows in tiles of
// ``tile``
__device__ __forceinline__ void split_tiles(int total, int tile, int splits, int& t0, int& t1) {
  const long long nt = (total + tile - 1) / tile;
  t0 = (int)(blockIdx.y * nt / splits);
  t1 = (int)((blockIdx.y + 1) * nt / splits);
}

// out[i] = the splits' partial sums part[sp * total + i], added in split
// order (a template, so that only the sources that launch it compile it)
template <typename T>
__global__ void sum_splits_kernel(const T* __restrict__ part, T* __restrict__ out, size_t total,
                                  int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  T s = 0;
  for (int sp = 0; sp < splits; ++sp) s += part[sp * total + i];
  out[i] = s;
}

// ---- the backward passes of the pool and pairwise kernels: the scores
// again, then dl N (dq) or dl^T Q (dn) on the tensor cores
//
// A block of kBwdThreads (8 warps) holds kBwdTile rows of one side and
// walks the tiles of kBwdTile rows of the other side in order; its warp w
// scores the 16 x 8 tile (query rows 16 (w & 1), pool rows 8 (w >> 1)) of
// every 32 x 32 tile of scores through score_tile, the query rows as A.
// The per-score dl comes from a functor of the kernel:
//   dl.stage(row0, R)        the threads stage what dl needs of the query
//                            rows [row0, row0 + kBwdTile) (zero past R)
//   dl(x, nv, row)           the unrounded dl of score x of the staged
//                            query row ``row`` at a pool row of validity nv
// dl goes to shared memory rounded to bf16; its product with the other
// side's tile runs on mma.sync m16n8k16 with B fragments by
// ldmatrix.trans from the row-major tile, k the tile's rows in order, into
// each warp's acc[kJ][2][2][4]: output rows 16 mi + g (+ 8 for fragment
// elements 2, 3) of the block's, columns 16 w + 128 jb + 8 half + t2 (+ 1
// for odd elements), kJ column blocks covering pad16(D).

constexpr int kBwdThreads = 256;
constexpr int kBwdTile = 32;
constexpr int kBwdDlLd = kBwdTile + 8;  // dl's leading dimension in shared memory (bf16)

// the shared memory the loops below carve from the front of the kernel's:
// one tile of the block's rows, two of the walked side's, dl, and (dn) the
// block's pool validity; a kernel puts its functor's arrays after it
__host__ __device__ __forceinline__ size_t bwd_tiles_bytes(int D) {
  return sizeof(__nv_bfloat16) * ((size_t)3 * kBwdTile * (pad16(D) + 8) + kBwdTile * kBwdDlLd) +
         sizeof(float) * kBwdTile;
}

template <int kJ>
__device__ __forceinline__ void zero_acc(float acc[kJ][2][2][4]) {
#pragma unroll
  for (int jb = 0; jb < kJ; ++jb)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[jb][i / 8][(i / 4) % 2][i % 4] = 0.f;
}

// acc += A B: A the 32 x 32 bf16 dl at a (row-major, leading dimension
// kBwdDlLd), B the 32 x Dp bf16 tile at b (row-major, leading dimension ld)
template <int kJ>
__device__ __forceinline__ void dl_product(const __nv_bfloat16* a, const __nv_bfloat16* b, int ld,
                                           int Dp, float acc[kJ][2][2][4]) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int kk = 0; kk < kBwdTile / 16; ++kk) {
    uint32_t a0[4], a1[4];
    load_a(a, kBwdDlLd, 16 * kk, a0);
    load_a(a + 16 * kBwdDlLd, kBwdDlLd, 16 * kk, a1);
#pragma unroll
    for (int jb = 0; jb < kJ; ++jb) {
      const int c = 16 * warp + 128 * jb;
      if (c < Dp) {
        uint32_t bfrag[4];
        ldmatrix_x4_trans(bfrag, b + 16 * kk * ld + c, ld);
        mma_bf16(acc[jb][0][0], a0, bfrag);
        mma_bf16(acc[jb][0][1], a0, bfrag + 2);
        mma_bf16(acc[jb][1][0], a1, bfrag);
        mma_bf16(acc[jb][1][1], a1, bfrag + 2);
      }
    }
  }
}

// the block's rows of a warp's acc, inside rows [0, rows - row0) and
// columns [0, D), into out, (rows, D) f32
template <int kJ>
__device__ __forceinline__ void store_acc(const float acc[kJ][2][2][4], float* out, int row0,
                                          int rows, int D) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int jb = 0; jb < kJ; ++jb)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 16 * mi + g + 8 * h, col = 16 * warp + 128 * jb + 8 * half + t2;
          if (row < rows) {
            if (col < D) out[(size_t)row * D + col] = acc[jb][mi][half][2 * h];
            if (col + 1 < D) out[(size_t)row * D + col + 1] = acc[jb][mi][half][2 * h + 1];
          }
        }
}

// dq, block (query-row tile, split): the block's kBwdTile rows of q (the
// query fragments in registers for kKs > 0) against the split's pool
// tiles of n in order, double-buffered with cp.async; acc += dl N_tile
// with dl row-major in shared memory.  rowsum[h] is this lane's sum of the
// unrounded dl of its row 16 (w & 1) + g + 8 h, tile by tile, column t2
// then t2 + 1.
template <int kKs, int kJ, typename Dl>
__device__ __forceinline__ void dq_tiles(const __nv_bfloat16* __restrict__ q,
                                         const __nv_bfloat16* __restrict__ n,
                                         const float* __restrict__ nv, int R, int Rn, int D,
                                         float scale, const Dl& dl, unsigned char* smem,
                                         int splits, float acc[kJ][2][2][4], float rowsum[2]) {
  const int Dp = pad16(D), nks = Dp / 16, ld = Dp + 8;
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sn = sq + kBwdTile * ld;  // two pool buffers
  __nv_bfloat16* sdl = sn + 2 * kBwdTile * ld;
  const int r0 = blockIdx.x * kBwdTile;
  int t0, t1;
  split_tiles(Rn, kBwdTile, splits, t0, t1);
  zero_pad_cols(sq, 3 * kBwdTile, D, ld);
  stage_rows_async(q, R, D, r0, kBwdTile, sq, ld);
  cp_async_commit();
  if (t0 < t1) stage_rows_async(n, Rn, D, t0 * kBwdTile, kBwdTile, sn, ld);
  cp_async_commit();
  dl.stage(r0, R);
  cp_async_wait<1>();
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, t2 = (lane & 3) * 2, mt = warp & 1, nt = warp >> 1;
  const QueryFrags<kKs> qa(sq + 16 * mt * ld, ld, nks);
  zero_acc<kJ>(acc);
  rowsum[0] = rowsum[1] = 0.f;
  for (int t = t0; t < t1; ++t) {
    const __nv_bfloat16* cur = sn + ((t - t0) & 1) * kBwdTile * ld;
    if (t + 1 < t1)
      stage_rows_async(n, Rn, D, (t + 1) * kBwdTile, kBwdTile,
                       sn + ((t + 1 - t0) & 1) * kBwdTile * ld, ld);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float x[4];
    score_tile<kKs>(qa, cur + 8 * nt * ld, ld, nks, scale, x);
    const int j = t * kBwdTile + 8 * nt + t2;
    const float v0 = j < Rn ? nv[j] : 0.f, v1 = j + 1 < Rn ? nv[j + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * mt + gr + 8 * h;
      const bool live = r0 + row < R;
      const float d0 = live ? dl(x[2 * h], v0, row) : 0.f;
      const float d1 = live ? dl(x[2 * h + 1], v1, row) : 0.f;
      rowsum[h] += d0;
      rowsum[h] += d1;
      *reinterpret_cast<uint32_t*>(sdl + row * kBwdDlLd + 8 * nt + t2) =
          pack_bf16(__float2bfloat16_rn(d0), __float2bfloat16_rn(d1));
    }
    __syncthreads();
    dl_product<kJ>(sdl, cur, ld, Dp, acc);  // dq += dl (32 x 32) N_tile (32 x Dp)
    __syncthreads();
  }
}

// dn, block (pool-row tile, split): the block's kBwdTile rows of n against
// the split's query-row tiles of q in order, double-buffered with
// cp.async; dl.stage for each query tile; dl transposed in shared memory
// and dn += dl^T Q_tile.  Writes the block's rows of dn into out (dn
// itself with one split, else part[split], (Rn, D) f32).
template <int kJ, typename Dl>
__device__ __forceinline__ void dn_block(const __nv_bfloat16* __restrict__ q,
                                         const __nv_bfloat16* __restrict__ n,
                                         const float* __restrict__ nv, int R, int Rn, int D,
                                         float scale, const Dl& dl, unsigned char* smem,
                                         float* __restrict__ out, int splits) {
  const int Dp = pad16(D), nks = Dp / 16, ld = Dp + 8;
  __nv_bfloat16* sn = reinterpret_cast<__nv_bfloat16*>(smem);  // the block's pool rows
  __nv_bfloat16* sq = sn + kBwdTile * ld;                       // two query buffers
  __nv_bfloat16* sdl = sq + 2 * kBwdTile * ld;                  // dl transposed: [j][row]
  float* snv = reinterpret_cast<float*>(sdl + kBwdTile * kBwdDlLd);
  const int n0 = blockIdx.x * kBwdTile;
  int t0, t1;
  split_tiles(R, kBwdTile, splits, t0, t1);
  zero_pad_cols(sn, 3 * kBwdTile, D, ld);
  stage_rows_async(n, Rn, D, n0, kBwdTile, sn, ld);
  if (t0 < t1) stage_rows_async(q, R, D, t0 * kBwdTile, kBwdTile, sq, ld);
  cp_async_commit();
  for (int i = threadIdx.x; i < kBwdTile; i += blockDim.x) snv[i] = n0 + i < Rn ? nv[n0 + i] : 0.f;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, t2 = (lane & 3) * 2, mt = warp & 1, nt = warp >> 1;
  float acc[kJ][2][2][4];
  zero_acc<kJ>(acc);
  for (int t = t0; t < t1; ++t) {
    const __nv_bfloat16* cur = sq + ((t - t0) & 1) * kBwdTile * ld;
    if (t + 1 < t1)
      stage_rows_async(q, R, D, (t + 1) * kBwdTile, kBwdTile,
                       sq + ((t + 1 - t0) & 1) * kBwdTile * ld, ld);
    cp_async_commit();
    dl.stage(t * kBwdTile, R);
    cp_async_wait<1>();
    __syncthreads();
    // scores: the query rows 16 mt (+ 16) as A against pool rows 8 nt
    const __nv_bfloat16* qw = cur + 16 * mt * ld;
    float x[4];
    score_tile<0>([=](int ks, uint32_t a[4]) { load_a(qw, ld, 16 * ks, a); }, sn + 8 * nt * ld,
                  ld, nks, scale, x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = 16 * mt + gr + 8 * (i >> 1), jn = 8 * nt + t2 + (i & 1);
      const bool live = n0 + jn < Rn && t * kBwdTile + row < R;
      sdl[jn * kBwdDlLd + row] = __float2bfloat16_rn(live ? dl(x[i], snv[jn], row) : 0.f);
    }
    __syncthreads();
    dl_product<kJ>(sdl, cur, ld, Dp, acc);  // dn += dl^T (32 x 32) Q_tile (32 x Dp)
    __syncthreads();
  }
  cp_async_wait<0>();  // no query tile: the pool rows' copy is still in flight
  store_acc<kJ>(acc, out + (splits > 1 ? (size_t)blockIdx.y * Rn * D : 0), n0, Rn, D);
}

constexpr int kMinTilesPerSplit = 2;

// the splits of a launch of ``kernel`` (``threads`` a block, ``smem`` bytes
// of dynamic shared memory) over ``tiles`` blocks of the split dimension:
// enough to fill the blocks the card holds at once, each split at least
// kMinTilesPerSplit of the ``steps`` tiles it walks
template <typename Kernel>
cudaError_t plan_splits(Kernel kernel, size_t smem, int threads, int tiles, int steps,
                        int* splits) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  const int cap = std::max(1, steps / kMinTilesPerSplit);
  *splits = std::max(1, std::min(cap, sms * per_sm / std::max(1, tiles)));
  return cudaSuccess;
}

}  // namespace xrt
