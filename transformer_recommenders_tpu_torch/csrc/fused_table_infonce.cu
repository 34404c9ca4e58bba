// Table-scored InfoNCE: each query row scored against the whole catalog,
// the catalog columns weighted by their count in the negative pool.
//
// table_infonce_fwd replaces the TPU Pallas kernel
// ops/fused_table_infonce.py:_fwd_kernel of the JAX package, and
// table_infonce_bwd its _bwd_kernel.  Per query row r (scores
// x[r, n] = scale * q[r] . t[n] over bf16 operands with f32 sums):
//   pos = x[r, pos_idx[r]]  (0 when pos_idx[r] is outside [0, N))
//   w[n] = counts[n], zeroed where mask_fn and not x[r, n] < pos
//   lse = log(exp(pos) + sum_n w[n] exp(x[r, n])),  ce = lse - pos
// and the backward, with g[r] the cotangent of ce[r]:
//   dl[r, n] = bf16(g scale (w exp(x - lse) + [n == pos_idx] (exp(pos - lse) - 1)))
//   dq = dl T,  dT = dl^T Q   (f32)
//
// pos must equal the score at column pos_idx bit for bit: the mask
// x < pos has to drop every copy of the positive item in the pool, and a
// pos summed in another order would leave a copy one ulp below it counted
// as a negative.  Every score here, pos included, is one fixed chain of
// fmaf over k = 0..D-1 on the same values (a product of two bf16 values
// is exact in f32, so the chain rounds the same wherever it runs),
// followed by an unfused multiply by scale.
//
// What bounds it on the H100: 2 R N D operations forward and 8 R N D
// backward (the backward recomputes the scores twice), tensor-core work:
// ~4 us and ~16 us at R=4096, N=3707, D=128.  This first version runs the
// products as f32 FMAs on CUDA cores with the operands staged in shared
// memory, far from that bound; the scores never reach device memory.
// The backward is deterministic, without atomics: one pass over row tiles
// writes dq (and each row's pos), a second over column tiles walks every
// row in order and writes dT, each recomputing its dl tiles.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowTile = 16;  // query rows of a block (forward and the dq pass)
constexpr int kColTile = 64;  // catalog rows staged per step (forward and the dq pass)
constexpr int kDtCols = 16;   // catalog rows of a block (the dT pass)
constexpr int kDtRows = 64;   // query rows staged per step (the dT pass)
constexpr int kMaxD = 512;
constexpr int kAcc = kRowTile * kMaxD / kThreads;  // outputs a thread accumulates
static_assert(kDtCols * kMaxD / kThreads == kAcc, "both passes hold kAcc outputs a thread");

using xrt::allow_smem;
using xrt::bf;
using xrt::dot4;
using xrt::load_rows;

// pos of query rows [r0, r0 + kRowTile), the q rows staged in sq: the
// same chain as dot4, on the table row read from device memory
__device__ void positives(const float* sq, int ld, const __nv_bfloat16* __restrict__ table,
                          const int* __restrict__ pos_idx, int N, int D, int R, int r0,
                          float scale, float* spos) {
  for (int t = threadIdx.x; t < kRowTile; t += blockDim.x) {
    const int r = r0 + t;
    const int p = r < R ? pos_idx[r] : -1;
    float pos = 0.f;
    if (p >= 0 && p < N) {
      const __nv_bfloat16* row = table + (size_t)p * D;
      float acc = 0.f;
      for (int k = 0; k < D; ++k) acc = fmaf(sq[t * ld + k], bf(row[k]), acc);
      pos = __fmul_rn(acc, scale);
    }
    spos[t] = pos;
  }
}

// the pool weight of a score after the false-negative mask
__device__ __forceinline__ float weight(float x, float count, float pos, int mask_fn) {
  return (mask_fn && !(x < pos)) ? 0.f : count;
}

// dl of one score, rounded to bf16 (the JAX kernel's dl.astype(bf16))
__device__ __forceinline__ float grad_logit(float x, float count, float pos, float lse, float gs,
                                            float pprob, bool sel, int mask_fn) {
  const float w = weight(x, count, pos, mask_fn);
  const float qprob = w > 0.f ? w * expf(x - lse) : 0.f;
  return xrt::Act<__nv_bfloat16>::round(gs * (qprob + (sel ? pprob - 1.f : 0.f)));
}

__global__ void __launch_bounds__(kThreads) table_infonce_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ table,
    const int* __restrict__ pos_idx, const float* __restrict__ counts, float* __restrict__ ce,
    float* __restrict__ lse_out, int R, int N, int D, float scale, int mask_fn) {
  extern __shared__ __align__(16) float smem[];
  const int ld = D + 1;  // odd stride: the 16 columns of a half-warp hit 16 banks
  float* sq = smem;
  float* st = sq + kRowTile * ld;
  float* scnt = st + kColTile * ld;
  float* spos = scnt + kColTile;
  const int r0 = blockIdx.x * kRowTile;
  load_rows(q, R, D, r0, kRowTile, sq, ld);
  __syncthreads();
  positives(sq, ld, table, pos_idx, N, D, R, r0, scale, spos);
  __syncthreads();

  // a half-warp per row, each lane on columns c, c + 16, c + 32, c + 48 of
  // a tile, keeping a running (max, sum) over the columns with w > 0
  const int rr = threadIdx.x / 16, c = threadIdx.x % 16;
  const float pos = spos[rr];
  float m = pos, s = 0.f;
  for (int n0 = 0; n0 < N; n0 += kColTile) {
    load_rows(table, N, D, n0, kColTile, st, ld);
    for (int i = threadIdx.x; i < kColTile; i += blockDim.x)
      scnt[i] = n0 + i < N ? counts[n0 + i] : 0.f;
    __syncthreads();
    float acc[4];
    dot4(sq + rr * ld, st + c * ld, 16 * ld, D, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = c + 16 * j;
      const float x = __fmul_rn(acc[j], scale);
      const float w = weight(x, scnt[n], pos, mask_fn);
      if (w > 0.f) {
        if (x > m) {
          s = s * expf(m - x) + w;
          m = x;
        } else {
          s += w * expf(x - m);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    const float mn = fmaxf(m, m2);
    s = s * expf(m - mn) + s2 * expf(m2 - mn);
    m = mn;
  }
  const int r = r0 + rr;
  if (c == 0 && r < R) {
    const float lse = m + logf(expf(pos - m) + s);
    lse_out[r] = lse;
    ce[r] = lse - pos;
  }
}

// Backward pass 1, one block per kRowTile query rows: dq = dl T, and each
// row's pos for pass 2.
__global__ void __launch_bounds__(kThreads) table_infonce_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ table,
    const int* __restrict__ pos_idx, const float* __restrict__ counts,
    const float* __restrict__ lse, const float* __restrict__ g, float* __restrict__ dq,
    float* __restrict__ pos_out, int R, int N, int D, float scale, int mask_fn) {
  extern __shared__ __align__(16) float smem[];
  const int ld = D + 1;
  float* sq = smem;
  float* st = sq + kRowTile * ld;
  float* sdl = st + kColTile * ld;
  float* scnt = sdl + kRowTile * kColTile;
  float* spos = scnt + kColTile;
  float* slse = spos + kRowTile;
  float* sgs = slse + kRowTile;
  float* spp = sgs + kRowTile;
  int* spidx = reinterpret_cast<int*>(spp + kRowTile);
  const int r0 = blockIdx.x * kRowTile;
  load_rows(q, R, D, r0, kRowTile, sq, ld);
  for (int t = threadIdx.x; t < kRowTile; t += blockDim.x) {
    const int r = r0 + t;
    slse[t] = r < R ? lse[r] : 0.f;
    sgs[t] = r < R ? g[r] * scale : 0.f;
    spidx[t] = r < R ? pos_idx[r] : -1;
  }
  __syncthreads();
  positives(sq, ld, table, pos_idx, N, D, R, r0, scale, spos);
  __syncthreads();
  for (int t = threadIdx.x; t < kRowTile; t += blockDim.x) {
    spp[t] = expf(spos[t] - slse[t]);
    if (r0 + t < R) pos_out[r0 + t] = spos[t];
  }

  const int rr = threadIdx.x / 16, c = threadIdx.x % 16;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  for (int n0 = 0; n0 < N; n0 += kColTile) {
    load_rows(table, N, D, n0, kColTile, st, ld);
    for (int i = threadIdx.x; i < kColTile; i += blockDim.x)
      scnt[i] = n0 + i < N ? counts[n0 + i] : 0.f;
    __syncthreads();
    float x4[4];
    dot4(sq + rr * ld, st + c * ld, 16 * ld, D, x4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = c + 16 * j;
      const bool live = n0 + n < N && r0 + rr < R;
      sdl[rr * kColTile + n] =
          live ? grad_logit(__fmul_rn(x4[j], scale), scnt[n], spos[rr], slse[rr], sgs[rr],
                            spp[rr], n0 + n == spidx[rr], mask_fn)
               : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int o = threadIdx.x + kThreads * i;
      if (o < kRowTile * D) {
        const int r = o / D, d = o % D;
        for (int n = 0; n < kColTile; ++n) acc[i] = fmaf(sdl[r * kColTile + n], st[n * ld + d], acc[i]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int o = threadIdx.x + kThreads * i;
    if (o < kRowTile * D && r0 + o / D < R) dq[(size_t)r0 * D + o] = acc[i];
  }
}

// Backward pass 2, one block per kDtCols catalog rows: dT = dl^T Q over
// every query row, in order.
__global__ void __launch_bounds__(kThreads) table_infonce_dt_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ table,
    const int* __restrict__ pos_idx, const float* __restrict__ counts,
    const float* __restrict__ lse, const float* __restrict__ g, const float* __restrict__ pos_in,
    float* __restrict__ dtable, int R, int N, int D, float scale, int mask_fn) {
  extern __shared__ __align__(16) float smem[];
  const int ld = D + 1;
  float* st = smem;
  float* sq = st + kDtCols * ld;
  float* sdl = sq + kDtRows * ld;
  float* scnt = sdl + kDtRows * kDtCols;
  float* spos = scnt + kDtCols;
  float* slse = spos + kDtRows;
  float* sgs = slse + kDtRows;
  float* spp = sgs + kDtRows;
  int* spidx = reinterpret_cast<int*>(spp + kDtRows);
  const int n0 = blockIdx.x * kDtCols;
  load_rows(table, N, D, n0, kDtCols, st, ld);
  for (int i = threadIdx.x; i < kDtCols; i += blockDim.x) scnt[i] = n0 + i < N ? counts[n0 + i] : 0.f;

  // scores: lane n = t % 16 on catalog row n, rows rb + 16 j of the tile
  const int n = threadIdx.x % kDtCols, rb = threadIdx.x / kDtCols;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  for (int r0 = 0; r0 < R; r0 += kDtRows) {
    __syncthreads();
    load_rows(q, R, D, r0, kDtRows, sq, ld);
    for (int t = threadIdx.x; t < kDtRows; t += blockDim.x) {
      const int r = r0 + t;
      const bool in = r < R;
      spos[t] = in ? pos_in[r] : 0.f;
      slse[t] = in ? lse[r] : 0.f;
      sgs[t] = in ? g[r] * scale : 0.f;
      spp[t] = expf(spos[t] - slse[t]);
      spidx[t] = in ? pos_idx[r] : -1;
    }
    __syncthreads();
    float x4[4];
    dot4(st + n * ld, sq + rb * ld, 16 * ld, D, x4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = rb + 16 * j;
      const bool live = n0 + n < N && r0 + r < R;
      sdl[r * kDtCols + n] =
          live ? grad_logit(__fmul_rn(x4[j], scale), scnt[n], spos[r], slse[r], sgs[r], spp[r],
                            n0 + n == spidx[r], mask_fn)
               : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int o = threadIdx.x + kThreads * i;
      if (o < kDtCols * D) {
        const int nn = o / D, d = o % D;
        for (int r = 0; r < kDtRows; ++r) acc[i] = fmaf(sdl[r * kDtCols + nn], sq[r * ld + d], acc[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int o = threadIdx.x + kThreads * i;
    if (o < kDtCols * D && n0 + o / D < N) dtable[(size_t)n0 * D + o] = acc[i];
  }
}

size_t fwd_smem(int D) {
  return sizeof(float) * ((size_t)(kRowTile + kColTile) * (D + 1) + kColTile + kRowTile);
}
size_t dq_smem(int D) {
  return sizeof(float) * ((size_t)(kRowTile + kColTile) * (D + 1) + kRowTile * kColTile +
                          kColTile + 5 * kRowTile);
}
size_t dt_smem(int D) {
  return sizeof(float) * ((size_t)(kDtCols + kDtRows) * (D + 1) + kDtRows * kDtCols + kDtCols +
                          5 * kDtRows);
}

}  // namespace

// q: (R, D) bf16, table: (N, D) bf16, pos_idx: (R,) int32, counts: (N,)
// f32; writes ce and lse, (R,) f32
extern "C" int table_infonce_fwd(const void* q, const void* table, const int* pos_idx,
                                 const float* counts, float* ce, float* lse, int R, int N, int D,
                                 float scale, int mask_fn, void* stream) {
  if (R <= 0) return cudaSuccess;
  if (N <= 0 || D <= 0 || D > kMaxD) return cudaErrorInvalidValue;
  const size_t smem = fwd_smem(D);
  cudaError_t err = allow_smem(table_infonce_fwd_kernel, smem);
  if (err != cudaSuccess) return err;
  table_infonce_fwd_kernel<<<(R + kRowTile - 1) / kRowTile, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(table), pos_idx,
      counts, ce, lse, R, N, D, scale, mask_fn);
  return cudaGetLastError();
}

// the backward of table_infonce_fwd for the cotangent g of ce: dq (R, D)
// and dtable (N, D), f32; pos_ws is an (R,) f32 workspace
extern "C" int table_infonce_bwd(const void* q, const void* table, const int* pos_idx,
                                 const float* counts, const float* lse, const float* g, float* dq,
                                 float* dtable, float* pos_ws, int R, int N, int D, float scale,
                                 int mask_fn, void* stream) {
  if (N <= 0 || D <= 0 || D > kMaxD) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* tb = static_cast<const __nv_bfloat16*>(table);
  cudaError_t err;
  if (R > 0) {
    const size_t smem = dq_smem(D);
    if ((err = allow_smem(table_infonce_dq_kernel, smem)) != cudaSuccess) return err;
    table_infonce_dq_kernel<<<(R + kRowTile - 1) / kRowTile, kThreads, smem, s>>>(
        qb, tb, pos_idx, counts, lse, g, dq, pos_ws, R, N, D, scale, mask_fn);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const size_t smem = dt_smem(D);
  if ((err = allow_smem(table_infonce_dt_kernel, smem)) != cudaSuccess) return err;
  table_infonce_dt_kernel<<<(N + kDtCols - 1) / kDtCols, kThreads, smem, s>>>(
      qb, tb, pos_idx, counts, lse, g, pos_ws, dtable, R, N, D, scale, mask_fn);
  return cudaGetLastError();
}
