// In-batch (pool) InfoNCE: each query row scored against its own positive
// and a shared pool of gathered negative rows.
//
// pool_infonce_fwd replaces the TPU Pallas kernel ops/fused_infonce.py:85
// _fwd_kernel of the JAX package, pool_infonce_dq its :159 _bwd_dq_kernel
// and pool_infonce_dn its :193 _bwd_dn_kernel.  Per query row r (scores
// x[r, j] = scale * q[r] . n[j] and pos = scale * q[r] . p[r] over bf16
// operands with f32 sums):
//   v[j] = nv[j] > 0, and x[r, j] < pos where mask_fn
//   lse = log(exp(pos) + sum_{v[j]} exp(x[r, j])),  ce = lse - pos
// and the backward, with g[r] the cotangent of ce[r]:
//   dl[r, j] = bf16(v[j] exp(x[r, j] - lse) * (g scale))
//   dpos = g scale (exp(pos - lse) - 1)           (f32, not rounded)
//   dq = dl N + dpos p,  dp = dpos q,  dn = dl^T Q   (f32)
//
// pos and every pool score are one fixed chain of fmaf over k = 0..D-1
// on the same bf16 values (xrt::dot4), then an unfused multiply by scale,
// so a pool row that is a copy of the positive scores exactly pos and the
// mask x < pos drops it.  The forward writes each row's pos; both
// backward kernels read it back instead of recomputing it.
//
// What bounds it on the H100: 2 R Rn D operations forward, 4 R Rn D for
// each backward kernel (the scores again, then one product), tensor-core
// work: 4.3 us forward and 8.7 us for each backward kernel at
// R = Rn = 4096, D = 128.  This first version runs the products as f32
// FMAs on CUDA cores with the operands staged in shared memory, far from
// that bound; the (R, Rn) scores never reach device memory.  The TPU's
// sequential grid carries its accumulators across pool tiles; here a
// block loops over the tiles itself: dq/dp by blocks of query rows over
// every pool tile, dn by blocks of pool rows over every query tile in
// order.  No atomics, so both backward results are deterministic.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowTile = 16;  // query rows of a block (forward and the dq pass)
constexpr int kColTile = 64;  // pool rows staged per step (forward and the dq pass)
constexpr int kDnCols = 16;   // pool rows of a block (the dn pass)
constexpr int kDnRows = 64;   // query rows staged per step (the dn pass)
constexpr int kMaxD = 512;
constexpr int kAcc = kRowTile * kMaxD / kThreads;  // outputs a thread accumulates
static_assert(kDnCols * kMaxD / kThreads == kAcc, "both passes hold kAcc outputs a thread");

using xrt::allow_smem;
using xrt::bf;
using xrt::dot4;
using xrt::load_rows;
using xrt::positives;

// whether a pool score counts as a negative of its row
__device__ __forceinline__ bool counted(float x, float nv, float pos, int mask_fn) {
  return nv > 0.f && (!mask_fn || x < pos);
}

// dl of one pool score, rounded to bf16 (the JAX kernels' dl.astype(bf16))
__device__ __forceinline__ float grad_logit(float x, float nv, float pos, float lse, float gs,
                                            int mask_fn) {
  return counted(x, nv, pos, mask_fn) ? xrt::Act<__nv_bfloat16>::round(expf(x - lse) * gs) : 0.f;
}

__global__ void __launch_bounds__(kThreads) pool_infonce_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ p,
    const __nv_bfloat16* __restrict__ n, const float* __restrict__ nv, float* __restrict__ ce,
    float* __restrict__ lse_out, float* __restrict__ pos_out, int R, int Rn, int D, float scale,
    int mask_fn) {
  extern __shared__ __align__(16) float smem[];
  const int ld = D + 1;  // odd stride: the 16 rows a half-warp reads hit 16 banks
  float* sq = smem;
  float* sn = sq + kRowTile * ld;
  float* snv = sn + kColTile * ld;
  float* spos = snv + kColTile;
  const int r0 = blockIdx.x * kRowTile;
  load_rows(q, R, D, r0, kRowTile, sq, ld);
  __syncthreads();
  positives(sq, ld, p, R, D, r0, kRowTile, scale, spos);
  __syncthreads();

  // a half-warp per row, each lane on pool rows c, c + 16, c + 32, c + 48
  // of a tile, keeping a running (max, sum) over the counted scores; the
  // max starts at the positive's score, whose term is added at the end
  const int rr = threadIdx.x / 16, c = threadIdx.x % 16;
  const float pos = spos[rr];
  float m = pos, s = 0.f;
  for (int n0 = 0; n0 < Rn; n0 += kColTile) {
    load_rows(n, Rn, D, n0, kColTile, sn, ld);
    for (int i = threadIdx.x; i < kColTile; i += blockDim.x)
      snv[i] = n0 + i < Rn ? nv[n0 + i] : 0.f;
    __syncthreads();
    float acc[4];
    dot4(sq + rr * ld, sn + c * ld, 16 * ld, D, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x = __fmul_rn(acc[j], scale);
      if (counted(x, snv[c + 16 * j], pos, mask_fn)) {
        if (x > m) {
          s = s * expf(m - x) + 1.f;
          m = x;
        } else {
          s += expf(x - m);
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
    // a row with no counted negative: m = pos, s = 0, so ce = 0 exactly
    const float lse = m + logf(expf(pos - m) + s);
    lse_out[r] = lse;
    ce[r] = lse - pos;
    pos_out[r] = pos;
  }
}

// Backward, one block per kRowTile query rows: dq = dl N + dpos p and
// dp = dpos q, over every pool tile.
__global__ void __launch_bounds__(kThreads) pool_infonce_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ p,
    const __nv_bfloat16* __restrict__ n, const float* __restrict__ nv,
    const float* __restrict__ lse, const float* __restrict__ g, const float* __restrict__ pos_in,
    float* __restrict__ dq, float* __restrict__ dp, int R, int Rn, int D, float scale,
    int mask_fn) {
  extern __shared__ __align__(16) float smem[];
  const int ld = D + 1;
  float* sq = smem;
  float* sn = sq + kRowTile * ld;
  float* sdl = sn + kColTile * ld;
  float* snv = sdl + kRowTile * kColTile;
  float* spos = snv + kColTile;
  float* slse = spos + kRowTile;
  float* sgs = slse + kRowTile;
  const int r0 = blockIdx.x * kRowTile;
  load_rows(q, R, D, r0, kRowTile, sq, ld);
  for (int t = threadIdx.x; t < kRowTile; t += blockDim.x) {
    const int r = r0 + t;
    spos[t] = r < R ? pos_in[r] : 0.f;
    slse[t] = r < R ? lse[r] : 0.f;
    sgs[t] = r < R ? g[r] * scale : 0.f;
  }
  __syncthreads();

  const int rr = threadIdx.x / 16, c = threadIdx.x % 16;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  for (int n0 = 0; n0 < Rn; n0 += kColTile) {
    load_rows(n, Rn, D, n0, kColTile, sn, ld);
    for (int i = threadIdx.x; i < kColTile; i += blockDim.x)
      snv[i] = n0 + i < Rn ? nv[n0 + i] : 0.f;
    __syncthreads();
    float x4[4];
    dot4(sq + rr * ld, sn + c * ld, 16 * ld, D, x4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int jj = c + 16 * j;
      const bool live = n0 + jj < Rn && r0 + rr < R;
      sdl[rr * kColTile + jj] =
          live ? grad_logit(__fmul_rn(x4[j], scale), snv[jj], spos[rr], slse[rr], sgs[rr], mask_fn)
               : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int o = threadIdx.x + kThreads * i;
      if (o < kRowTile * D) {
        const int r = o / D, d = o % D;
        for (int j = 0; j < kColTile; ++j) acc[i] = fmaf(sdl[r * kColTile + j], sn[j * ld + d], acc[i]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int o = threadIdx.x + kThreads * i;
    if (o < kRowTile * D && r0 + o / D < R) {
      const int r = o / D, d = o % D;
      const size_t at = (size_t)r0 * D + o;
      const float dpos = sgs[r] * (expf(spos[r] - slse[r]) - 1.f);
      dq[at] = __fadd_rn(acc[i], __fmul_rn(dpos, bf(p[at])));
      dp[at] = __fmul_rn(dpos, sq[r * ld + d]);
    }
  }
}

// Backward, one block per kDnCols pool rows: dn = dl^T Q over every query
// row, in order.
__global__ void __launch_bounds__(kThreads) pool_infonce_dn_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ n,
    const float* __restrict__ nv, const float* __restrict__ lse, const float* __restrict__ g,
    const float* __restrict__ pos_in, float* __restrict__ dn, int R, int Rn, int D, float scale,
    int mask_fn) {
  extern __shared__ __align__(16) float smem[];
  const int ld = D + 1;
  float* sn = smem;
  float* sq = sn + kDnCols * ld;
  float* sdl = sq + kDnRows * ld;
  float* snv = sdl + kDnRows * kDnCols;
  float* spos = snv + kDnCols;
  float* slse = spos + kDnRows;
  float* sgs = slse + kDnRows;
  const int n0 = blockIdx.x * kDnCols;
  load_rows(n, Rn, D, n0, kDnCols, sn, ld);
  for (int i = threadIdx.x; i < kDnCols; i += blockDim.x) snv[i] = n0 + i < Rn ? nv[n0 + i] : 0.f;

  // scores: lane jn = t % 16 on pool row jn, query rows rb + 16 j of the tile
  const int jn = threadIdx.x % kDnCols, rb = threadIdx.x / kDnCols;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  for (int r0 = 0; r0 < R; r0 += kDnRows) {
    __syncthreads();
    load_rows(q, R, D, r0, kDnRows, sq, ld);
    for (int t = threadIdx.x; t < kDnRows; t += blockDim.x) {
      const int r = r0 + t;
      const bool in = r < R;
      spos[t] = in ? pos_in[r] : 0.f;
      slse[t] = in ? lse[r] : 0.f;
      sgs[t] = in ? g[r] * scale : 0.f;
    }
    __syncthreads();
    float x4[4];
    dot4(sn + jn * ld, sq + rb * ld, 16 * ld, D, x4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = rb + 16 * j;
      const bool live = n0 + jn < Rn && r0 + r < R;
      sdl[r * kDnCols + jn] =
          live ? grad_logit(__fmul_rn(x4[j], scale), snv[jn], spos[r], slse[r], sgs[r], mask_fn)
               : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int o = threadIdx.x + kThreads * i;
      if (o < kDnCols * D) {
        const int cc = o / D, d = o % D;
        for (int r = 0; r < kDnRows; ++r) acc[i] = fmaf(sdl[r * kDnCols + cc], sq[r * ld + d], acc[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int o = threadIdx.x + kThreads * i;
    if (o < kDnCols * D && n0 + o / D < Rn) dn[(size_t)n0 * D + o] = acc[i];
  }
}

size_t fwd_smem(int D) {
  return sizeof(float) * ((size_t)(kRowTile + kColTile) * (D + 1) + kColTile + kRowTile);
}
size_t dq_smem(int D) {
  return sizeof(float) * ((size_t)(kRowTile + kColTile) * (D + 1) + kRowTile * kColTile +
                          kColTile + 3 * kRowTile);
}
size_t dn_smem(int D) {
  return sizeof(float) * ((size_t)(kDnCols + kDnRows) * (D + 1) + kDnRows * kDnCols + kDnCols +
                          3 * kDnRows);
}

bool bad_shape(int Rn, int D) { return Rn < 0 || D <= 0 || D > kMaxD; }

}  // namespace

// q, p: (R, D) bf16, n: (Rn, D) bf16, nv: (Rn,) f32; writes ce, lse and
// pos, (R,) f32
extern "C" int pool_infonce_fwd(const void* q, const void* p, const void* n, const float* nv,
                                float* ce, float* lse, float* pos, int R, int Rn, int D,
                                float scale, int mask_fn, void* stream) {
  if (bad_shape(Rn, D)) return cudaErrorInvalidValue;
  if (R <= 0) return cudaSuccess;
  const size_t smem = fwd_smem(D);
  cudaError_t err = allow_smem(pool_infonce_fwd_kernel, smem);
  if (err != cudaSuccess) return err;
  pool_infonce_fwd_kernel<<<(R + kRowTile - 1) / kRowTile, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(p),
      static_cast<const __nv_bfloat16*>(n), nv, ce, lse, pos, R, Rn, D, scale, mask_fn);
  return cudaGetLastError();
}

// dq and dp, (R, D) f32, for the cotangent g of ce; lse and pos are the
// forward's
extern "C" int pool_infonce_dq(const void* q, const void* p, const void* n, const float* nv,
                               const float* lse, const float* g, const float* pos, float* dq,
                               float* dp, int R, int Rn, int D, float scale, int mask_fn,
                               void* stream) {
  if (bad_shape(Rn, D)) return cudaErrorInvalidValue;
  if (R <= 0) return cudaSuccess;
  const size_t smem = dq_smem(D);
  cudaError_t err = allow_smem(pool_infonce_dq_kernel, smem);
  if (err != cudaSuccess) return err;
  pool_infonce_dq_kernel<<<(R + kRowTile - 1) / kRowTile, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(p),
      static_cast<const __nv_bfloat16*>(n), nv, lse, g, pos, dq, dp, R, Rn, D, scale, mask_fn);
  return cudaGetLastError();
}

// dn, (Rn, D) f32, for the cotangent g of ce
extern "C" int pool_infonce_dn(const void* q, const void* n, const float* nv, const float* lse,
                               const float* g, const float* pos, float* dn, int R, int Rn, int D,
                               float scale, int mask_fn, void* stream) {
  if (bad_shape(Rn, D)) return cudaErrorInvalidValue;
  if (Rn == 0) return cudaSuccess;
  const size_t smem = dn_smem(D);
  cudaError_t err = allow_smem(pool_infonce_dn_kernel, smem);
  if (err != cudaSuccess) return err;
  pool_infonce_dn_kernel<<<(Rn + kDnCols - 1) / kDnCols, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(n), nv, lse, g, pos,
      dn, R, Rn, D, scale, mask_fn);
  return cudaGetLastError();
}
