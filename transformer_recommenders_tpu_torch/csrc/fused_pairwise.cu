// Pairwise loss heads over the in-batch pool: each query row's weighted
// mean of f(s) over the pool rows it counts as negatives
// (ContrastiveLoss, PairwiseHingeLoss, PairwiseLogisticLoss and the pool
// term of NCELoss).
//
// pairwise_fwd replaces the TPU Pallas kernel ops/fused_pairwise.py:66
// _fwd_kernel of the JAX package, pairwise_dq its :93 _bwd_dq_kernel and
// pairwise_dn its :127 _bwd_dn_kernel.  Per query row r (scores
// l[r, j] = q[r] . n[j] and pos = q[r] . p[r] over bf16 operands with f32
// sums):
//   v[j] = nv[j] > 0, and l[r, j] < pos where mask_fn
//   s = (l - 1) + margin       head 0, ContrastiveLoss (cosine inputs)
//       l - pos c              heads 1 and 2, PairwiseHingeLoss and
//                              PairwiseLogisticLoss, c = 1 - margin
//       l                      head 3, NCELoss
//   f = relu(s), f' = [s > 0]              heads 0 and 1
//   f = softplus(s), f' = sigmoid(s)       heads 2 and 3
//   den = sum_j v[j],  out = sum_j f v[j] / (den + 1e-9)
// and the backward, with g[r] the cotangent of out[r]:
//   w[j] = v[j] g / (den + 1e-9),  dl[r, j] = bf16(w[j] f')
//   dpos = -c sum_j w[j] f'     (heads 1 and 2, else 0; f32, not rounded)
//   dq = dl N + dpos p,  dp = dpos q,  dn = dl^T Q   (f32)
// c is 1 - margin taken in double by the caller and rounded to f32, as
// JAX's weak-typed constant is.
//
// pos and every pool score are one fixed chain of fmaf over k = 0..D-1 on
// the same bf16 values (xrt::dot4, xrt::positives), so a pool row that is
// a copy of the positive scores exactly pos and the mask drops it.  The
// forward writes each row's pos and den; both backward kernels read them
// back.
//
// What bounds it on the H100: 2 R Rn D operations forward and 4 R Rn D
// for each backward kernel (the scores again, then one product), tensor-
// core work: 2.2 us and 4.3 us at R = Rn = 4096, D = 64; and for the
// smooth heads two special-function results (exp and log, or exp and a
// reciprocal) per counted score, about as long again at 16 results per
// SM per clock.  This first version runs the products as f32 FMAs on
// CUDA cores with the operands staged in shared memory, far from either
// bound; the (R, Rn) scores never reach device memory.  A block loops over
// the tiles that the TPU's sequential grid walks: the forward and dq/dp by
// blocks of query rows over every pool tile, dn by blocks of pool rows over
// every query tile in order.  No atomics, so every result is
// deterministic.  (fused_infonce.cu, the pool InfoNCE kernels of the same
// layout, scores on the tensor cores (xrt::score_tile) and splits the pool
// across blocks; these kernels keep the fmaf chain.)
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

constexpr int kContrastive = 0, kHinge = 1, kLogistic = 2, kNce = 3;

using xrt::allow_smem;
using xrt::bf;
using xrt::dot4;
using xrt::load_rows;
using xrt::positives;

// the head's arguments, one value for the whole launch
struct Head {
  int kind;
  float margin;
  float c;  // 1 - margin

  __device__ __forceinline__ float score(float l, float pos) const {
    if (kind == kContrastive) return __fadd_rn(__fsub_rn(l, 1.f), margin);
    if (kind == kNce) return l;
    return __fsub_rn(l, __fmul_rn(pos, c));
  }
  // f(s): softplus as logaddexp(s, 0), the JAX and torch formula
  __device__ __forceinline__ float value(float s) const {
    if (kind == kContrastive || kind == kHinge) return fmaxf(s, 0.f);
    return fmaxf(s, 0.f) + log1pf(expf(-fabsf(s)));
  }
  __device__ __forceinline__ float slope(float s) const {
    if (kind == kContrastive || kind == kHinge) return s > 0.f ? 1.f : 0.f;
    return 1.f / (1.f + expf(-s));
  }
  // whether pos enters s, so that the positive takes a gradient
  __device__ __forceinline__ bool has_dpos() const { return kind == kHinge || kind == kLogistic; }
};

// whether a pool score counts as a negative of its row
__device__ __forceinline__ bool counted(float l, float nv, float pos, int mask_fn) {
  return nv > 0.f && (!mask_fn || l < pos);
}

// w f' of one pool score, unrounded: gs is the row's g / (den + 1e-9)
__device__ __forceinline__ float weighted_slope(const Head& h, float l, float nv, float pos,
                                                float gs, int mask_fn) {
  return counted(l, nv, pos, mask_fn) ? __fmul_rn(gs, h.slope(h.score(l, pos))) : 0.f;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads) pairwise_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ p,
    const __nv_bfloat16* __restrict__ n, const float* __restrict__ nv, float* __restrict__ out,
    float* __restrict__ den_out, float* __restrict__ pos_out, int R, int Rn, int D, Head h,
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
  positives(sq, ld, p, R, D, r0, kRowTile, 1.f, spos);
  __syncthreads();

  // a half-warp per row, each lane on pool rows lane, lane + 16, lane +
  // 32, lane + 48 of a tile, keeping partial sums of f v and v
  const int rr = threadIdx.x / 16, lane = threadIdx.x % 16;
  const float pos = spos[rr];
  float num = 0.f, den = 0.f;
  for (int n0 = 0; n0 < Rn; n0 += kColTile) {
    load_rows(n, Rn, D, n0, kColTile, sn, ld);
    for (int i = threadIdx.x; i < kColTile; i += blockDim.x)
      snv[i] = n0 + i < Rn ? nv[n0 + i] : 0.f;
    __syncthreads();
    float l4[4];
    dot4(sq + rr * ld, sn + lane * ld, 16 * ld, D, l4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (counted(l4[j], snv[lane + 16 * j], pos, mask_fn)) {
        num += h.value(h.score(l4[j], pos));
        den += 1.f;
      }
    }
    __syncthreads();
  }
  num = half_warp_sum(num);
  den = half_warp_sum(den);
  const int r = r0 + rr;
  if (lane == 0 && r < R) {
    // a row with no counted negative: num = den = 0, so out = 0 exactly
    out[r] = num / (den + 1e-9f);
    den_out[r] = den;
    pos_out[r] = pos;
  }
}

// Backward, one block per kRowTile query rows: dq = dl N + dpos p and
// dp = dpos q, over every pool tile.
__global__ void __launch_bounds__(kThreads) pairwise_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ p,
    const __nv_bfloat16* __restrict__ n, const float* __restrict__ nv,
    const float* __restrict__ den, const float* __restrict__ g, const float* __restrict__ pos_in,
    float* __restrict__ dq, float* __restrict__ dp, int R, int Rn, int D, Head h, int mask_fn) {
  extern __shared__ __align__(16) float smem[];
  const int ld = D + 1;
  float* sq = smem;
  float* sn = sq + kRowTile * ld;
  float* sdl = sn + kColTile * ld;
  float* snv = sdl + kRowTile * kColTile;
  float* spos = snv + kColTile;
  float* sgs = spos + kRowTile;
  float* sdpos = sgs + kRowTile;
  const int r0 = blockIdx.x * kRowTile;
  load_rows(q, R, D, r0, kRowTile, sq, ld);
  for (int t = threadIdx.x; t < kRowTile; t += blockDim.x) {
    const int r = r0 + t;
    spos[t] = r < R ? pos_in[r] : 0.f;
    sgs[t] = r < R ? g[r] / (den[r] + 1e-9f) : 0.f;
  }
  __syncthreads();

  const int rr = threadIdx.x / 16, lane = threadIdx.x % 16;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  float wsum = 0.f;  // this lane's part of sum_j w f' of row rr
  for (int n0 = 0; n0 < Rn; n0 += kColTile) {
    load_rows(n, Rn, D, n0, kColTile, sn, ld);
    for (int i = threadIdx.x; i < kColTile; i += blockDim.x)
      snv[i] = n0 + i < Rn ? nv[n0 + i] : 0.f;
    __syncthreads();
    float l4[4];
    dot4(sq + rr * ld, sn + lane * ld, 16 * ld, D, l4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int jj = lane + 16 * j;
      const bool live = n0 + jj < Rn && r0 + rr < R;
      const float wf = live ? weighted_slope(h, l4[j], snv[jj], spos[rr], sgs[rr], mask_fn) : 0.f;
      wsum += wf;
      sdl[rr * kColTile + jj] = xrt::Act<__nv_bfloat16>::round(wf);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int o = threadIdx.x + kThreads * i;
      if (o < kRowTile * D) {
        const int r = o / D, d = o % D;
        for (int j = 0; j < kColTile; ++j)
          acc[i] = fmaf(sdl[r * kColTile + j], sn[j * ld + d], acc[i]);
      }
    }
    __syncthreads();
  }
  wsum = half_warp_sum(wsum);
  if (lane == 0) sdpos[rr] = h.has_dpos() ? __fmul_rn(wsum, -h.c) : 0.f;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int o = threadIdx.x + kThreads * i;
    if (o < kRowTile * D && r0 + o / D < R) {
      const int r = o / D, d = o % D;
      const size_t at = (size_t)r0 * D + o;
      dq[at] = __fadd_rn(acc[i], __fmul_rn(sdpos[r], bf(p[at])));
      dp[at] = __fmul_rn(sdpos[r], sq[r * ld + d]);
    }
  }
}

// Backward, one block per kDnCols pool rows: dn = dl^T Q over every query
// row, in order.
__global__ void __launch_bounds__(kThreads) pairwise_dn_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ n,
    const float* __restrict__ nv, const float* __restrict__ den, const float* __restrict__ g,
    const float* __restrict__ pos_in, float* __restrict__ dn, int R, int Rn, int D, Head h,
    int mask_fn) {
  extern __shared__ __align__(16) float smem[];
  const int ld = D + 1;
  float* sn = smem;
  float* sq = sn + kDnCols * ld;
  float* sdl = sq + kDnRows * ld;
  float* snv = sdl + kDnRows * kDnCols;
  float* spos = snv + kDnCols;
  float* sgs = spos + kDnRows;
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
      sgs[t] = in ? g[r] / (den[r] + 1e-9f) : 0.f;
    }
    __syncthreads();
    float l4[4];
    dot4(sn + jn * ld, sq + rb * ld, 16 * ld, D, l4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = rb + 16 * j;
      const bool live = n0 + jn < Rn && r0 + r < R;
      sdl[r * kDnCols + jn] = live ? xrt::Act<__nv_bfloat16>::round(weighted_slope(
                                         h, l4[j], snv[jn], spos[r], sgs[r], mask_fn))
                                   : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int o = threadIdx.x + kThreads * i;
      if (o < kDnCols * D) {
        const int cc = o / D, d = o % D;
        for (int r = 0; r < kDnRows; ++r)
          acc[i] = fmaf(sdl[r * kDnCols + cc], sq[r * ld + d], acc[i]);
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
                          2 * kDnRows);
}

bool bad_args(int Rn, int D, int head) {
  return Rn < 0 || D <= 0 || D > kMaxD || head < kContrastive || head > kNce;
}

}  // namespace

// q, p: (R, D) bf16, n: (Rn, D) bf16, nv: (Rn,) f32; head 0-3 as above,
// c = 1 - margin; writes out, den and pos, (R,) f32
extern "C" int pairwise_fwd(const void* q, const void* p, const void* n, const float* nv,
                            float* out, float* den, float* pos, int R, int Rn, int D, int head,
                            float margin, float c, int mask_fn, void* stream) {
  if (bad_args(Rn, D, head)) return cudaErrorInvalidValue;
  if (R <= 0) return cudaSuccess;
  const size_t smem = fwd_smem(D);
  cudaError_t err = allow_smem(pairwise_fwd_kernel, smem);
  if (err != cudaSuccess) return err;
  pairwise_fwd_kernel<<<(R + kRowTile - 1) / kRowTile, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(p),
      static_cast<const __nv_bfloat16*>(n), nv, out, den, pos, R, Rn, D, Head{head, margin, c},
      mask_fn);
  return cudaGetLastError();
}

// dq and dp, (R, D) f32, for the cotangent g of out; den and pos are the
// forward's
extern "C" int pairwise_dq(const void* q, const void* p, const void* n, const float* nv,
                           const float* den, const float* g, const float* pos, float* dq,
                           float* dp, int R, int Rn, int D, int head, float margin, float c,
                           int mask_fn, void* stream) {
  if (bad_args(Rn, D, head)) return cudaErrorInvalidValue;
  if (R <= 0) return cudaSuccess;
  const size_t smem = dq_smem(D);
  cudaError_t err = allow_smem(pairwise_dq_kernel, smem);
  if (err != cudaSuccess) return err;
  pairwise_dq_kernel<<<(R + kRowTile - 1) / kRowTile, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(p),
      static_cast<const __nv_bfloat16*>(n), nv, den, g, pos, dq, dp, R, Rn, D,
      Head{head, margin, c}, mask_fn);
  return cudaGetLastError();
}

// dn, (Rn, D) f32, for the cotangent g of out
extern "C" int pairwise_dn(const void* q, const void* n, const float* nv, const float* den,
                           const float* g, const float* pos, float* dn, int R, int Rn, int D,
                           int head, float margin, float c, int mask_fn, void* stream) {
  if (bad_args(Rn, D, head)) return cudaErrorInvalidValue;
  if (Rn == 0) return cudaSuccess;
  const size_t smem = dn_smem(D);
  cudaError_t err = allow_smem(pairwise_dn_kernel, smem);
  if (err != cudaSuccess) return err;
  pairwise_dn_kernel<<<(Rn + kDnCols - 1) / kDnCols, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(n), nv, den, g, pos,
      dn, R, Rn, D, Head{head, margin, c}, mask_fn);
  return cudaGetLastError();
}
