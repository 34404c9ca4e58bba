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
// pos and every pool score come from one device function, xrt::score_tile
// (common.cuh), the chain of the pool and table InfoNCE kernels: mma.sync
// m16n8k16 over the same bf16 values with the query row as the A operand,
// k zero-padded to a multiple of 16 and taken in increasing steps of 16
// from a zero accumulator (scale 1).  pos is the same chain against the
// gathered positive rows, on the diagonal of a block's rows against their
// own positives.  A pool row that is a copy of a row's positive therefore
// scores exactly that row's pos in all three kernels, and the mask l < pos
// drops it in each.  The forward writes each row's pos and den; both
// backward kernels read them back.
//
// What bounds it on the H100: 2 R Rn D operations forward and 4 R Rn D
// for each backward kernel (the scores again, then one product) on the
// tensor cores, 2.2 us and 4.3 us at path C's R = Rn = 4096, D = 64; and
// for the smooth heads two special-function results per counted score
// (exp and log forward, exp and a reciprocal backward), 3.6 us at 16
// results per SM per clock.  The (R, Rn) scores never reach device memory.
// The design is the pool InfoNCE kernels' (fused_infonce.cu) and the table
// InfoNCE dT pass's (fused_table_infonce.cu):
// - forward: a block takes kRows = 32 query rows and one split of the pool
//   tiles of kPool = 32 rows (grid (R / 32, splits), the splits filling the
//   card's resident blocks, at least two tiles each); its 8 warps each
//   score a 16 x 8 tile of every 32 x 32 tile of scores.  q and the pool
//   tiles are staged in shared memory as bf16 (leading dimension D + 8),
//   the pool double-buffered with cp.async; the query fragments stay in
//   registers up to D = 384.  Each lane sums f(s) and the count of its
//   counted scores; the lanes of a quad, then the four warps of a row,
//   add in a fixed order into the split's (num, den).  A second kernel
//   adds the splits in split order and writes out and den (a row with no
//   counted negative gets out = 0 exactly); split 0's blocks write pos.
// - dq/dp (xrt::dq_tiles, the pool InfoNCE dq kernel's loop): a block
//   takes 32 query rows, their fragments in registers, and one split of
//   the pool tiles, double-buffered with cp.async (grid (R / 32, splits));
//   dl goes to shared memory row-major as bf16 and dq += dl N_tile runs on
//   the tensor cores (B fragments by ldmatrix.trans from the row-major
//   pool tile).  Each lane sums its rows' unrounded w f'; the quad, then
//   the four warps of a row, add in a fixed order.  Each split writes its
//   partial dq (into dq itself with one split) and its rows' sums to a
//   workspace; a last kernel adds them in split order and writes dpos =
//   -c sum w f', dq and dp.
// - dn (xrt::dn_block): a block takes kPool = 32 pool rows and one split
//   of the query-row tiles of 32, walking them in order, double-buffered
//   with cp.async (grid (Rn / 32, splits)); its scores are score_tile's
//   with the query rows as A, dl goes to shared memory transposed as bf16,
//   and dl^T Q_tile runs on the tensor cores (B fragments by
//   ldmatrix.trans from the row-major query tile); a last kernel adds the
//   splits' partial dn in split order.
// No atomics: every sum runs in a fixed order, so two calls give the same
// bits.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = xrt::kBwdThreads;  // 8 warps
constexpr int kRows = xrt::kBwdTile;  // query rows of a block (forward, dq) or of a step (dn)
constexpr int kPool = xrt::kBwdTile;  // pool rows of a step (forward, dq) or of a block (dn)
constexpr int kMaxD = 512;
static_assert(kRows == 2 * 16 && kPool == 4 * 8 && kThreads == 8 * 32,
              "8 warps, one 16 x 8 score tile each");
static_assert(kRows <= kPool, "the positives are staged in a pool buffer");

constexpr int kContrastive = 0, kHinge = 1, kLogistic = 2, kNce = 3;

using xrt::allow_smem;
using xrt::cp_async_commit;
using xrt::cp_async_wait;
using xrt::diagonal_pos;
using xrt::pad16;
using xrt::plan_splits;
using xrt::QueryFrags;
using xrt::score_tile;
using xrt::split_tiles;
using xrt::stage_rows_async;
using xrt::zero_pad_cols;

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
__device__ __forceinline__ float weighted_slope(const Head& hd, float l, float nv, float pos,
                                                float gs, int mask_fn) {
  return counted(l, nv, pos, mask_fn) ? __fmul_rn(gs, hd.slope(hd.score(l, pos))) : 0.f;
}

// the lanes of a quad (lane & ~3 .. + 3) add v, every lane getting the same bits
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Forward, block (row tile, split): the split's partial (sum of f v, sum
// of v) per row into part[split][r], and pos (split 0).
template <int kKs>
__global__ void __launch_bounds__(kThreads) pairwise_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ p, const bf16* __restrict__ n,
    const float* __restrict__ nv, float* __restrict__ part, float* __restrict__ pos_out, int R,
    int Rn, int D, Head hd, int mask_fn, int splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nks = pad16(D) / 16, ld = pad16(D) + 8;
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sn = sq + kRows * ld;  // two pool buffers of kPool rows
  float* spos = reinterpret_cast<float*>(sn + 2 * kPool * ld);
  float* sred = spos + kRows;  // [n-tile][row][num, den]
  const int r0 = blockIdx.x * kRows;
  int t0, t1;
  split_tiles(Rn, kPool, splits, t0, t1);
  zero_pad_cols(sq, kRows + 2 * kPool, D, ld);
  stage_rows_async(q, R, D, r0, kRows, sq, ld);
  stage_rows_async(p, R, D, r0, kRows, sn + kPool * ld, ld);  // the positives into buffer 1
  cp_async_commit();
  if (t0 < t1) stage_rows_async(n, Rn, D, t0 * kPool, kPool, sn, ld);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t2 = (lane & 3) * 2, mt = warp & 1, nt = warp >> 1;
  const QueryFrags<kKs> qa(sq + 16 * mt * ld, ld, nks);
  diagonal_pos<kKs>(qa, sn + kPool * ld, ld, nks, 1.f, spos);
  __syncthreads();

  float pos[2], num[2] = {0.f, 0.f}, den[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) pos[h] = spos[16 * mt + g + 8 * h];
  for (int t = t0; t < t1; ++t) {
    const bf16* cur = sn + ((t - t0) & 1) * kPool * ld;
    if (t + 1 < t1)
      stage_rows_async(n, Rn, D, (t + 1) * kPool, kPool, sn + ((t + 1 - t0) & 1) * kPool * ld, ld);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float x[4];
    score_tile<kKs>(qa, cur + 8 * nt * ld, ld, nks, 1.f, x);
    const int j = t * kPool + 8 * nt + t2;
    const float v[2] = {j < Rn ? nv[j] : 0.f, j + 1 < Rn ? nv[j + 1] : 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (counted(x[2 * h + e], v[e], pos[h], mask_fn)) {
          num[h] += hd.value(hd.score(x[2 * h + e], pos[h]));
          den[h] += 1.f;
        }
    __syncthreads();
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    num[h] = quad_sum(num[h]);
    den[h] = quad_sum(den[h]);
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* at = sred + (nt * kRows + 16 * mt + g + 8 * h) * 2;
      at[0] = num[h];
      at[1] = den[h];
    }
  }
  __syncthreads();
  if (threadIdx.x < kRows) {
    const int row = threadIdx.x, r = r0 + row;
    float nn = sred[row * 2], dd = sred[row * 2 + 1];
    for (int w = 1; w < 4; ++w) {
      nn += sred[(w * kRows + row) * 2];
      dd += sred[(w * kRows + row) * 2 + 1];
    }
    if (r < R) {
      float* at = part + ((size_t)blockIdx.y * R + r) * 2;
      at[0] = nn;
      at[1] = dd;
      if (blockIdx.y == 0) pos_out[r] = spos[row];
    }
  }
}

// The forward's second kernel: each row's splits added in split order; a
// row with no counted negative has num = den = 0, so out = 0 exactly.
__global__ void pairwise_combine_kernel(const float* __restrict__ part, float* __restrict__ out,
                                        float* __restrict__ den_out, int R, int splits) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  float num = 0.f, den = 0.f;
  for (int sp = 0; sp < splits; ++sp) {
    const float* at = part + ((size_t)sp * R + r) * 2;
    num += at[0];
    den += at[1];
  }
  out[r] = num / (den + 1e-9f);
  den_out[r] = den;
}

// What the backward kernels need of the query rows: pos and g / (den +
// 1e-9), staged in shared memory, and w f' of one score from them.
struct PairwiseDl {
  Head hd;
  const float* pos;
  const float* den;
  const float* g;
  int mask_fn;
  float* spos;  // kRows each
  float* sgs;

  __device__ __forceinline__ void stage(int row0, int R) const {
    for (int t = threadIdx.x; t < kRows; t += blockDim.x) {
      const int r = row0 + t;
      const bool in = r < R;
      spos[t] = in ? pos[r] : 0.f;
      sgs[t] = in ? g[r] / (den[r] + 1e-9f) : 0.f;
    }
  }
  __device__ __forceinline__ float operator()(float l, float nv, int row) const {
    return weighted_slope(hd, l, nv, spos[row], sgs[row], mask_fn);
  }
};

__device__ __forceinline__ PairwiseDl pairwise_dl(unsigned char* smem, int D, const Head& hd,
                                                  const float* pos, const float* den,
                                                  const float* g, int mask_fn) {
  float* s = reinterpret_cast<float*>(smem + xrt::bwd_tiles_bytes(D));
  return PairwiseDl{hd, pos, den, g, mask_fn, s, s + kRows};
}

// dq, block (row tile, split): the split's dl N into out (dq itself with
// one split, else part[split], (R, D) f32) and, per row, its sum of w f'
// (lane, quad, then the four warps of a row, in order) into
// wpart[split][r].  Up to D = 128 it is held to 3 blocks an SM (80
// registers, 32 bytes spilled): left free, ptxas takes 86 and fits 2, and
// the third block pays for the spill.
template <int kKs>
__global__ void __launch_bounds__(kThreads, kKs == 8 ? 3 : 1) pairwise_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ n, const float* __restrict__ nv,
    const float* __restrict__ den, const float* __restrict__ g, const float* __restrict__ pos_in,
    float* __restrict__ out, float* __restrict__ wpart, int R, int Rn, int D, Head hd,
    int mask_fn, int splits) {
  // dq columns of warp w: the 16-column blocks 16 w + 128 jb, jb < kJ
  constexpr int kJ = kKs > 0 ? kKs / 8 : kMaxD / 128;
  extern __shared__ __align__(16) unsigned char smem[];
  // after the functor's arrays: the warps' sums of w f' ([n-tile][row])
  float* sred = reinterpret_cast<float*>(smem + xrt::bwd_tiles_bytes(D)) + 2 * kRows;
  float acc[kJ][2][2][4], wsum[2];
  xrt::dq_tiles<kKs, kJ>(q, n, nv, R, Rn, D, 1.f,
                         pairwise_dl(smem, D, hd, pos_in, den, g, mask_fn), smem, splits, acc,
                         wsum);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, mt = warp & 1, nt = warp >> 1;
  const int r0 = blockIdx.x * kRows;
#pragma unroll
  for (int h = 0; h < 2; ++h) wsum[h] = quad_sum(wsum[h]);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) sred[nt * kRows + 16 * mt + gr + 8 * h] = wsum[h];
  }
  __syncthreads();
  if (threadIdx.x < kRows) {
    const int row = threadIdx.x;
    float s = sred[row];
    for (int w = 1; w < 4; ++w) s += sred[w * kRows + row];
    if (r0 + row < R) wpart[(size_t)blockIdx.y * R + r0 + row] = s;
  }
  xrt::store_acc<kJ>(acc, out + (splits > 1 ? (size_t)blockIdx.y * R * D : 0), r0, R, D);
}

// The dq pass's last kernel, one thread per element: the partial dl N and
// sums of w f' added in split order, dpos = -c (sum w f') where the head
// has one, dq = dl N + dpos p, dp = dpos q.  With one split part is dq
// itself: each thread reads its element before it writes it.
__global__ void pairwise_dq_sum_kernel(const float* part, const float* __restrict__ wpart,
                                       const bf16* __restrict__ q, const bf16* __restrict__ p,
                                       float* dq, float* __restrict__ dp, int R, int D, Head hd,
                                       int splits) {
  const size_t total = (size_t)R * D;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int r = (int)(i / D);
  float s = part[i], w = wpart[r];
  for (int sp = 1; sp < splits; ++sp) {
    s += part[sp * total + i];
    w += wpart[(size_t)sp * R + r];
  }
  const float dpos = hd.has_dpos() ? __fmul_rn(w, -hd.c) : 0.f;
  dq[i] = __fadd_rn(s, __fmul_rn(dpos, xrt::bf(p[i])));
  dp[i] = __fmul_rn(dpos, xrt::bf(q[i]));
}

// dn, block (pool tile, split): the split's dl^T Q over its query-row tiles
// in order into out (dn itself with one split, else part[split], (Rn, D)
// f32)
template <int kJ>
__global__ void __launch_bounds__(kThreads) pairwise_dn_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ n, const float* __restrict__ nv,
    const float* __restrict__ den, const float* __restrict__ g, const float* __restrict__ pos_in,
    float* __restrict__ out, int R, int Rn, int D, Head hd, int mask_fn, int splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  xrt::dn_block<kJ>(q, n, nv, R, Rn, D, 1.f, pairwise_dl(smem, D, hd, pos_in, den, g, mask_fn),
                    smem, out, splits);
}

size_t fwd_smem(int D) {
  return sizeof(bf16) * (size_t)(kRows + 2 * kPool) * (pad16(D) + 8) +
         sizeof(float) * (kRows + 4 * kRows * 2);
}
// the backward kernels: the shared loops' tiles, then pos and g / (den +
// 1e-9), and (dq) the warps' sums of w f'
size_t dq_smem(int D) { return xrt::bwd_tiles_bytes(D) + sizeof(float) * 6 * kRows; }
size_t dn_smem(int D) { return xrt::bwd_tiles_bytes(D) + sizeof(float) * 2 * kRows; }

// f(kernel) with the instantiation for D: the query fragments in
// registers up to D = 384 (forward, dq); dn's column blocks a warp
template <typename F>
cudaError_t with_fwd_kernel(int D, F f) {
  if (pad16(D) <= 128) return f(pairwise_fwd_kernel<8>);
  if (pad16(D) <= 384) return f(pairwise_fwd_kernel<24>);
  return f(pairwise_fwd_kernel<0>);
}
template <typename F>
cudaError_t with_dq_kernel(int D, F f) {
  if (pad16(D) <= 128) return f(pairwise_dq_kernel<8>);
  if (pad16(D) <= 384) return f(pairwise_dq_kernel<24>);
  return f(pairwise_dq_kernel<0>);
}
template <typename F>
cudaError_t with_dn_kernel(int D, F f) {
  if (pad16(D) <= 128) return f(pairwise_dn_kernel<1>);
  if (pad16(D) <= 384) return f(pairwise_dn_kernel<3>);
  return f(pairwise_dn_kernel<4>);
}

bool bad_args(int R, int Rn, int D, int head) {
  return R < 0 || Rn < 0 || D <= 0 || D > kMaxD || head < kContrastive || head > kNce;
}

}  // namespace

// the splits that pairwise_fwd (pass 0) or pairwise_dq (pass 2) takes
// over the pool, or pairwise_dn (pass 1) over the query rows, at this
// shape on the current device, or -1 on an error; the caller sizes the
// workspaces by them
extern "C" int pairwise_splits(int R, int Rn, int D, int pass) {
  if (bad_args(R, Rn, D, kContrastive) || pass < 0 || pass > 2) return -1;
  const int row_tiles = (R + kRows - 1) / kRows, pool_tiles = (Rn + kPool - 1) / kPool;
  int splits = 0;
  auto plan = [&](size_t smem, int tiles, int steps) {
    return [=, &splits](auto kernel) {
      return plan_splits(kernel, smem, kThreads, tiles, steps, &splits);
    };
  };
  const cudaError_t err =
      pass == 0   ? with_fwd_kernel(D, plan(fwd_smem(D), row_tiles, pool_tiles))
      : pass == 1 ? with_dn_kernel(D, plan(dn_smem(D), pool_tiles, row_tiles))
                  : with_dq_kernel(D, plan(dq_smem(D), row_tiles, pool_tiles));
  return err == cudaSuccess ? splits : -1;
}

// q, p: (R, D) bf16, n: (Rn, D) bf16, nv: (Rn,) f32; head 0-3 as above,
// c = 1 - margin; writes out, den and pos, (R,) f32; part: an f32
// workspace of splits * R * 2
extern "C" int pairwise_fwd(const void* q, const void* p, const void* n, const float* nv,
                            float* out, float* den, float* pos, float* part, int R, int Rn, int D,
                            int head, float margin, float c, int mask_fn, int splits,
                            void* stream) {
  if (bad_args(R, Rn, D, head) || splits < 1) return cudaErrorInvalidValue;
  if (R == 0) return cudaSuccess;
  const size_t smem = fwd_smem(D);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = with_fwd_kernel(D, [&](auto kernel) {
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3((R + kRows - 1) / kRows, splits), kThreads, smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(p), static_cast<const bf16*>(n),
        nv, part, pos, R, Rn, D, Head{head, margin, c}, mask_fn, splits);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  pairwise_combine_kernel<<<(R + 255) / 256, 256, 0, s>>>(part, out, den, R, splits);
  return cudaGetLastError();
}

// dq and dp, (R, D) f32, for the cotangent g of out; den and pos are the
// forward's; part: an f32 workspace of splits * R * (D + 1) with more
// than one split, else of R (the sums of w f')
extern "C" int pairwise_dq(const void* q, const void* p, const void* n, const float* nv,
                           const float* den, const float* g, const float* pos, float* dq,
                           float* dp, float* part, int R, int Rn, int D, int head, float margin,
                           float c, int mask_fn, int splits, void* stream) {
  if (bad_args(R, Rn, D, head) || splits < 1) return cudaErrorInvalidValue;
  if (R == 0) return cudaSuccess;
  if (part == nullptr) return cudaErrorInvalidValue;
  const size_t smem = dq_smem(D);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const bf16*>(q);
  const auto* pb = static_cast<const bf16*>(p);
  const Head hd{head, margin, c};
  const size_t total = (size_t)R * D;
  float* dl_part = splits > 1 ? part : dq;
  float* wpart = splits > 1 ? part + (size_t)splits * total : part;
  cudaError_t err = with_dq_kernel(D, [&](auto kernel) {
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3((R + kRows - 1) / kRows, splits), kThreads, smem, s>>>(
        qb, static_cast<const bf16*>(n), nv, den, g, pos, dl_part, wpart, R, Rn, D, hd, mask_fn,
        splits);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  pairwise_dq_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(dl_part, wpart, qb, pb,
                                                                         dq, dp, R, D, hd, splits);
  return cudaGetLastError();
}

// dn, (Rn, D) f32, for the cotangent g of out; den and pos are the
// forward's; part: an f32 workspace of splits * Rn * D, unused (may be
// null) with one split
extern "C" int pairwise_dn(const void* q, const void* n, const float* nv, const float* den,
                           const float* g, const float* pos, float* dn, float* part, int R, int Rn,
                           int D, int head, float margin, float c, int mask_fn, int splits,
                           void* stream) {
  if (bad_args(R, Rn, D, head) || splits < 1) return cudaErrorInvalidValue;
  if (Rn == 0) return cudaSuccess;
  if (splits > 1 && part == nullptr) return cudaErrorInvalidValue;
  const size_t smem = dn_smem(D);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = splits > 1 ? part : dn;
  cudaError_t err = with_dn_kernel(D, [&](auto kernel) {
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3((Rn + kPool - 1) / kPool, splits), kThreads, smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(n), nv, den, g, pos, o, R, Rn, D,
        Head{head, margin, c}, mask_fn, splits);
    return cudaGetLastError();
  });
  if (err != cudaSuccess || splits == 1) return err;
  const size_t total = (size_t)Rn * D;
  xrt::sum_splits_kernel<float>
      <<<(unsigned)((total + 255) / 256), 256, 0, s>>>(part, dn, total, splits);
  return cudaGetLastError();
}
