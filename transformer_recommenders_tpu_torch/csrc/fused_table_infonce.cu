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
// x < pos has to drop column pos_idx and every other catalog row with the
// same embedding, and the forward and backward must drop the same columns
// or dl is not the gradient of the forward's ce.  Every score here comes
// from xrt::score_tile (common.cuh): mma.sync m16n8k16 over the bf16
// values with the query row as the A operand, k zero-padded to a multiple
// of 16 and taken in increasing steps of 16 from a zero accumulator, then
// one unfused multiply by scale.  pos is the same chain against the
// gathered positive rows (the diagonal of a block's rows against their
// own positives; a zero row where pos_idx is out of range, so pos = 0).
// The tensor core's sum for one output depends only on that output's row,
// column and accumulator, so every copy of the positive scores exactly
// pos in all three kernels.
//
// What bounds it on the H100: 2 R N D operations forward and 6 R N D
// backward (the scores again, dl T and dl^T Q), on the tensor cores: 3.9
// and 11.8 us at the hot step's R=4096, N=3707, D=128, below the R N
// exponentials of each (~5 us at the card's measured expf rate).  The
// design is the pool InfoNCE kernels' (csrc/fused_infonce.cu):
// - forward and dq: a block takes kRows = 32 query rows and one split of
//   the catalog tiles of kCols = 32 rows (grid (R / 32, splits), the
//   splits filling the card's resident blocks); its 8 warps each score a
//   16 x 8 tile of every 32 x 32 tile of scores.  q and the catalog tiles
//   are staged in shared memory as bf16 (leading dimension D + 8), the
//   catalog double-buffered with cp.async; the query fragments stay in
//   registers up to D = 384.
// - forward: each lane keeps a count-weighted online (max, sum) of its
//   rows' counted scores, its max starting at pos; the lanes of a quad,
//   then the four warps of a row, merge in a fixed order, and each block
//   writes its split's (max, sum) to a workspace.  A second kernel merges
//   the splits in split order from (pos, 0) and writes lse and ce.
// - dq: dl goes to shared memory as bf16, then the split's dl T_tile runs
//   on the tensor cores (B fragments by ldmatrix.trans from the row-major
//   catalog tile); with more than one split the partial dq go to a
//   workspace and a last kernel sums them in split order.  Split 0's
//   blocks write each row's pos for the dT pass.
// - dT: a block takes kCols catalog rows and one split of the query-row
//   tiles, walking them in order (double-buffered with cp.async); its
//   scores are score_tile's (query rows as A), dl goes to shared memory
//   transposed, and dl^T Q_tile runs on the tensor cores; the splits are
//   summed in order as in dq.
// No atomics: every sum runs in a fixed order, so two calls give the same
// bits.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;     // 8 warps
constexpr int kRows = 32;         // query rows of a block (forward, dq) or of a step (dT)
constexpr int kCols = 32;         // catalog rows of a step (forward, dq) or of a block (dT)
constexpr int kDlLd = kCols + 8;  // dl's leading dimension in shared memory (bf16)
constexpr int kMaxD = 512;
static_assert(kRows == 2 * 16 && kCols == 4 * 8 && kThreads == 8 * 32,
              "8 warps, one 16 x 8 score tile each");

using xrt::allow_smem;
using xrt::cp_async16;
using xrt::cp_async_commit;
using xrt::cp_async_wait;
using xrt::diagonal_pos;
using xrt::QueryFrags;
using xrt::load_a;
using xrt::mma_bf16;
using xrt::merge;
using xrt::pad16;
using xrt::plan_splits;
using xrt::score_tile;
using xrt::split_tiles;
using xrt::stage_rows_async;
using xrt::zero_pad_cols;

// the pool weight of a score after the false-negative mask
__device__ __forceinline__ float weight(float x, float count, float pos, int mask_fn) {
  return (mask_fn && !(x < pos)) ? 0.f : count;
}

// dl of one score, rounded to bf16 (the JAX kernel's dl.astype(bf16))
__device__ __forceinline__ float grad_logit(float x, float count, float pos, float lse, float gs,
                                            float pprob, bool sel, int mask_fn) {
  const float w = weight(x, count, pos, mask_fn);
  const float qprob = w > 0.f ? w * expf(x - lse) : 0.f;
  return xrt::Act<bf16>::round(gs * (qprob + (sel ? pprob - 1.f : 0.f)));
}

// a running (max, sum of w exp(x - max)) takes x with weight w
__device__ __forceinline__ void online(float& m, float& s, float x, float w) {
  if (w > 0.f) {
    if (x > m) {
      s = s * expf(m - x) + w;
      m = x;
    } else {
      s += w * expf(x - m);
    }
  }
}

// the positive rows table[pos_idx[r]] of query rows [r0, r0 + nrows) into
// shared memory (leading dimension ld), a zero row where r >= R or
// pos_idx[r] is outside [0, N); cp.async where D and table allow (the
// caller commits and waits)
__device__ void stage_positives_async(const bf16* __restrict__ table, int N, int D,
                                      const int* __restrict__ pos_idx, int R, int r0, int nrows,
                                      bf16* dst, int ld) {
  auto row_of = [&](int r) {
    const int p = r0 + r < R ? pos_idx[r0 + r] : -1;
    return p >= 0 && p < N ? p : -1;
  };
  if (D % 8 == 0 && (reinterpret_cast<uintptr_t>(table) & 15) == 0) {
    const int per_row = D / 8;
    for (int i = threadIdx.x; i < nrows * per_row; i += blockDim.x) {
      const int r = i / per_row, c = (i % per_row) * 8, p = row_of(r);
      cp_async16(dst + r * ld + c, p >= 0 ? table + (size_t)p * D + c : table, p >= 0);
    }
  } else {
    for (int i = threadIdx.x; i < nrows * D; i += blockDim.x) {
      const int r = i / D, k = i % D, p = row_of(r);
      dst[r * ld + k] = p >= 0 ? table[(size_t)p * D + k] : __float2bfloat16_rn(0.f);
    }
  }
}

// Forward, block (row tile, split): the split's partial (max, sum) per row
// into part[split][r], and pos (split 0).
template <int kKs>
__global__ void __launch_bounds__(kThreads) table_infonce_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ table, const int* __restrict__ pos_idx,
    const float* __restrict__ counts, float* __restrict__ part, float* __restrict__ pos_out,
    int R, int N, int D, float scale, int mask_fn, int splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nks = pad16(D) / 16, ld = pad16(D) + 8;
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sn = sq + kRows * ld;  // two catalog buffers of kCols rows
  float* spos = reinterpret_cast<float*>(sn + 2 * kCols * ld);
  float* sred = spos + kRows;  // [n-tile][row][max, sum]
  const int r0 = blockIdx.x * kRows;
  int t0, t1;
  split_tiles(N, kCols, splits, t0, t1);
  zero_pad_cols(sq, kRows + 2 * kCols, D, ld);
  stage_rows_async(q, R, D, r0, kRows, sq, ld);
  stage_positives_async(table, N, D, pos_idx, R, r0, kRows, sn + kCols * ld, ld);  // buffer 1
  cp_async_commit();
  if (t0 < t1) stage_rows_async(table, N, D, t0 * kCols, kCols, sn, ld);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t2 = (lane & 3) * 2, mt = warp & 1, nt = warp >> 1;
  const QueryFrags<kKs> qa(sq + 16 * mt * ld, ld, nks);
  diagonal_pos<kKs>(qa, sn + kCols * ld, ld, nks, scale, spos);
  __syncthreads();

  float pos[2], m[2], s[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    pos[h] = spos[16 * mt + g + 8 * h];
    m[h] = pos[h];
    s[h] = 0.f;
  }
  float x[4];
  for (int t = t0; t < t1; ++t) {
    const bf16* cur = sn + ((t - t0) & 1) * kCols * ld;
    if (t + 1 < t1)
      stage_rows_async(table, N, D, (t + 1) * kCols, kCols, sn + ((t + 1 - t0) & 1) * kCols * ld,
                       ld);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    score_tile<kKs>(qa, cur + 8 * nt * ld, ld, nks, scale, x);
    const int j = t * kCols + 8 * nt + t2;
    const float c0 = j < N ? counts[j] : 0.f, c1 = j + 1 < N ? counts[j + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      online(m[h], s[h], x[2 * h], weight(x[2 * h], c0, pos[h], mask_fn));
      online(m[h], s[h], x[2 * h + 1], weight(x[2 * h + 1], c1, pos[h], mask_fn));
    }
    __syncthreads();
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[h], off);
      const float s2 = __shfl_xor_sync(0xffffffffu, s[h], off);
      merge(m[h], s[h], m2, s2);
    }
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* at = sred + (nt * kRows + 16 * mt + g + 8 * h) * 2;
      at[0] = m[h];
      at[1] = s[h];
    }
  }
  __syncthreads();
  if (threadIdx.x < kRows) {
    const int row = threadIdx.x, r = r0 + row;
    float mm = sred[row * 2], ss = sred[row * 2 + 1];
    for (int w = 1; w < 4; ++w)
      merge(mm, ss, sred[(w * kRows + row) * 2], sred[(w * kRows + row) * 2 + 1]);
    if (r < R) {
      float* at = part + ((size_t)blockIdx.y * R + r) * 2;
      at[0] = mm;
      at[1] = ss;
      if (blockIdx.y == 0) pos_out[r] = spos[row];
    }
  }
}

// The forward's second kernel: each row's splits merged in split order
// from (pos, 0), then lse and ce.
__global__ void table_infonce_combine_kernel(const float* __restrict__ part,
                                             const float* __restrict__ pos, float* __restrict__ ce,
                                             float* __restrict__ lse, int R, int splits) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float pr = pos[r];
  float m = pr, s = 0.f;
  for (int sp = 0; sp < splits; ++sp) {
    const float* at = part + ((size_t)sp * R + r) * 2;
    merge(m, s, at[0], at[1]);
  }
  const float l = m + logf(expf(pr - m) + s);
  lse[r] = l;
  ce[r] = l - pr;
}

// dq, block (row tile, split): the split's dl T into out (dq itself with
// one split, else part[split], (R, D) f32); split 0 writes pos.
template <int kKs>
__global__ void __launch_bounds__(kThreads) table_infonce_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ table, const int* __restrict__ pos_idx,
    const float* __restrict__ counts, const float* __restrict__ lse, const float* __restrict__ g,
    float* __restrict__ out, float* __restrict__ pos_out, int R, int N, int D, float scale,
    int mask_fn, int splits) {
  // dq columns of warp w: the 16-column blocks 16 w + 128 jb, jb < kJ
  constexpr int kJ = kKs > 0 ? kKs / 8 : kMaxD / 128;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Dp = pad16(D), nks = Dp / 16, ld = Dp + 8;
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sn = sq + kRows * ld;  // two catalog buffers of kCols rows
  bf16* sdl = sn + 2 * kCols * ld;
  float* spos = reinterpret_cast<float*>(sdl + kRows * kDlLd);
  float* slse = spos + kRows;
  float* sgs = slse + kRows;
  float* spp = sgs + kRows;
  int* spidx = reinterpret_cast<int*>(spp + kRows);
  const int r0 = blockIdx.x * kRows;
  int t0, t1;
  split_tiles(N, kCols, splits, t0, t1);
  zero_pad_cols(sq, kRows + 2 * kCols, D, ld);
  stage_rows_async(q, R, D, r0, kRows, sq, ld);
  stage_positives_async(table, N, D, pos_idx, R, r0, kRows, sn + kCols * ld, ld);
  cp_async_commit();
  if (t0 < t1) stage_rows_async(table, N, D, t0 * kCols, kCols, sn, ld);
  cp_async_commit();
  for (int t = threadIdx.x; t < kRows; t += blockDim.x) {
    const int r = r0 + t;
    slse[t] = r < R ? lse[r] : 0.f;
    sgs[t] = r < R ? g[r] * scale : 0.f;
    spidx[t] = r < R ? pos_idx[r] : -1;
  }
  cp_async_wait<1>();
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, t2 = (lane & 3) * 2, mt = warp & 1, nt = warp >> 1;
  const QueryFrags<kKs> qa(sq + 16 * mt * ld, ld, nks);
  diagonal_pos<kKs>(qa, sn + kCols * ld, ld, nks, scale, spos);
  __syncthreads();
  for (int t = threadIdx.x; t < kRows; t += blockDim.x) {
    spp[t] = expf(spos[t] - slse[t]);
    if (blockIdx.y == 0 && r0 + t < R) pos_out[r0 + t] = spos[t];
  }
  float acc[kJ][2][2][4];  // [column block][m-tile][n8 half][fragment]
#pragma unroll
  for (int jb = 0; jb < kJ; ++jb)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[jb][i / 8][(i / 4) % 2][i % 4] = 0.f;

  for (int t = t0; t < t1; ++t) {
    const bf16* cur = sn + ((t - t0) & 1) * kCols * ld;
    if (t + 1 < t1)
      stage_rows_async(table, N, D, (t + 1) * kCols, kCols, sn + ((t + 1 - t0) & 1) * kCols * ld,
                       ld);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // also: spp written
    float x[4];
    score_tile<kKs>(qa, cur + 8 * nt * ld, ld, nks, scale, x);
    const int j = t * kCols + 8 * nt + t2;
    const float c0 = j < N ? counts[j] : 0.f, c1 = j + 1 < N ? counts[j + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * mt + gr + 8 * h;
      const bool live = r0 + row < R;
      const float d0 = live && j < N ? grad_logit(x[2 * h], c0, spos[row], slse[row], sgs[row],
                                                  spp[row], j == spidx[row], mask_fn)
                                     : 0.f;
      const float d1 = live && j + 1 < N
                           ? grad_logit(x[2 * h + 1], c1, spos[row], slse[row], sgs[row], spp[row],
                                        j + 1 == spidx[row], mask_fn)
                           : 0.f;
      *reinterpret_cast<uint32_t*>(sdl + row * kDlLd + 8 * nt + t2) =
          xrt::pack_bf16(__float2bfloat16_rn(d0), __float2bfloat16_rn(d1));
    }
    __syncthreads();
    // dq += dl (32 x 32) T_tile (32 x Dp), k the tile's catalog rows in order
#pragma unroll
    for (int kk = 0; kk < kCols / 16; ++kk) {
      uint32_t a0[4], a1[4];
      load_a(sdl, kDlLd, 16 * kk, a0);
      load_a(sdl + 16 * kDlLd, kDlLd, 16 * kk, a1);
#pragma unroll
      for (int jb = 0; jb < kJ; ++jb) {
        const int c = 16 * warp + 128 * jb;
        if (c < Dp) {
          uint32_t b[4];
          xrt::ldmatrix_x4_trans(b, cur + 16 * kk * ld + c, ld);
          mma_bf16(acc[jb][0][0], a0, b);
          mma_bf16(acc[jb][0][1], a0, b + 2);
          mma_bf16(acc[jb][1][0], a1, b);
          mma_bf16(acc[jb][1][1], a1, b + 2);
        }
      }
    }
    __syncthreads();  // every warp done with cur before the next step restages it
  }
  cp_async_wait<0>();
  float* o = out + (splits > 1 ? (size_t)blockIdx.y * R * D : 0);
#pragma unroll
  for (int jb = 0; jb < kJ; ++jb)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 16 * mi + gr + 8 * h, col = 16 * warp + 128 * jb + 8 * half + t2;
          if (r < R) {
            if (col < D) o[(size_t)r * D + col] = acc[jb][mi][half][2 * h];
            if (col + 1 < D) o[(size_t)r * D + col + 1] = acc[jb][mi][half][2 * h + 1];
          }
        }
}

// dT, block (catalog tile, split): the split's dl^T Q over its query-row
// tiles in order into out (dtable itself with one split, else
// part[split], (N, D) f32)
template <int kJ>
__global__ void __launch_bounds__(kThreads) table_infonce_dt_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ table, const int* __restrict__ pos_idx,
    const float* __restrict__ counts, const float* __restrict__ lse, const float* __restrict__ g,
    const float* __restrict__ pos_in, float* __restrict__ out, int R, int N, int D, float scale,
    int mask_fn, int splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Dp = pad16(D), nks = Dp / 16, ld = Dp + 8;
  bf16* sn = reinterpret_cast<bf16*>(smem);  // the block's kCols catalog rows
  bf16* sq = sn + kCols * ld;                // two query buffers of kRows rows
  bf16* sdl = sq + 2 * kRows * ld;           // dl transposed: sdl[n * kDlLd + r]
  float* scnt = reinterpret_cast<float*>(sdl + kCols * kDlLd);
  float* spos = scnt + kCols;
  float* slse = spos + kRows;
  float* sgs = slse + kRows;
  float* spp = sgs + kRows;
  int* spidx = reinterpret_cast<int*>(spp + kRows);
  const int n0 = blockIdx.x * kCols;
  int t0, t1;
  split_tiles(R, kRows, splits, t0, t1);
  zero_pad_cols(sn, kCols + 2 * kRows, D, ld);
  stage_rows_async(table, N, D, n0, kCols, sn, ld);
  if (t0 < t1) stage_rows_async(q, R, D, t0 * kRows, kRows, sq, ld);
  cp_async_commit();
  for (int i = threadIdx.x; i < kCols; i += blockDim.x) scnt[i] = n0 + i < N ? counts[n0 + i] : 0.f;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, t2 = (lane & 3) * 2, mt = warp & 1, nt = warp >> 1;
  float acc[kJ][2][2][4];  // [column block][m-tile][n8 half][fragment]
#pragma unroll
  for (int jb = 0; jb < kJ; ++jb)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[jb][i / 8][(i / 4) % 2][i % 4] = 0.f;

  for (int t = t0; t < t1; ++t) {
    const bf16* cur = sq + ((t - t0) & 1) * kRows * ld;
    if (t + 1 < t1)
      stage_rows_async(q, R, D, (t + 1) * kRows, kRows, sq + ((t + 1 - t0) & 1) * kRows * ld, ld);
    cp_async_commit();
    for (int i = threadIdx.x; i < kRows; i += blockDim.x) {
      const int r = t * kRows + i;
      const bool in = r < R;
      spos[i] = in ? pos_in[r] : 0.f;
      slse[i] = in ? lse[r] : 0.f;
      sgs[i] = in ? g[r] * scale : 0.f;
      spp[i] = expf(spos[i] - slse[i]);
      spidx[i] = in ? pos_idx[r] : -1;
    }
    cp_async_wait<1>();
    __syncthreads();
    // scores: the query rows 16 mt (+ 16) as A against catalog rows 8 nt
    const bf16* qw = cur + 16 * mt * ld;
    float x[4];
    score_tile<0>([=](int ks, uint32_t a[4]) { load_a(qw, ld, 16 * ks, a); }, sn + 8 * nt * ld,
                  ld, nks, scale, x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = 16 * mt + gr + 8 * (i >> 1), jn = 8 * nt + t2 + (i & 1);
      const bool live = n0 + jn < N && t * kRows + row < R;
      const float d = live ? grad_logit(x[i], scnt[jn], spos[row], slse[row], sgs[row], spp[row],
                                        n0 + jn == spidx[row], mask_fn)
                           : 0.f;
      sdl[jn * kDlLd + row] = __float2bfloat16_rn(d);
    }
    __syncthreads();
    // dT += dl^T (32 x 32) Q_tile (32 x Dp), k the tile's query rows in order
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      uint32_t a0[4], a1[4];
      load_a(sdl, kDlLd, 16 * kk, a0);
      load_a(sdl + 16 * kDlLd, kDlLd, 16 * kk, a1);
#pragma unroll
      for (int jb = 0; jb < kJ; ++jb) {
        const int c = 16 * warp + 128 * jb;
        if (c < Dp) {
          uint32_t b[4];
          xrt::ldmatrix_x4_trans(b, cur + 16 * kk * ld + c, ld);
          mma_bf16(acc[jb][0][0], a0, b);
          mma_bf16(acc[jb][0][1], a0, b + 2);
          mma_bf16(acc[jb][1][0], a1, b);
          mma_bf16(acc[jb][1][1], a1, b + 2);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();  // no query tile: the catalog rows' copy is still in flight
  float* o = out + (splits > 1 ? (size_t)blockIdx.y * N * D : 0);
#pragma unroll
  for (int jb = 0; jb < kJ; ++jb)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = n0 + 16 * mi + gr + 8 * h, col = 16 * warp + 128 * jb + 8 * half + t2;
          if (n < N) {
            if (col < D) o[(size_t)n * D + col] = acc[jb][mi][half][2 * h];
            if (col + 1 < D) o[(size_t)n * D + col + 1] = acc[jb][mi][half][2 * h + 1];
          }
        }
}

size_t fwd_smem(int D) {
  return sizeof(bf16) * (size_t)(kRows + 2 * kCols) * (pad16(D) + 8) +
         sizeof(float) * (kRows + 4 * kRows * 2);
}
size_t dq_smem(int D) {
  return sizeof(bf16) * ((size_t)(kRows + 2 * kCols) * (pad16(D) + 8) + kRows * kDlLd) +
         sizeof(float) * 5 * kRows;
}
size_t dt_smem(int D) {
  return sizeof(bf16) * ((size_t)(kCols + 2 * kRows) * (pad16(D) + 8) + kCols * kDlLd) +
         sizeof(float) * (kCols + 5 * kRows);
}

// f(kernel) with the instantiation for D: the query fragments in
// registers up to D = 384 (forward, dq); dT's column blocks a warp
template <typename F>
cudaError_t with_fwd_kernel(int D, F f) {
  if (pad16(D) <= 128) return f(table_infonce_fwd_kernel<8>);
  if (pad16(D) <= 384) return f(table_infonce_fwd_kernel<24>);
  return f(table_infonce_fwd_kernel<0>);
}
template <typename F>
cudaError_t with_dq_kernel(int D, F f) {
  if (pad16(D) <= 128) return f(table_infonce_dq_kernel<8>);
  if (pad16(D) <= 384) return f(table_infonce_dq_kernel<24>);
  return f(table_infonce_dq_kernel<0>);
}
template <typename F>
cudaError_t with_dt_kernel(int D, F f) {
  if (pad16(D) <= 128) return f(table_infonce_dt_kernel<1>);
  if (pad16(D) <= 384) return f(table_infonce_dt_kernel<3>);
  return f(table_infonce_dt_kernel<4>);
}

bool bad_shape(int R, int N, int D) { return R < 0 || N <= 0 || D <= 0 || D > kMaxD; }

}  // namespace

// the splits that table_infonce_fwd (pass 0) takes over the catalog, the
// backward's dq pass (1) over the catalog or its dT pass (2) over the
// query rows, at this shape on the current device, or -1 on an error; the
// caller sizes the workspaces by them
extern "C" int table_infonce_splits(int R, int N, int D, int pass) {
  if (bad_shape(R, N, D) || pass < 0 || pass > 2) return -1;
  const int row_tiles = (R + kRows - 1) / kRows, col_tiles = (N + kCols - 1) / kCols;
  int splits = 0;
  auto plan = [&](size_t smem, int tiles, int steps) {
    return [=, &splits](auto kernel) {
      return plan_splits(kernel, smem, kThreads, tiles, steps, &splits);
    };
  };
  const cudaError_t err =
      pass == 0   ? with_fwd_kernel(D, plan(fwd_smem(D), row_tiles, col_tiles))
      : pass == 1 ? with_dq_kernel(D, plan(dq_smem(D), row_tiles, col_tiles))
                  : with_dt_kernel(D, plan(dt_smem(D), col_tiles, row_tiles));
  return err == cudaSuccess ? splits : -1;
}

// q: (R, D) bf16, table: (N, D) bf16, pos_idx: (R,) int32, counts: (N,)
// f32; writes ce, lse and pos, (R,) f32; part: an f32 workspace of
// splits * R * 2
extern "C" int table_infonce_fwd(const void* q, const void* table, const int* pos_idx,
                                 const float* counts, float* ce, float* lse, float* pos,
                                 float* part, int R, int N, int D, float scale, int mask_fn,
                                 int splits, void* stream) {
  if (bad_shape(R, N, D) || splits < 1) return cudaErrorInvalidValue;
  if (R == 0) return cudaSuccess;
  const size_t smem = fwd_smem(D);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = with_fwd_kernel(D, [&](auto kernel) {
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3((R + kRows - 1) / kRows, splits), kThreads, smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(table), pos_idx, counts, part, pos,
        R, N, D, scale, mask_fn, splits);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  table_infonce_combine_kernel<<<(R + 255) / 256, 256, 0, s>>>(part, pos, ce, lse, R, splits);
  return cudaGetLastError();
}

// the backward of table_infonce_fwd for the cotangent g of ce: dq (R, D)
// and dtable (N, D), f32; pos_ws an (R,) f32 workspace; part_dq (splits_dq
// * R * D) and part_dt (splits_dt * N * D) f32 workspaces, unused (may be
// null) with one split
extern "C" int table_infonce_bwd(const void* q, const void* table, const int* pos_idx,
                                 const float* counts, const float* lse, const float* g, float* dq,
                                 float* dtable, float* pos_ws, float* part_dq, float* part_dt,
                                 int R, int N, int D, float scale, int mask_fn, int splits_dq,
                                 int splits_dt, void* stream) {
  if (bad_shape(R, N, D) || splits_dq < 1 || splits_dt < 1) return cudaErrorInvalidValue;
  if ((R > 0 && splits_dq > 1 && part_dq == nullptr) || (splits_dt > 1 && part_dt == nullptr))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const bf16*>(q);
  const auto* tb = static_cast<const bf16*>(table);
  cudaError_t err;
  if (R > 0) {
    const size_t smem = dq_smem(D);
    float* out = splits_dq > 1 ? part_dq : dq;
    err = with_dq_kernel(D, [&](auto kernel) {
      cudaError_t e = allow_smem(kernel, smem);
      if (e != cudaSuccess) return e;
      kernel<<<dim3((R + kRows - 1) / kRows, splits_dq), kThreads, smem, s>>>(
          qb, tb, pos_idx, counts, lse, g, out, pos_ws, R, N, D, scale, mask_fn, splits_dq);
      return cudaGetLastError();
    });
    if (err != cudaSuccess) return err;
    if (splits_dq > 1) {
      const size_t total = (size_t)R * D;
      xrt::sum_splits_kernel<float>
          <<<(unsigned)((total + 255) / 256), 256, 0, s>>>(part_dq, dq, total, splits_dq);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
  }
  const size_t smem = dt_smem(D);
  float* out = splits_dt > 1 ? part_dt : dtable;
  err = with_dt_kernel(D, [&](auto kernel) {
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3((N + kCols - 1) / kCols, splits_dt), kThreads, smem, s>>>(
        qb, tb, pos_idx, counts, lse, g, pos_ws, out, R, N, D, scale, mask_fn, splits_dt);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  if (splits_dt > 1) {
    const size_t total = (size_t)N * D;
    xrt::sum_splits_kernel<float>
        <<<(unsigned)((total + 255) / 256), 256, 0, s>>>(part_dt, dtable, total, splits_dt);
  }
  return cudaGetLastError();
}
