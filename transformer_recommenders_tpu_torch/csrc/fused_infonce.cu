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
// pos and every pool score come from one device function, xrt::score_tile
// (common.cuh): mma.sync m16n8k16 over the same bf16 values with the query
// row as the A operand, k zero-padded to a multiple of 16 and taken in
// increasing steps of 16 from a zero accumulator, then one unfused
// multiply by scale.  A pool row that is a copy of a row's positive
// therefore scores exactly that row's pos in all three kernels, and the
// mask x < pos drops it in each.  The forward writes each row's pos; both
// backward kernels read it back.
//
// What bounds it on the H100: 2 R Rn D operations forward and 4 R Rn D for
// each backward kernel on the tensor cores (0.8 and 1.6 us at path B's
// R = Rn = 1024, D = 384; 4.3 and 8.7 us at path A's R = Rn = 4096,
// D = 128), and R Rn exponentials (0.3 us at B, 5 us at A at the card's
// measured expf rate).  At these sizes the launches, the staging of the
// tiles and the split sums set the time more than the products do.
// The design:
// - forward and dq/dp: a block takes kRows = 32 query rows and one split
//   of the pool tiles (grid (R / 32, splits); the splits fill the card's
//   resident blocks, at least two pool tiles each).  Its 8 warps each
//   score a 16 x 8 tile of every 32 x 32 tile of scores.  q and the pool
//   tiles are staged in shared memory as bf16 (leading dimension D + 8:
//   conflict-free fragment loads), the pool tiles double-buffered with
//   cp.async so that the next one loads while the current one multiplies;
//   the query fragments stay in registers up to D = 384.
// - forward: each lane keeps an online (max, sum) of its rows' counted
//   scores, its max starting at pos; the lanes of a quad, then the four
//   warps of a row, merge in a fixed order, and each block writes its
//   split's (max, sum) to a workspace.  A second kernel merges the splits
//   in split order from (pos, 0) and writes lse and ce (a row with no
//   counted negative gets ce = 0 exactly); split 0's blocks write pos.
// - dq/dp (xrt::dq_tiles): dl = bf16(exp(x - lse) g scale) goes to shared
//   memory as bf16, then the split's dq += dl N_tile runs on the tensor
//   cores (B fragments by ldmatrix.trans from the row-major pool tile)
//   into an f32 workspace (dq itself with one split); a final kernel sums
//   the splits in order, adds dpos p and writes dq and dp.
// - dn (xrt::dn_block, the pairwise dn kernel's loop): a block takes
//   kPool = 32 pool rows and one split of the query-row tiles of 32,
//   walking them in order, double-buffered with cp.async (grid (Rn / 32,
//   splits)); its scores are score_tile's with the query rows as A, dl
//   goes to shared memory transposed as bf16 (it is bf16 already), and
//   dn += dl^T Q_tile runs on the tensor cores (B fragments by
//   ldmatrix.trans from the row-major query tile); with more than one
//   split the partial dn go to a workspace and a last kernel sums them in
//   split order.
// No atomics: every sum runs in a fixed order, so two calls give the same
// bits.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = xrt::kBwdThreads;  // 8 warps
constexpr int kRows = xrt::kBwdTile;  // query rows of a block (forward, dq) or of a step (dn)
constexpr int kPool = xrt::kBwdTile;  // pool rows of a step (forward, dq) or of a block (dn)
constexpr int kMaxD = 512;
static_assert(kRows <= kPool, "the positives are staged in a pool buffer");
static_assert(kRows == 2 * 16 && kPool == 4 * 8 && kThreads == 8 * 32,
              "8 warps, one 16 x 8 score tile each");

using xrt::allow_smem;
using xrt::bf;
using xrt::cp_async_commit;
using xrt::cp_async_wait;
using xrt::diagonal_pos;
using xrt::QueryFrags;
using xrt::merge;
using xrt::pad16;
using xrt::plan_splits;
using xrt::score_tile;
using xrt::split_tiles;
using xrt::stage_rows_async;
using xrt::zero_pad_cols;

// whether a pool score counts as a negative of its row
__device__ __forceinline__ bool counted(float x, float nv, float pos, int mask_fn) {
  return nv > 0.f && (!mask_fn || x < pos);
}

// dl of one pool score, rounded to bf16 (the JAX kernels' dl.astype(bf16))
__device__ __forceinline__ float grad_logit(float x, float nv, float pos, float lse, float gs,
                                            int mask_fn) {
  return counted(x, nv, pos, mask_fn) ? xrt::Act<bf16>::round(expf(x - lse) * gs) : 0.f;
}

// a running (max, sum of exp(x - max)) takes the counted ones of xa, xb
__device__ __forceinline__ void online(float& m, float& s, float xa, bool ca, float xb, bool cb) {
  const float neg_inf = -__int_as_float(0x7f800000);
  const float mx = fmaxf(ca ? xa : neg_inf, cb ? xb : neg_inf);
  if (mx > m) {
    s *= expf(m - mx);
    m = mx;
  }
  if (ca) s += expf(xa - m);
  if (cb) s += expf(xb - m);
}

// Forward, block (row tile, split): the split's partial (max, sum) per row
// into part[split][r], and pos (split 0).
template <int kKs>
__global__ void __launch_bounds__(kThreads) pool_infonce_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ p, const bf16* __restrict__ n,
    const float* __restrict__ nv, float* __restrict__ part, float* __restrict__ pos_out, int R,
    int Rn, int D, float scale, int mask_fn, int splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nks = pad16(D) / 16, ld = pad16(D) + 8;
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sn = sq + kRows * ld;  // two pool buffers of kPool rows
  float* spos = reinterpret_cast<float*>(sn + 2 * kPool * ld);
  float* sred = spos + kRows;  // [n-tile][row][max, sum]
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
  diagonal_pos<kKs>(qa, sn + kPool * ld, ld, nks, scale, spos);
  __syncthreads();

  float pos[2], m[2], s[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    pos[h] = spos[16 * mt + g + 8 * h];
    m[h] = pos[h];
    s[h] = 0.f;
  }
  for (int t = t0; t < t1; ++t) {
    const bf16* cur = sn + ((t - t0) & 1) * kPool * ld;
    if (t + 1 < t1)
      stage_rows_async(n, Rn, D, (t + 1) * kPool, kPool, sn + ((t + 1 - t0) & 1) * kPool * ld, ld);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float x[4];
    score_tile<kKs>(qa, cur + 8 * nt * ld, ld, nks, scale, x);
    const int j = t * kPool + 8 * nt + t2;
    const float v0 = j < Rn ? nv[j] : 0.f, v1 = j + 1 < Rn ? nv[j + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      online(m[h], s[h], x[2 * h], counted(x[2 * h], v0, pos[h], mask_fn), x[2 * h + 1],
             counted(x[2 * h + 1], v1, pos[h], mask_fn));
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
    for (int w = 1; w < 4; ++w) merge(mm, ss, sred[(w * kRows + row) * 2], sred[(w * kRows + row) * 2 + 1]);
    if (r < R) {
      float* at = part + ((size_t)blockIdx.y * R + r) * 2;
      at[0] = mm;
      at[1] = ss;
      if (blockIdx.y == 0) pos_out[r] = spos[row];
    }
  }
}

// The forward's second kernel: each row's splits merged in split order
// from (pos, 0); a row with no counted negative keeps m = pos, s = 0, so
// lse = pos and ce = 0 exactly.
__global__ void pool_infonce_combine_kernel(const float* __restrict__ part,
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

// What the backward kernels need of the query rows: pos, lse and g scale,
// staged in shared memory, and dl of one score from them.
struct InfonceDl {
  const float* pos;
  const float* lse;
  const float* g;
  float scale;
  int mask_fn;
  float* spos;  // kRows each
  float* slse;
  float* sgs;

  __device__ __forceinline__ void stage(int row0, int R) const {
    for (int t = threadIdx.x; t < kRows; t += blockDim.x) {
      const int r = row0 + t;
      const bool in = r < R;
      spos[t] = in ? pos[r] : 0.f;
      slse[t] = in ? lse[r] : 0.f;
      sgs[t] = in ? g[r] * scale : 0.f;
    }
  }
  __device__ __forceinline__ float operator()(float x, float nv, int row) const {
    return grad_logit(x, nv, spos[row], slse[row], sgs[row], mask_fn);
  }
};

__device__ __forceinline__ InfonceDl infonce_dl(unsigned char* smem, int D, const float* pos,
                                                const float* lse, const float* g, float scale,
                                                int mask_fn) {
  float* s = reinterpret_cast<float*>(smem + xrt::bwd_tiles_bytes(D));
  return InfonceDl{pos, lse, g, scale, mask_fn, s, s + kRows, s + 2 * kRows};
}

// dq, block (row tile, split): the split's dl N into out (dq itself with
// one split, else part[split], (R, D) f32).
template <int kKs>
__global__ void __launch_bounds__(kThreads) pool_infonce_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ n, const float* __restrict__ nv,
    const float* __restrict__ lse, const float* __restrict__ g, const float* __restrict__ pos_in,
    float* __restrict__ out, int R, int Rn, int D, float scale, int mask_fn, int splits) {
  // dq columns of warp w: the 16-column blocks 16 w + 128 jb, jb < kJ
  constexpr int kJ = kKs > 0 ? kKs / 8 : kMaxD / 128;
  extern __shared__ __align__(16) unsigned char smem[];
  float acc[kJ][2][2][4], rowsum[2];
  xrt::dq_tiles<kKs, kJ>(q, n, nv, R, Rn, D, scale,
                         infonce_dl(smem, D, pos_in, lse, g, scale, mask_fn), smem, splits, acc,
                         rowsum);
  xrt::store_acc<kJ>(acc, out + (splits > 1 ? (size_t)blockIdx.y * R * D : 0),
                     blockIdx.x * kRows, R, D);
}

// The dq pass's second kernel: dq = (the splits' dl N, summed in split
// order) + dpos p and dp = dpos q, one thread per element.  With one split
// part is dq itself: each thread reads its element before it writes it.
__global__ void pool_infonce_dq_sum_kernel(const float* part, const bf16* __restrict__ q,
                                           const bf16* __restrict__ p,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ g,
                                           const float* __restrict__ pos, float* dq,
                                           float* __restrict__ dp, int R, int D, float scale,
                                           int splits) {
  const size_t total = (size_t)R * D;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int r = (int)(i / D);
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += part[sp * total + i];
  const float gs = g[r] * scale;
  const float dpos = gs * (expf(pos[r] - lse[r]) - 1.f);
  dq[i] = __fadd_rn(s, __fmul_rn(dpos, bf(p[i])));
  dp[i] = __fmul_rn(dpos, bf(q[i]));
}

// dn, block (pool tile, split): the split's dl^T Q over its query-row
// tiles in order into out (dn itself with one split, else part[split],
// (Rn, D) f32).
template <int kJ>
__global__ void __launch_bounds__(kThreads) pool_infonce_dn_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ n, const float* __restrict__ nv,
    const float* __restrict__ lse, const float* __restrict__ g, const float* __restrict__ pos_in,
    float* __restrict__ out, int R, int Rn, int D, float scale, int mask_fn, int splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  xrt::dn_block<kJ>(q, n, nv, R, Rn, D, scale,
                    infonce_dl(smem, D, pos_in, lse, g, scale, mask_fn), smem, out, splits);
}

size_t fwd_smem(int D) {
  return sizeof(bf16) * (size_t)(kRows + 2 * kPool) * (pad16(D) + 8) +
         sizeof(float) * (kRows + 4 * kRows * 2);
}
// the backward kernels: the shared loops' tiles, then pos, lse and g scale
size_t bwd_smem(int D) { return xrt::bwd_tiles_bytes(D) + sizeof(float) * 3 * kRows; }

// f(kernel) with the instantiation for D: the query fragments in
// registers up to D = 384 (forward, dq); dn's column blocks a warp
template <typename F>
cudaError_t with_fwd_kernel(int D, F f) {
  if (pad16(D) <= 128) return f(pool_infonce_fwd_kernel<8>);
  if (pad16(D) <= 384) return f(pool_infonce_fwd_kernel<24>);
  return f(pool_infonce_fwd_kernel<0>);
}
template <typename F>
cudaError_t with_dq_kernel(int D, F f) {
  if (pad16(D) <= 128) return f(pool_infonce_dq_kernel<8>);
  if (pad16(D) <= 384) return f(pool_infonce_dq_kernel<24>);
  return f(pool_infonce_dq_kernel<0>);
}
template <typename F>
cudaError_t with_dn_kernel(int D, F f) {
  if (pad16(D) <= 128) return f(pool_infonce_dn_kernel<1>);
  if (pad16(D) <= 384) return f(pool_infonce_dn_kernel<3>);
  return f(pool_infonce_dn_kernel<4>);
}

bool bad_shape(int Rn, int D) { return Rn < 0 || D <= 0 || D > kMaxD; }

}  // namespace

// the splits that pool_infonce_fwd (pass 0) or pool_infonce_dq (pass 1)
// takes over the pool, or pool_infonce_dn (pass 2) over the query rows, at
// this shape on the current device, or -1 on an error; the caller sizes
// the workspaces by them
extern "C" int pool_infonce_splits(int R, int Rn, int D, int pass) {
  if (bad_shape(Rn, D) || R < 0 || pass < 0 || pass > 2) return -1;
  const int row_tiles = (R + kRows - 1) / kRows, pool_tiles = (Rn + kPool - 1) / kPool;
  int splits = 0;
  auto plan = [&](size_t smem, int tiles, int steps) {
    return [=, &splits](auto kernel) {
      return plan_splits(kernel, smem, kThreads, tiles, steps, &splits);
    };
  };
  const cudaError_t err =
      pass == 0   ? with_fwd_kernel(D, plan(fwd_smem(D), row_tiles, pool_tiles))
      : pass == 1 ? with_dq_kernel(D, plan(bwd_smem(D), row_tiles, pool_tiles))
                  : with_dn_kernel(D, plan(bwd_smem(D), pool_tiles, row_tiles));
  return err == cudaSuccess ? splits : -1;
}

// q, p: (R, D) bf16, n: (Rn, D) bf16, nv: (Rn,) f32; writes ce, lse and
// pos, (R,) f32; part: an f32 workspace of splits * R * 2
extern "C" int pool_infonce_fwd(const void* q, const void* p, const void* n, const float* nv,
                                float* ce, float* lse, float* pos, float* part, int R, int Rn,
                                int D, float scale, int mask_fn, int splits, void* stream) {
  if (bad_shape(Rn, D) || splits < 1) return cudaErrorInvalidValue;
  if (R <= 0) return cudaSuccess;
  const size_t smem = fwd_smem(D);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = with_fwd_kernel(D, [&](auto kernel) {
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3((R + kRows - 1) / kRows, splits), kThreads, smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(p), static_cast<const bf16*>(n),
        nv, part, pos, R, Rn, D, scale, mask_fn, splits);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  pool_infonce_combine_kernel<<<(R + 255) / 256, 256, 0, s>>>(part, pos, ce, lse, R, splits);
  return cudaGetLastError();
}

// dq and dp, (R, D) f32, for the cotangent g of ce; lse and pos are the
// forward's; part: an f32 workspace of splits * R * D, unused (may be
// null) with one split
extern "C" int pool_infonce_dq(const void* q, const void* p, const void* n, const float* nv,
                               const float* lse, const float* g, const float* pos, float* dq,
                               float* dp, float* part, int R, int Rn, int D, float scale,
                               int mask_fn, int splits, void* stream) {
  if (bad_shape(Rn, D) || splits < 1) return cudaErrorInvalidValue;
  if (R <= 0) return cudaSuccess;
  if (splits > 1 && part == nullptr) return cudaErrorInvalidValue;
  const size_t smem = bwd_smem(D);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* qb = static_cast<const bf16*>(q);
  float* out = splits > 1 ? part : dq;
  cudaError_t err = with_dq_kernel(D, [&](auto kernel) {
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3((R + kRows - 1) / kRows, splits), kThreads, smem, s>>>(
        qb, static_cast<const bf16*>(n), nv, lse, g, pos, out, R, Rn, D, scale, mask_fn, splits);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)R * D;
  pool_infonce_dq_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      out, qb, static_cast<const bf16*>(p), lse, g, pos, dq, dp, R, D, scale, splits);
  return cudaGetLastError();
}

// dn, (Rn, D) f32, for the cotangent g of ce; part: an f32 workspace of
// splits * Rn * D, unused (may be null) with one split
extern "C" int pool_infonce_dn(const void* q, const void* n, const float* nv, const float* lse,
                               const float* g, const float* pos, float* dn, float* part, int R,
                               int Rn, int D, float scale, int mask_fn, int splits,
                               void* stream) {
  if (bad_shape(Rn, D) || R < 0 || splits < 1) return cudaErrorInvalidValue;
  if (Rn == 0) return cudaSuccess;
  if (splits > 1 && part == nullptr) return cudaErrorInvalidValue;
  const size_t smem = bwd_smem(D);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = splits > 1 ? part : dn;
  cudaError_t err = with_dn_kernel(D, [&](auto kernel) {
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3((Rn + kPool - 1) / kPool, splits), kThreads, smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(n), nv, lse, g, pos, out, R, Rn, D,
        scale, mask_fn, splits);
    return cudaGetLastError();
  });
  if (err != cudaSuccess || splits == 1) return err;
  const size_t total = (size_t)Rn * D;
  xrt::sum_splits_kernel<float>
      <<<(unsigned)((total + 255) / 256), 256, 0, s>>>(part, dn, total, splits);
  return cudaGetLastError();
}
