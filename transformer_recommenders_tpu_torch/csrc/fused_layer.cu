// One whole post-LN transformer encoder layer: the forward, one block per
// sequence, and the backward (below).
//
// Replaces the TPU Pallas kernel ops/fused_layer.py:_fwd_kernel of the JAX
// package (transformer_recommenders_tpu), which runs the layer for a block
// of sequences with every intermediate in VMEM:
//   qkv dense -> per-head masked softmax(q k^T / sqrt(dh)) -> hash dropout
//   -> P V -> out dense -> dropout -> LN1(x + .) -> erf-GELU FFN -> dropout
//   -> LN2(x1 + .)
//
// What bounds it on the H100: at the serving shapes (S=32, D=128, F=512,
// a few dozen sequences) the layer needs ~13 MFLOP and ~16 KB of
// activations per sequence against 0.79 MB of f32 weights shared by all
// sequences, so the work is tiny against both the tensor-core rate and
// HBM; what matters is that no intermediate goes to device memory and that
// the layer is one launch.  This first version keeps every intermediate in
// shared memory (one block = one sequence, 256 threads) and does the
// matmuls as f32 FMAs on CUDA cores over bf16-rounded operands, which is
// far from the tensor-core bound: moving the five products onto mma/wgmma
// tiles is the next step for speed.  Weights are read from global memory
// (L2-resident across blocks) and rounded to the compute type on load.
//
// Numerics follow the JAX kernel: T-rounded (bf16 or f32) activations,
// f32 accumulation plus an f32 bias then rounding to T after each dense,
// residual adds rounded to T before a two-pass f32 LayerNorm, probs
// divided then rounded to T before P V, the additive -1e9 key-padding and
// causal bias, the Eigen erf polynomial in the GELU, and the fmix32
// dropout over the global element index.  There is no TPU layout here: no
// head-masked wide tiles and no FFN padding to 128.
//
// Shared memory (elements of T unless noted), Sp = S rounded up to kRows:
//   sx   Sp x D          layer input, then x1 = LN1(...)
//   reg  Sp x max(3D, F+D)
//        qkv (ld 3D); ctx overwrites q head by head; a = ctx Wout goes
//        into the dead k columns; then the FFN hidden g (ld F) and
//        f = g Wffn_out (ld D) after it
//   sc   hg x S x S f32  scores/probs of a stage of hg heads
//   mask S int
// At S=32, D=128, F=512 that is 58 KB in bf16; at D=384 (H=12, F=48) the
// scores are staged a few heads at a time so f32 activations fit too.
//
// The backward (fused_layer_bwd) replaces ops/fused_layer.py:_bwd_kernel:
// it recomputes the layer from its input x and returns dx plus the 12 f32
// parameter gradients summed over the batch.  The TPU kernel carries the
// parameter-gradient sums in VMEM across its sequential grid; blocks on the
// card run in parallel, so the backward is three passes, all deterministic
// (no atomics):
//   1. one block per sequence recomputes the layer (with the JAX
//      backward's own numerics: the A&S erf in the GELU under bf16, the
//      f32 dropout divisor in the VJP) and walks the VJP down to dx.  The
//      intermediates live in a workspace in device memory (a block's share
//      is a few hundred KB at the flagship shape, L2-resident), so any
//      D and F fit; shared memory holds one head's probs and d_scores.  The
//      rounded operands of the weight-gradient products go to the
//      workspace, the bias and LayerNorm gradients are summed over the
//      sequence's rows into one row of a partials buffer;
//   2. dW = X^T dY for the four weights, one block per 64 x 64 tile of dW
//      walking all B*S rows in order;
//   3. the partials summed over the sequences in order.
// What bounds it: ~3x the forward's products (recompute, then two
// products per dense), ~5 GFLOP per layer at B=128, S=32, D=128, F=512,
// so tensor-core time (5 us); this first version runs CUDA-core FMAs, as
// the forward does, and pays device-memory round trips through the
// workspace (~60 MB at that shape).
//
// Section profile.  The forward and pass 1 of the backward take a
// compile-time kStop: the kernel stops after that stage and stores the
// stage's (S, D) tensor in the input's type into its output, so the
// differences of the cumulative variants' times attribute the layer's time
// to its sections.  They replace the TPU kernels
// scripts/profile_fused_sections.py:_stage_fwd_kernel and _stage_bwd_kernel
// of the JAX package, and store the same tensors:
//   forward   qkv       the first D columns of qkv (q)
//             attn      ctx
//             out_ln1   x1 = LN1(x + dropout(ctx Wout + b))
//             ffn_gelu  the first D columns of gelu(x1 Win + b) (F >= D)
//             full      y: the layer (fused_layer_fwd)
//   backward  recompute the recomputed y (A&S erf under bf16)
//             ffn_bwd   T(dctx), the VJP through LN2, the FFN and LN1
//             attn_bwd  dx, through the attention VJP and the qkv product
//             full      the three passes (fused_layer_bwd)
// The JAX script's attn_bwd cut (dx0 before any parameter gradient) maps
// onto pass 1 without the per-sequence partial sums of the bias and
// LayerNorm gradients; the workspace writes stay, because pass 1 reads each
// rounded operand back as the input of its next product.  So full minus
// attn_bwd is those partial sums plus passes 2 and 3.  The full variants
// are the production kernels: a kStop branch that is not taken compiles to
// nothing.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;  // rows of a dense's output tile held in registers
constexpr float kNegInf = -1e9f;
constexpr float kInvSqrt2 = 0.70710678118654752f;

// where a section-profile variant stops (see above); the order of FWD_STAGES
// and BWD_STAGES in ops/fused_sections.py
enum FwdStop { kStopQkv = 0, kStopAttn = 1, kStopOutLn1 = 2, kStopFfnGelu = 3, kFwdFull = 4 };
enum BwdStop { kStopRecompute = 0, kStopFfnBwd = 1, kStopAttnBwd = 2, kBwdFull = 3 };

// a stage's tensor: the first D columns of rows [0, S) of src (leading
// dimension ld) into the (S, D) rows of dst
template <typename T>
__device__ void store_stage(const T* src, int ld, int S, int D, T* dst) {
  for (int i = threadIdx.x; i < S * D; i += blockDim.x) dst[i] = src[(i / D) * ld + i % D];
}

struct Params {
  const void* x;
  void* y;
  const int* mask;
  const float *qkv_w, *qkv_b, *out_w, *out_b, *ffn_in_w, *ffn_in_b;
  const float *ffn_out_w, *ffn_out_b, *ln1_s, *ln1_b, *ln2_s, *ln2_b;
  int S, D, H, F, causal, hg;
  uint32_t seed[3];
  uint32_t attn_thr, hidden_thr;
  float attn_keep, hidden_keep;
  int attn_drop, hidden_drop;
  float eps;
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

__host__ __device__ inline size_t smem_layout(int S, int D, int F, int hg,
                                              int elem, size_t* reg_off,
                                              size_t* sc_off, size_t* mask_off) {
  const int sp = round_up(S, kRows);
  const int rw = 3 * D > F + D ? 3 * D : F + D;
  *reg_off = (size_t)sp * D * elem;
  *sc_off = ((*reg_off + (size_t)sp * rw * elem) + 15) / 16 * 16;
  *mask_off = *sc_off + (size_t)hg * S * S * sizeof(float);
  return *mask_off + (size_t)S * sizeof(int);
}

// Eigen's f32 erf rational polynomial (what XLA lowers erf to), as in
// ops/fused_layer.py:_erf.
__device__ __forceinline__ float erf_eigen(float x) {
  x = fminf(fmaxf(x, -3.832506856900711f), 3.832506856900711f);
  const float x2 = x * x;
  float a = -2.72614225801306e-10f;
  a = a * x2 + 2.77068142495902e-08f;
  a = a * x2 + -2.10102402082508e-06f;
  a = a * x2 + -5.69250639462346e-05f;
  a = a * x2 + -7.34990630326855e-04f;
  a = a * x2 + -2.95459980854025e-03f;
  a = a * x2 + -1.60960333262415e-02f;
  a = a * x;
  float b = -1.45660718464996e-05f;
  b = b * x2 + -2.13374055278905e-04f;
  b = b * x2 + -1.68282697438203e-03f;
  b = b * x2 + -7.37332916720468e-03f;
  b = b * x2 + -1.42647390514189e-02f;
  return a / b;
}

enum Epilogue { kPlain = 0, kGelu = 1, kDropout = 2 };

// out[r, n] = T(in[r, :] . T(W[:, n]) + bias[n]) for r < S, then the
// epilogue.  Each thread owns one column and kRows rows at a time.
template <typename T>
__device__ void dense(const T* in, int in_ld, int K, const float* __restrict__ W,
                      const float* __restrict__ bias, int N, T* out, int out_ld,
                      int S, int epilogue, uint32_t row0, uint32_t seed,
                      uint32_t thr, float keep_div) {
  using A = xrt::Act<T>;
  const int chunks = (S + kRows - 1) / kRows;
  for (int item = threadIdx.x; item < N * chunks; item += blockDim.x) {
    const int n = item % N;
    const int r0 = (item / N) * kRows;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    const T* in_r = in + r0 * in_ld;
    for (int k = 0; k < K; ++k) {
      const float w = A::round(__ldg(W + (size_t)k * N + n));
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(A::load(in_r[r * in_ld + k]), w, acc[r]);
    }
    const float b = __ldg(bias + n);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r0 + r >= S) break;
      float v = A::round(acc[r] + b);
      if (epilogue == kGelu) {
        v = A::round(0.5f * v * (1.f + erf_eigen(v * kInvSqrt2)));
      } else if (epilogue == kDropout) {
        const uint32_t idx = (row0 + (uint32_t)(r0 + r)) * (uint32_t)N + (uint32_t)n;
        v = xrt::keep(idx, seed, thr) ? A::round(v / keep_div) : 0.f;
      }
      out[(r0 + r) * out_ld + n] = A::store(v);
    }
  }
}

// out[r] = T(LN(T(a[r] + b[r]))) over D features, one warp per row; out
// may alias a (each row is read in full before it is written).
template <typename T, typename O>
__device__ void add_layer_norm(const T* a, int a_ld, const T* b, int b_ld,
                               const float* __restrict__ gamma,
                               const float* __restrict__ beta, int S, int D,
                               float eps, O* out, int out_ld) {
  using A = xrt::Act<T>;
  const int lane = threadIdx.x & 31;
  for (int row = threadIdx.x >> 5; row < S; row += blockDim.x >> 5) {
    float sum = 0.f;
    for (int c = lane; c < D; c += 32)
      sum += A::round(A::load(a[row * a_ld + c]) + A::load(b[row * b_ld + c]));
    const float mean = xrt::warp_sum(sum) / (float)D;
    float sq = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float h = A::round(A::load(a[row * a_ld + c]) + A::load(b[row * b_ld + c]));
      sq += (h - mean) * (h - mean);
    }
    const float rstd = 1.f / sqrtf(xrt::warp_sum(sq) / (float)D + eps);
    __syncwarp();
    for (int c = lane; c < D; c += 32) {
      const float h = A::round(A::load(a[row * a_ld + c]) + A::load(b[row * b_ld + c]));
      out[row * out_ld + c] = xrt::Act<O>::store((h - mean) * rstd * __ldg(gamma + c) + __ldg(beta + c));
    }
    __syncwarp();
  }
}

template <typename T, int kStop>
__global__ void __launch_bounds__(kThreads, 1) fused_layer_fwd_kernel(Params p) {
  using A = xrt::Act<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = p.S, D = p.D, H = p.H, F = p.F, hg = p.hg;
  const int dh = D / H, ld3 = 3 * D, b = blockIdx.x;
  size_t reg_off, sc_off, mask_off;
  smem_layout(S, D, F, hg, sizeof(T), &reg_off, &sc_off, &mask_off);
  T* sx = reinterpret_cast<T*>(smem);
  T* reg = reinterpret_cast<T*>(smem + reg_off);
  float* sc = reinterpret_cast<float*>(smem + sc_off);
  int* smask = reinterpret_cast<int*>(smem + mask_off);
  const int sp = round_up(S, kRows);

  const T* xg = static_cast<const T*>(p.x) + (size_t)b * S * D;
  for (int i = threadIdx.x; i < S * D; i += blockDim.x) sx[i] = xg[i];
  for (int i = threadIdx.x; i < S; i += blockDim.x) smask[i] = p.mask[b * S + i] != 0;
  __syncthreads();

  dense<T>(sx, D, D, p.qkv_w, p.qkv_b, ld3, reg, ld3, S, kPlain, 0, 0, 0, 1.f);
  __syncthreads();
  if constexpr (kStop == kStopQkv) {
    store_stage<T>(reg, ld3, S, D, static_cast<T*>(p.y) + (size_t)b * S * D);
    return;
  }

  const float scale = 1.f / sqrtf((float)dh);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int h0 = 0; h0 < H; h0 += hg) {
    // scores = (q . k) * scale + key-padding bias + causal bias
    for (int item = threadIdx.x; item < hg * S * S; item += blockDim.x) {
      const int hh = item / (S * S), sq = (item / S) % S, t = item % S;
      const T* q = reg + sq * ld3 + (h0 + hh) * dh;
      const T* k = reg + t * ld3 + D + (h0 + hh) * dh;
      float dot = 0.f;
      for (int j = 0; j < dh; ++j) dot = fmaf(A::load(q[j]), A::load(k[j]), dot);
      const float bias = (smask[t] ? 0.f : kNegInf) + ((p.causal && t > sq) ? kNegInf : 0.f);
      sc[item] = dot * scale + bias;
    }
    __syncthreads();
    // softmax over keys, dropout on the probs, rounding to T
    for (int row = warp; row < hg * S; row += nwarps) {
      float* pr = sc + row * S;
      float m = -INFINITY;
      for (int t = lane; t < S; t += 32) m = fmaxf(m, pr[t]);
      m = xrt::warp_max(m);
      float sum = 0.f;
      for (int t = lane; t < S; t += 32) {
        const float e = expf(pr[t] - m);
        pr[t] = e;
        sum += e;
      }
      sum = xrt::warp_sum(sum);
      const uint32_t base =
          ((uint32_t)b * H + (uint32_t)(h0 + row / S)) * (uint32_t)(S * S) + (uint32_t)(row % S) * S;
      for (int t = lane; t < S; t += 32) {
        float v = pr[t] / sum;
        if (p.attn_drop) v = xrt::keep(base + t, p.seed[0], p.attn_thr) ? v / p.attn_keep : 0.f;
        pr[t] = A::round(v);
      }
    }
    __syncthreads();
    // ctx = P V, written over this stage's q columns
    for (int item = threadIdx.x; item < hg * S * dh; item += blockDim.x) {
      const int hh = item / (S * dh), sq = (item / dh) % S, j = item % dh;
      const int col = (h0 + hh) * dh + j;
      const float* pr = sc + (hh * S + sq) * S;
      float acc = 0.f;
      for (int t = 0; t < S; ++t) acc = fmaf(pr[t], A::load(reg[t * ld3 + 2 * D + col]), acc);
      reg[sq * ld3 + col] = A::store(acc);
    }
    __syncthreads();
  }
  if constexpr (kStop == kStopAttn) {
    store_stage<T>(reg, ld3, S, D, static_cast<T*>(p.y) + (size_t)b * S * D);
    return;
  }

  const uint32_t row0 = (uint32_t)b * S;
  // a = dropout(ctx Wout + b) into the dead k columns
  dense<T>(reg, ld3, D, p.out_w, p.out_b, D, reg + D, ld3, S,
           p.hidden_drop ? kDropout : kPlain, row0, p.seed[1], p.hidden_thr, p.hidden_keep);
  __syncthreads();
  add_layer_norm<T, T>(sx, D, reg + D, ld3, p.ln1_s, p.ln1_b, S, D, p.eps, sx, D);
  __syncthreads();
  if constexpr (kStop == kStopOutLn1) {
    store_stage<T>(sx, D, S, D, static_cast<T*>(p.y) + (size_t)b * S * D);
    return;
  }
  T* g = reg;
  T* f = reg + (size_t)sp * F;
  dense<T>(sx, D, D, p.ffn_in_w, p.ffn_in_b, F, g, F, S, kGelu, 0, 0, 0, 1.f);
  __syncthreads();
  if constexpr (kStop == kStopFfnGelu) {
    store_stage<T>(g, F, S, D, static_cast<T*>(p.y) + (size_t)b * S * D);
    return;
  }
  dense<T>(g, F, F, p.ffn_out_w, p.ffn_out_b, D, f, D, S,
           p.hidden_drop ? kDropout : kPlain, row0, p.seed[2], p.hidden_thr, p.hidden_keep);
  __syncthreads();
  T* yg = static_cast<T*>(p.y) + (size_t)b * S * D;
  add_layer_norm<T, T>(sx, D, f, D, p.ln2_s, p.ln2_b, S, D, p.eps, yg, D);
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

constexpr float kInvSqrt2Pi = 0.3989422804014327f;

// Abramowitz-Stegun rational erf (|abs err| <= 2.5e-5), as
// ops/fused_layer.py:_erf_as: the JAX kernel's backward recompute uses it
// under a bf16 compute type
__device__ __forceinline__ float erf_as(float x) {
  const float ax = fabsf(x);
  const float t = 1.f / (1.f + 0.47047f * ax);
  const float poly = t * (0.3480242f + t * (-0.0958798f + t * 0.7478556f));
  const float mag = 1.f - poly * expf(-ax * ax);
  return x < 0.f ? -mag : mag;
}

struct BwdParams {
  const void* x;
  const void* dy;
  const int* mask;
  const float *qkv_w, *qkv_b, *out_w, *out_b, *ffn_in_w, *ffn_in_b;
  const float *ffn_out_w, *ffn_out_b, *ln1_s, *ln1_b, *ln2_s, *ln2_b;
  void* dx;
  float *d_qkv_w, *d_qkv_b, *d_out_w, *d_out_b, *d_ffn_in_w, *d_ffn_in_b;
  float *d_ffn_out_w, *d_ffn_out_b, *d_ln1_s, *d_ln1_b, *d_ln2_s, *d_ln2_b;
  // workspace, R = B*S rows each (T unless noted)
  void *qkv, *ctx, *x1, *u, *g, *h1, *h2;  // R x 3D, D, D, F, F, D, D
  float* stats;                            // R x 4: mean1 rstd1 mean2 rstd2
  void *dfm, *dum, *dam, *dqm;             // R x D, F, D, 3D
  float *dres, *dqkv;                      // R x D, R x 3D
  float* partial;                          // B x (9D + F) column sums
  int B, S, D, H, F, causal;
  uint32_t seed[3];
  uint32_t attn_thr, hidden_thr;
  float attn_keep, hidden_keep_fwd, hidden_keep_bwd;
  int attn_drop, hidden_drop;
  float eps;
};

// offsets of the per-sequence column sums in a row of BwdParams::partial
struct VecOffsets {
  int qkv_b, out_b, ffn_in_b, ffn_out_b, ln1_s, ln1_b, ln2_s, ln2_b, total;
  __host__ __device__ explicit VecOffsets(int D, int F)
      : qkv_b(0), out_b(3 * D), ffn_in_b(4 * D), ffn_out_b(4 * D + F), ln1_s(5 * D + F),
        ln1_b(6 * D + F), ln2_s(7 * D + F), ln2_b(8 * D + F), total(9 * D + F) {}
};

// acc(r, n) = sum_k in[r, k] * T(W(k, n)) in f32 for the S rows of one
// sequence, with W(k, n) = W[k*N + n] (kTransposed false: a (K, N) weight
// as the forward uses it) or W[n*K + k] (true: the product with the
// transpose of an (N, K) weight).  One thread owns a column and walks all
// rows in order, so what ``epi(r, n, acc)`` returns sums into a column
// total in a fixed order; the totals go to colsum[n] when it is given.
template <typename T, bool kTransposed, typename Epi>
__device__ void dense_rows(const T* in, int in_ld, int K, const float* __restrict__ W, int N,
                           int S, Epi epi, float* colsum) {
  using A = xrt::Act<T>;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float total = 0.f;
    for (int r0 = 0; r0 < S; r0 += kRows) {
      const int rows = min(kRows, S - r0);
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      const T* in_r = in + (size_t)r0 * in_ld;
      for (int k = 0; k < K; ++k) {
        const float w = A::round(__ldg(kTransposed ? W + (size_t)n * K + k : W + (size_t)k * N + n));
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (r < rows) acc[r] = fmaf(A::load(in_r[(size_t)r * in_ld + k]), w, acc[r]);
      }
      for (int r = 0; r < rows; ++r) total += epi(r0 + r, n, acc[r]);
    }
    if (colsum != nullptr) colsum[n] = total;
  }
}

// h = T(a + b) row by row (written over a), its two-pass f32 LayerNorm
// statistics into stats[r*4 + 0..1], and T(LN(h)) into out; one warp per
// row, each lane on its own columns
template <typename T>
__device__ void add_ln_save(T* a, const T* b, const float* __restrict__ gamma,
                            const float* __restrict__ beta, int S, int D, float eps, float* stats,
                            T* out) {
  using A = xrt::Act<T>;
  const int lane = threadIdx.x & 31;
  for (int row = threadIdx.x >> 5; row < S; row += blockDim.x >> 5) {
    T* ar = a + (size_t)row * D;
    const T* br = b + (size_t)row * D;
    float sum = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float h = A::round(A::load(ar[c]) + A::load(br[c]));
      ar[c] = A::store(h);
      sum += h;
    }
    const float mean = xrt::warp_sum(sum) / (float)D;
    float sq = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float h = A::load(ar[c]);
      sq += (h - mean) * (h - mean);
    }
    const float rstd = 1.f / sqrtf(xrt::warp_sum(sq) / (float)D + eps);
    for (int c = lane; c < D; c += 32)
      out[(size_t)row * D + c] =
          A::store((A::load(ar[c]) - mean) * rstd * __ldg(gamma + c) + __ldg(beta + c));
    if (lane == 0) {
      stats[row * 4 + 0] = mean;
      stats[row * 4 + 1] = rstd;
    }
  }
}

// the LayerNorm VJP of ops/fused_layer.py:_ln_bwd, one warp per row:
// dh = rstd * (g - mean(g) - n * mean(g * n)), g = dy * scale,
// n = (h - mean) * rstd; dh goes to dres (which may hold dy), then
// dm = T(dropout'(dh)) to dm when drop_seed_on
template <typename T, typename DyT>
__device__ void ln_bwd_rows(const DyT* dy, const T* h, const float* stats, int stat_col,
                            const float* __restrict__ scale, int S, int D, float* dres, T* dm,
                            uint32_t row0, int drop, uint32_t seed, uint32_t thr, float keep_div) {
  using A = xrt::Act<T>;
  const int lane = threadIdx.x & 31;
  for (int row = threadIdx.x >> 5; row < S; row += blockDim.x >> 5) {
    const float mean = stats[row * 4 + stat_col], rstd = stats[row * 4 + stat_col + 1];
    float sg = 0.f, sgn = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float n = (A::load(h[(size_t)row * D + c]) - mean) * rstd;
      const float g = xrt::Act<DyT>::load(dy[(size_t)row * D + c]) * __ldg(scale + c);
      sg += g;
      sgn += g * n;
    }
    const float gm = xrt::warp_sum(sg) / (float)D;
    const float gnm = xrt::warp_sum(sgn) / (float)D;
    for (int c = lane; c < D; c += 32) {
      const float n = (A::load(h[(size_t)row * D + c]) - mean) * rstd;
      const float g = xrt::Act<DyT>::load(dy[(size_t)row * D + c]) * __ldg(scale + c);
      const float dh = rstd * (g - gm - n * gnm);
      dres[(size_t)row * D + c] = dh;
      float d = dh;
      if (drop) {
        const uint32_t idx = (row0 + (uint32_t)row) * (uint32_t)D + (uint32_t)c;
        d = xrt::keep(idx, seed, thr) ? dh / keep_div : 0.f;
      }
      dm[(size_t)row * D + c] = A::store(d);
    }
  }
}

// the dropout VJP at a hidden site, recomputed from the undropped f32
// cotangent: where the hash kept (row, c), d / keep_div, else 0
__device__ __forceinline__ float hidden_drop_bwd(float d, int drop, uint32_t row, int c, int D,
                                                 uint32_t seed, uint32_t thr, float keep_div) {
  if (!drop) return d;
  return xrt::keep(row * (uint32_t)D + (uint32_t)c, seed, thr) ? d / keep_div : 0.f;
}

// Pass 1 of the backward, one block per sequence: recompute the layer from
// x (as the TPU kernel does), then walk the VJP down to dx.  The rounded
// operands of the four weight-gradient products go to the workspace for
// pass 2; the bias and LayerNorm gradients are summed over the sequence's
// rows into one row of ``partial`` for pass 3.
template <typename T, int kStop>
__global__ void __launch_bounds__(kThreads, 1) fused_layer_bwd_rows_kernel(BwdParams p) {
  using A = xrt::Act<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = p.S, D = p.D, H = p.H, F = p.F, b = blockIdx.x;
  const int dh = D / H, ld3 = 3 * D;
  int* smask = reinterpret_cast<int*>(smem);
  float* sp = reinterpret_cast<float*>(smem) + ((S + 3) / 4) * 4;  // S x S probs
  float* sds = sp + S * S;                                          // S x S
  float* srow = sds + S * S;                                        // S
  const size_t row_base = (size_t)b * S;
  const uint32_t row0 = (uint32_t)row_base;
  const T* x = static_cast<const T*>(p.x) + row_base * D;
  const T* dy = static_cast<const T*>(p.dy) + row_base * D;
  T* qkv = static_cast<T*>(p.qkv) + row_base * ld3;
  T* ctx = static_cast<T*>(p.ctx) + row_base * D;
  T* x1 = static_cast<T*>(p.x1) + row_base * D;
  T* u = static_cast<T*>(p.u) + row_base * F;
  T* g = static_cast<T*>(p.g) + row_base * F;
  T* h1 = static_cast<T*>(p.h1) + row_base * D;
  T* h2 = static_cast<T*>(p.h2) + row_base * D;
  float* stats = p.stats + row_base * 4;
  T* dfm = static_cast<T*>(p.dfm) + row_base * D;
  T* dum = static_cast<T*>(p.dum) + row_base * F;
  T* dam = static_cast<T*>(p.dam) + row_base * D;
  T* dqm = static_cast<T*>(p.dqm) + row_base * ld3;
  float* dres = p.dres + row_base * D;
  float* dqkv = p.dqkv + row_base * ld3;
  const VecOffsets off(D, F);
  float* part = p.partial + (size_t)b * off.total;
  const bool approx_erf = sizeof(T) == 2;  // _APPROX_RECOMPUTE_ERF under bf16

  for (int i = threadIdx.x; i < S; i += blockDim.x) smask[i] = p.mask[b * S + i] != 0;

  // ---- recompute: qkv
  auto bias_round = [] (const float* bias, T* out, int ld) {
    return [=](int r, int n, float acc) {
      out[(size_t)r * ld + n] = A::store(acc + __ldg(bias + n));
      return 0.f;
    };
  };
  dense_rows<T, false>(x, D, D, p.qkv_w, ld3, S, bias_round(p.qkv_b, qkv, ld3), nullptr);
  __syncthreads();

  const float scale = 1.f / sqrtf((float)dh);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  // scores of head hh into sp: (q . k) * scale + key-padding and causal bias
  auto head_scores = [&](int hh) {
    for (int item = threadIdx.x; item < S * S; item += blockDim.x) {
      const int sq = item / S, t = item % S;
      const T* q = qkv + (size_t)sq * ld3 + hh * dh;
      const T* k = qkv + (size_t)t * ld3 + D + hh * dh;
      float dot = 0.f;
      for (int j = 0; j < dh; ++j) dot = fmaf(A::load(q[j]), A::load(k[j]), dot);
      const float bias = (smask[t] ? 0.f : kNegInf) + ((p.causal && t > sq) ? kNegInf : 0.f);
      sp[item] = dot * scale + bias;
    }
    __syncthreads();
    for (int row = warp; row < S; row += nwarps) {
      float* pr = sp + row * S;
      float m = -INFINITY;
      for (int t = lane; t < S; t += 32) m = fmaxf(m, pr[t]);
      m = xrt::warp_max(m);
      float sum = 0.f;
      for (int t = lane; t < S; t += 32) {
        const float e = expf(pr[t] - m);
        pr[t] = e;
        sum += e;
      }
      sum = xrt::warp_sum(sum);
      for (int t = lane; t < S; t += 32) pr[t] = pr[t] / sum;
    }
    __syncthreads();
  };
  // the dropped probability at (sq, t) of head hh, in f32
  auto dropped_at = [&](int hh, int sq, int t, float prob) {
    if (!p.attn_drop) return prob;
    const uint32_t idx = (((uint32_t)b * H + (uint32_t)hh) * (uint32_t)S + (uint32_t)sq) * (uint32_t)S + t;
    return xrt::keep(idx, p.seed[0], p.attn_thr) ? prob / p.attn_keep : 0.f;
  };

  // ---- recompute: attention, ctx = T(T(dropped) V) per head
  for (int hh = 0; hh < H; ++hh) {
    head_scores(hh);
    for (int item = threadIdx.x; item < S * dh; item += blockDim.x) {
      const int sq = item / dh, j = item % dh;
      const float* pr = sp + sq * S;
      float acc = 0.f;
      for (int t = 0; t < S; ++t)
        acc = fmaf(A::round(dropped_at(hh, sq, t, pr[t])),
                   A::load(qkv[(size_t)t * ld3 + 2 * D + hh * dh + j]), acc);
      ctx[(size_t)sq * D + hh * dh + j] = A::store(acc);
    }
    __syncthreads();
  }

  // ---- recompute: a = dropout(T(ctx Wout + b)) into h1, then h1 = T(x + a),
  // LN1 statistics, x1 = T(LN1(h1))
  const int hidden_drop = p.hidden_drop;
  const uint32_t hidden_thr = p.hidden_thr;
  const float hidden_keep_fwd = p.hidden_keep_fwd;
  auto dense_dropout = [=](const float* bias, T* out, uint32_t seed) {
    return [=](int r, int n, float acc) {
      float v = A::round(acc + __ldg(bias + n));
      if (hidden_drop) {
        const uint32_t idx = (row0 + (uint32_t)r) * (uint32_t)D + (uint32_t)n;
        v = xrt::keep(idx, seed, hidden_thr) ? A::round(v / hidden_keep_fwd) : 0.f;
      }
      out[(size_t)r * D + n] = A::store(v);
      return 0.f;
    };
  };
  dense_rows<T, false>(ctx, D, D, p.out_w, D, S, dense_dropout(p.out_b, h1, p.seed[1]), nullptr);
  __syncthreads();
  add_ln_save<T>(h1, x, p.ln1_s, p.ln1_b, S, D, p.eps, stats, x1);
  __syncthreads();

  // ---- recompute: u = T(x1 Win + b), g = T(gelu(u))
  dense_rows<T, false>(x1, D, D, p.ffn_in_w, F, S, bias_round(p.ffn_in_b, u, F), nullptr);
  __syncthreads();
  for (int i = threadIdx.x; i < S * F; i += blockDim.x) {
    const float uv = A::load(u[i]);
    const float e = approx_erf ? erf_as(uv * kInvSqrt2) : erf_eigen(uv * kInvSqrt2);
    g[i] = A::store(0.5f * uv * (1.f + e));
  }
  __syncthreads();

  // ---- recompute: f = dropout(T(g Wffn_out + b)) into h2, then h2 = T(x1 + f)
  // and the LN2 statistics (its output is not needed)
  dense_rows<T, false>(g, F, F, p.ffn_out_w, D, S, dense_dropout(p.ffn_out_b, h2, p.seed[2]),
                       nullptr);
  __syncthreads();
  for (int row = warp; row < S; row += nwarps) {
    T* hr = h2 + (size_t)row * D;
    float sum = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float h = A::round(A::load(hr[c]) + A::load(x1[(size_t)row * D + c]));
      hr[c] = A::store(h);
      sum += h;
    }
    const float mean = xrt::warp_sum(sum) / (float)D;
    float sq = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float h = A::load(hr[c]);
      sq += (h - mean) * (h - mean);
    }
    const float rstd = 1.f / sqrtf(xrt::warp_sum(sq) / (float)D + p.eps);
    if (lane == 0) {
      stats[row * 4 + 2] = mean;
      stats[row * 4 + 3] = rstd;
    }
    if constexpr (kStop == kStopRecompute) {  // the recomputed y = T(LN2(h2))
      T* y = static_cast<T*>(p.dx) + (row_base + row) * D;
      for (int c = lane; c < D; c += 32)
        y[c] = A::store((A::load(hr[c]) - mean) * rstd * __ldg(p.ln2_s + c) + __ldg(p.ln2_b + c));
    }
  }
  __syncthreads();
  if constexpr (kStop == kStopRecompute) return;

  // ---- LN2 backward: dh2 into dres (= dx1 so far), dfm = T(dropout'(dh2))
  ln_bwd_rows<T, T>(dy, h2, stats, 2, p.ln2_s, S, D, dres, dfm, row0, p.hidden_drop, p.seed[2],
                    p.hidden_thr, p.hidden_keep_bwd);
  __syncthreads();
  if constexpr (kStop == kBwdFull) {
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      float s_scale = 0.f, s_bias = 0.f, s_fb = 0.f;
      for (int r = 0; r < S; ++r) {
        const float dyv = A::load(dy[(size_t)r * D + c]);
        const float n = (A::load(h2[(size_t)r * D + c]) - stats[r * 4 + 2]) * stats[r * 4 + 3];
        s_scale += dyv * n;
        s_bias += dyv;
        s_fb += hidden_drop_bwd(dres[(size_t)r * D + c], p.hidden_drop, row0 + r, c, D,
                                p.seed[2], p.hidden_thr, p.hidden_keep_bwd);
      }
      part[off.ln2_s + c] = s_scale;
      part[off.ln2_b + c] = s_bias;
      part[off.ffn_out_b + c] = s_fb;
    }
  }
  __syncthreads();

  // ---- FFN backward: du = (dfm Wffn_out^T) * gelu'(u), dum = T(du)
  auto gelu_bwd = [=](int r, int n, float acc) {
    const float uv = A::load(u[(size_t)r * F + n]);
    const float e = approx_erf ? erf_as(uv * kInvSqrt2) : erf_eigen(uv * kInvSqrt2);
    const float phi = expf(-0.5f * uv * uv) * kInvSqrt2Pi;
    const float du = acc * (0.5f * (1.f + e) + uv * phi);
    dum[(size_t)r * F + n] = A::store(du);
    return du;
  };
  dense_rows<T, true>(dfm, D, D, p.ffn_out_w, F, S, gelu_bwd,
                      kStop == kBwdFull ? part + off.ffn_in_b : nullptr);
  __syncthreads();
  // dx1 = dh2 + dum Win^T
  auto add_to_dres = [=](int r, int n, float acc) {
    dres[(size_t)r * D + n] += acc;
    return 0.f;
  };
  dense_rows<T, true>(dum, F, F, p.ffn_in_w, D, S, add_to_dres, nullptr);
  __syncthreads();
  if constexpr (kStop == kBwdFull) {
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      float s_scale = 0.f, s_bias = 0.f;
      for (int r = 0; r < S; ++r) {
        const float d = dres[(size_t)r * D + c];
        const float n = (A::load(h1[(size_t)r * D + c]) - stats[r * 4]) * stats[r * 4 + 1];
        s_scale += d * n;
        s_bias += d;
      }
      part[off.ln1_s + c] = s_scale;
      part[off.ln1_b + c] = s_bias;
    }
  }
  __syncthreads();

  // ---- LN1 backward: dh1 over dres, dam = T(dropout'(dh1))
  ln_bwd_rows<T, float>(dres, h1, stats, 0, p.ln1_s, S, D, dres, dam, row0, p.hidden_drop,
                        p.seed[1], p.hidden_thr, p.hidden_keep_bwd);
  __syncthreads();
  if constexpr (kStop == kBwdFull) {
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      float s = 0.f;
      for (int r = 0; r < S; ++r)
        s += hidden_drop_bwd(dres[(size_t)r * D + c], p.hidden_drop, row0 + r, c, D, p.seed[1],
                             p.hidden_thr, p.hidden_keep_bwd);
      part[off.out_b + c] = s;
    }
  }
  // gw = T(dam Wout^T) into h2 (no longer needed)
  T* gw = h2;
  auto store_round = [=](int r, int n, float acc) {
    gw[(size_t)r * D + n] = A::store(acc);
    return 0.f;
  };
  __syncthreads();
  dense_rows<T, true>(dam, D, D, p.out_w, D, S, store_round, nullptr);
  __syncthreads();
  if constexpr (kStop == kStopFfnBwd) {
    store_stage<T>(gw, D, S, D, static_cast<T*>(p.dx) + row_base * D);
    return;
  }

  // ---- attention backward, one head at a time, into dqkv (f32)
  for (int hh = 0; hh < H; ++hh) {
    head_scores(hh);  // sp = probs (f32)
    // sds = d_probs: the dropout VJP of d_dropped = gw V^T
    for (int item = threadIdx.x; item < S * S; item += blockDim.x) {
      const int sq = item / S, t = item % S;
      const T* gr = gw + (size_t)sq * D + hh * dh;
      const T* v = qkv + (size_t)t * ld3 + 2 * D + hh * dh;
      float dd = 0.f;
      for (int j = 0; j < dh; ++j) dd = fmaf(A::load(gr[j]), A::load(v[j]), dd);
      if (p.attn_drop) dd = dropped_at(hh, sq, t, sp[item]) != 0.f ? dd / p.attn_keep : 0.f;
      sds[item] = dd;
    }
    __syncthreads();
    for (int row = warp; row < S; row += nwarps) {
      float s = 0.f;
      for (int t = lane; t < S; t += 32) s += sds[row * S + t] * sp[row * S + t];
      s = xrt::warp_sum(s);
      if (lane == 0) srow[row] = s;
    }
    __syncthreads();
    // d_scores = T(probs * (d_probs - rowsum) * scale); sp becomes T(dropped)
    for (int item = threadIdx.x; item < S * S; item += blockDim.x) {
      const int sq = item / S, t = item % S;
      const float prob = sp[item];
      sds[item] = A::round(prob * (sds[item] - srow[sq]) * scale);
      sp[item] = A::round(dropped_at(hh, sq, t, prob));
    }
    __syncthreads();
    // dq = d_scores K, dk = d_scores^T Q, dv = T(dropped)^T gw
    for (int item = threadIdx.x; item < S * dh; item += blockDim.x) {
      const int s0 = item / dh, j = item % dh;
      const int col = hh * dh + j;
      float aq = 0.f, ak = 0.f, av = 0.f;
      for (int t = 0; t < S; ++t) {
        aq = fmaf(sds[s0 * S + t], A::load(qkv[(size_t)t * ld3 + D + col]), aq);
        ak = fmaf(sds[t * S + s0], A::load(qkv[(size_t)t * ld3 + col]), ak);
        av = fmaf(sp[t * S + s0], A::load(gw[(size_t)t * D + col]), av);
      }
      dqkv[(size_t)s0 * ld3 + col] = aq;
      dqkv[(size_t)s0 * ld3 + D + col] = ak;
      dqkv[(size_t)s0 * ld3 + 2 * D + col] = av;
    }
    __syncthreads();
  }

  // ---- qkv bias gradient and dqm = T(dqkv)
  for (int c = threadIdx.x; c < ld3; c += blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < S; ++r) {
      const float d = dqkv[(size_t)r * ld3 + c];
      s += d;
      dqm[(size_t)r * ld3 + c] = A::store(d);
    }
    if constexpr (kStop == kBwdFull) part[off.qkv_b + c] = s;
  }
  __syncthreads();
  // dx = T(dh1 + dqm Wqkv^T)
  T* dx = static_cast<T*>(p.dx) + row_base * D;
  auto store_dx = [=](int r, int n, float acc) {
    dx[(size_t)r * D + n] = A::store(dres[(size_t)r * D + n] + acc);
    return 0.f;
  };
  dense_rows<T, true>(dqm, ld3, ld3, p.qkv_w, D, S, store_dx, nullptr);
}

constexpr int kTile = 64;     // weight-gradient tile: kTile x kTile outputs
constexpr int kRowChunk = 16;  // rows staged per step

// Pass 2: dW = X^T Y over all R rows for the four weights, blockIdx.z
// picking the product; each block owns a kTile x kTile tile of dW and walks
// the rows in order (deterministic, no atomics), 4 x 4 outputs a thread.
template <typename T>
__global__ void __launch_bounds__(256) weight_grad_kernel(BwdParams p) {
  using A = xrt::Act<T>;
  __shared__ float sx[kRowChunk][kTile];
  __shared__ float sy[kRowChunk][kTile];
  const int D = p.D, F = p.F, R = p.B * p.S;
  const T* X;
  const T* Y;
  float* dW;
  int K, N;
  switch (blockIdx.z) {
    case 0: X = static_cast<const T*>(p.x); Y = static_cast<const T*>(p.dqm); dW = p.d_qkv_w; K = D; N = 3 * D; break;
    case 1: X = static_cast<const T*>(p.ctx); Y = static_cast<const T*>(p.dam); dW = p.d_out_w; K = D; N = D; break;
    case 2: X = static_cast<const T*>(p.x1); Y = static_cast<const T*>(p.dum); dW = p.d_ffn_in_w; K = D; N = F; break;
    default: X = static_cast<const T*>(p.g); Y = static_cast<const T*>(p.dfm); dW = p.d_ffn_out_w; K = F; N = D; break;
  }
  const int k0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  if (k0 >= K || n0 >= N) return;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int r0 = 0; r0 < R; r0 += kRowChunk) {
    for (int i = threadIdx.x; i < kRowChunk * kTile; i += blockDim.x) {
      const int rr = i / kTile, cc = i % kTile, r = r0 + rr;
      sx[rr][cc] = (r < R && k0 + cc < K) ? A::load(X[(size_t)r * K + k0 + cc]) : 0.f;
      sy[rr][cc] = (r < R && n0 + cc < N) ? A::load(Y[(size_t)r * N + n0 + cc]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < kRowChunk; ++rr) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = sx[rr][ty + 16 * i];
        bv[i] = sy[rr][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (k < K && n < N) dW[(size_t)k * N + n] = acc[i][j];
    }
}

// Pass 3: the bias and LayerNorm gradients, the per-sequence column sums
// added over the sequences in order
__global__ void vector_grad_kernel(BwdParams p) {
  const VecOffsets off(p.D, p.F);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= off.total) return;
  float s = 0.f;
  for (int b = 0; b < p.B; ++b) s += p.partial[(size_t)b * off.total + i];
  float* dst;
  if (i < off.out_b) dst = p.d_qkv_b + i;
  else if (i < off.ffn_in_b) dst = p.d_out_b + (i - off.out_b);
  else if (i < off.ffn_out_b) dst = p.d_ffn_in_b + (i - off.ffn_in_b);
  else if (i < off.ln1_s) dst = p.d_ffn_out_b + (i - off.ffn_out_b);
  else if (i < off.ln1_b) dst = p.d_ln1_s + (i - off.ln1_s);
  else if (i < off.ln2_s) dst = p.d_ln1_b + (i - off.ln1_b);
  else if (i < off.ln2_b) dst = p.d_ln2_s + (i - off.ln2_s);
  else dst = p.d_ln2_b + (i - off.ln2_b);
  *dst = s;
}

__host__ __device__ inline size_t bwd_smem_bytes(int S) {
  return (size_t)((S + 3) / 4) * 4 * sizeof(int) + (size_t)(2 * S * S + S) * sizeof(float);
}

template <typename T, int kStop>
cudaError_t launch_bwd(const BwdParams& p, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(p.S);
  cudaError_t err = cudaFuncSetAttribute(fused_layer_bwd_rows_kernel<T, kStop>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fused_layer_bwd_rows_kernel<T, kStop><<<p.B, kThreads, smem, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if constexpr (kStop != kBwdFull) return cudaSuccess;  // a section variant: pass 1 only
  const int tiles = (max(p.F, 3 * p.D) + kTile - 1) / kTile;
  weight_grad_kernel<T><<<dim3(tiles, tiles, 4), 256, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int total = VecOffsets(p.D, p.F).total;
  vector_grad_kernel<<<(total + 255) / 256, 256, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_stage(const BwdParams& p, int stage, cudaStream_t stream) {
  switch (stage) {
    case kStopRecompute: return launch_bwd<T, kStopRecompute>(p, stream);
    case kStopFfnBwd: return launch_bwd<T, kStopFfnBwd>(p, stream);
    case kStopAttnBwd: return launch_bwd<T, kStopAttnBwd>(p, stream);
    case kBwdFull: return launch_bwd<T, kBwdFull>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int kStop>
cudaError_t launch(const Params& p, int B, int smem_bytes, cudaStream_t stream) {
  size_t reg_off, sc_off, mask_off;
  const size_t need = smem_layout(p.S, p.D, p.F, p.hg, sizeof(T), &reg_off, &sc_off, &mask_off);
  if (need > (size_t)smem_bytes) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fused_layer_fwd_kernel<T, kStop>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  fused_layer_fwd_kernel<T, kStop><<<B, kThreads, smem_bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_stage(const Params& p, int B, int smem_bytes, int stage, cudaStream_t stream) {
  switch (stage) {
    case kStopQkv: return launch<T, kStopQkv>(p, B, smem_bytes, stream);
    case kStopAttn: return launch<T, kStopAttn>(p, B, smem_bytes, stream);
    case kStopOutLn1: return launch<T, kStopOutLn1>(p, B, smem_bytes, stream);
    case kStopFfnGelu: return launch<T, kStopFfnGelu>(p, B, smem_bytes, stream);
    case kFwdFull: return launch<T, kFwdFull>(p, B, smem_bytes, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int fused_layer_smem_bytes(int S, int D, int F, int hg, int elem) {
  size_t reg_off, sc_off, mask_off;
  return (int)smem_layout(S, D, F, hg, elem, &reg_off, &sc_off, &mask_off);
}

// The layer, or with stage < kFwdFull a section variant (see the top of
// this file), for B sequences of S <= 64 rows.
extern "C" int fused_layer_fwd(
    const void* x, void* y, const int* mask, const float* qkv_w, const float* qkv_b,
    const float* out_w, const float* out_b, const float* ffn_in_w, const float* ffn_in_b,
    const float* ffn_out_w, const float* ffn_out_b, const float* ln1_s, const float* ln1_b,
    const float* ln2_s, const float* ln2_b, int B, int S, int D, int H, int F, int causal,
    int is_bf16, int heads_per_stage, uint32_t seed0, uint32_t seed1, uint32_t seed2,
    uint32_t attn_thr, uint32_t hidden_thr, float attn_keep, float hidden_keep, int attn_drop,
    int hidden_drop, float eps, int smem_bytes, int stage, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (S <= 0 || S > 64 || D % H != 0 || H % heads_per_stage != 0) return cudaErrorInvalidValue;
  if (stage == kStopFfnGelu && F < D) return cudaErrorInvalidValue;
  Params p{x, y, mask, qkv_w, qkv_b, out_w, out_b, ffn_in_w, ffn_in_b, ffn_out_w, ffn_out_b,
           ln1_s, ln1_b, ln2_s, ln2_b, S, D, H, F, causal, heads_per_stage,
           {seed0, seed1, seed2}, attn_thr, hidden_thr, attn_keep, hidden_keep,
           attn_drop, hidden_drop, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_stage<__nv_bfloat16>(p, B, smem_bytes, stage, s)
                 : launch_stage<float>(p, B, smem_bytes, stage, s);
}

// The backward of fused_layer_fwd: dx (T) and the 12 f32 parameter
// gradients, summed over the batch.  ws[15] is the workspace described in
// BwdParams, in its order, allocated by the caller.  With stage <
// kBwdFull, pass 1's section variant alone, its stage's tensor in dx.
extern "C" int fused_layer_bwd(
    const void* x, const void* dy, const int* mask, const float* qkv_w, const float* qkv_b,
    const float* out_w, const float* out_b, const float* ffn_in_w, const float* ffn_in_b,
    const float* ffn_out_w, const float* ffn_out_b, const float* ln1_s, const float* ln1_b,
    const float* ln2_s, const float* ln2_b, void* dx, float* d_qkv_w, float* d_qkv_b,
    float* d_out_w, float* d_out_b, float* d_ffn_in_w, float* d_ffn_in_b, float* d_ffn_out_w,
    float* d_ffn_out_b, float* d_ln1_s, float* d_ln1_b, float* d_ln2_s, float* d_ln2_b,
    void* ws_qkv, void* ws_ctx, void* ws_x1, void* ws_u, void* ws_g, void* ws_h1, void* ws_h2,
    float* ws_stats, void* ws_dfm, void* ws_dum, void* ws_dam, void* ws_dqm, float* ws_dres,
    float* ws_dqkv, float* ws_partial, int B, int S, int D, int H, int F, int causal,
    int is_bf16, uint32_t seed0, uint32_t seed1, uint32_t seed2, uint32_t attn_thr,
    uint32_t hidden_thr, float attn_keep, float hidden_keep_fwd, float hidden_keep_bwd,
    int attn_drop, int hidden_drop, float eps, int stage, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (S <= 0 || S > 64 || D % H != 0) return cudaErrorInvalidValue;
  BwdParams p{x, dy, mask, qkv_w, qkv_b, out_w, out_b, ffn_in_w, ffn_in_b, ffn_out_w,
              ffn_out_b, ln1_s, ln1_b, ln2_s, ln2_b, dx, d_qkv_w, d_qkv_b, d_out_w, d_out_b,
              d_ffn_in_w, d_ffn_in_b, d_ffn_out_w, d_ffn_out_b, d_ln1_s, d_ln1_b, d_ln2_s,
              d_ln2_b, ws_qkv, ws_ctx, ws_x1, ws_u, ws_g, ws_h1, ws_h2, ws_stats, ws_dfm,
              ws_dum, ws_dam, ws_dqm, ws_dres, ws_dqkv, ws_partial, B, S, D, H, F, causal,
              {seed0, seed1, seed2}, attn_thr, hidden_thr, attn_keep, hidden_keep_fwd,
              hidden_keep_bwd, attn_drop, hidden_drop, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bwd_stage<__nv_bfloat16>(p, stage, s)
                 : launch_bwd_stage<float>(p, stage, s);
}
