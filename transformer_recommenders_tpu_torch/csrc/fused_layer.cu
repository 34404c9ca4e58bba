// One whole post-LN transformer encoder layer: the forward, one cluster of
// 1 to 4 CTAs per sequence, and the backward (below).
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
// HBM; what matters is that no intermediate goes to device memory, that
// the layer is one launch, and that enough of the card works on it.
//
// bf16 (fused_layer_fwd_tc_kernel, 12 warps): every product on the
// tensor cores (mma.sync m16n8k16, bf16 operands, f32 sums): the five
// dense products, each head's scores q k^T and its P V.  A pre-pass
// rounds the four f32 weights to bf16 once per call, packed in B-fragment
// order so that a warp's fragments of one k-step are one coalesced load
// (pack_weights_kernel, into a workspace the wrapper allocates); the A
// fragments come from shared memory by ldmatrix.  Every activation stays
// in shared memory.  The attention runs a warp per (head, 16 query rows)
// with the scores in registers, the softmax across the four lanes that
// hold a row, and the probs repacked as P V's A fragments.  Where the
// batch leaves SMs idle (B < 132: serving's B=64, the reference config's
// B=32) a sequence is split across a thread-block cluster of 2 or 4 CTAs:
// each computes its slice of every product's output columns and its share
// of the heads, and writes what the others read into every CTA's copy
// through distributed shared memory, with a cluster barrier before each
// LayerNorm and each next product; each CTA runs the LayerNorms of every
// row on its own copy.  Each output's k-sum stays inside one warp's mma
// chain, so the bits do not depend on the cluster size.  The wrapper
// plans the cluster size (ops/fused_layer.py: cluster_size).
//
// What bounds it (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py's section
// profile): latency, not the tensor cores.  A CTA holds one sequence's 32
// rows, so it reads every weight from L2 for 32 rows of work, and its 12
// warps run long dependent chains (fragment loads, mma, the softmax's
// exp and divide, the LayerNorms' shuffles) with little to hide them.
//
// f32 (fused_layer_fwd_f32_kernel): every product stays exact f32 FMAs on
// the CUDA cores (TF32 would break the f32 bound), each output one
// thread's chain over k in order.  A sequence is split across a cluster of
// 1, 2 or 4 CTAs as in bf16 (B=32 takes 4: 128 CTAs on 132 SMs), ctx, a,
// g and f shared through distributed shared memory.  A product (f32_product)
// runs passes of 128 output columns: per chunk of 32 k the pass's weight
// tile goes to shared memory by 16-byte cp.async, double-buffered, read by
// all the CTA's rows; each warp holds 4 rows (8 for S > 32) and each lane
// 4 columns, a register tile of 16 (32) sums fed by 16-byte shared loads.
// The attention takes a head group at a time (all the CTA's heads where
// they fit): a warp per (head, query row) holds the row's scores across
// its lanes, the softmax's max and sum by shuffles, then sums P V with a
// lane per head column.
//
// Numerics follow the JAX kernel: T-rounded (bf16 or f32) activations,
// f32 accumulation plus an f32 bias then rounding to T after each dense,
// residual adds rounded to T before a two-pass f32 LayerNorm, probs
// divided, dropped, then rounded to T before P V, the additive -1e9
// key-padding and causal bias, the Eigen erf polynomial in the GELU, the
// bf16-rounded hidden-dropout divisor, and the fmix32 dropout over the
// global element index.  A product of two bf16 values is exact in f32, so
// the tensor cores change only the order of the f32 sums inside a product.
// There is no TPU layout here: no head-masked wide tiles and no FFN
// padding to 128.
//
// Shared memory of the f32 kernel: F32Layout below (x, ctx then g, a head
// group's q|k|v then a and f, two weight tiles; 181,760 bytes at S=32,
// D=384, F=48 and 3 or 4 heads a group), and of the bf16 kernel
// (TcLayout; rows rounded up to 16): sx, ctx and hb
// (the out and FFN-out products) at leading dimension D + 8, big at
// max(3D, F) + 8 (qkv, then the GELU output g), bf16; the mask.  The
// scores and probs stay in registers.  At S=32, D=128, F=512 that is
// 59,520 bytes; at D=384 (H=12, F=48) 149,632.
//
// The backward (fused_layer_bwd) replaces ops/fused_layer.py:_bwd_kernel:
// it recomputes the layer from its input x and returns dx plus the 12 f32
// parameter gradients summed over the batch.  The TPU kernel carries the
// parameter-gradient sums in VMEM across its sequential grid; blocks on the
// card run in parallel, so the backward is a few passes, all deterministic
// (no atomics):
//   0. (bf16) the four weights rounded to bf16 once and packed in
//      B-fragment order (pack_weights_kernel), W and W^T, so that the
//      recompute's products (with W) and the VJP's (with W^T) load a warp's
//      fragments of a k-step as one coalesced 256-byte load;
//   1. the layer recomputed (with the JAX backward's own numerics: the A&S
//      erf in the GELU under bf16, the f32 dropout divisor in the VJP) and
//      the VJP walked down to dx, through a workspace in device memory;
//      the rounded operands of the weight-gradient products stay there for
//      pass 2, and the bias and LayerNorm gradients are summed over each
//      sequence's rows into its row of a partials buffer;
//   2. dW = X^T dY for the four weights, split over ranges of rows;
//   3. the partials summed over the sequences, and pass 2's partial tiles
//      over its row splits, in order.
// What bounds the bf16 pass 1 (fused_layer_bwd_rows_kernel): ~3x the
// forward's products (the recompute, then two products per dense), ~32
// GFLOP at B=256, S=32, D=384 (the quality run's), against which the
// tensor cores need ~0.03 ms.  It runs far from both.  Every CTA streams
// every weight from L2 (2.5 MB of bf16 at D=384) for its rows, so the
// products are suspected to be bound by L2's bandwidth shared by the card
// (not measured: no counters on the card's machine); the rest of the layer
// (the softmax, the dropout hashes, the LayerNorms and their VJPs) is
// chains of dependent steps inside a CTA.  The design (where one CTA a
// sequence read each weight fragment for 32 rows, with scalar operand
// loads, f32 attention buffers, and the column sums and dq, dk, dv round
// trips through device memory):
//   - more rows per weight fragment: a CTA takes as many whole sequences
//     as one wave of the card needs (bwd_tc_plan: 2 at B=256, 128 CTAs;
//     at most 64 rows, four m-tiles that each fragment a warp loads feeds),
//     or where the batch leaves SMs idle one sequence on a cluster of 2-4
//     CTAs (path B's B=32 on 3: 96 CTAs, the card's count of co-resident
//     clusters), each CTA its heads and its share of every product's
//     8-column blocks, the CTAs sharing the workspace behind a fence and a
//     cluster barrier;
//   - the products (dense_tc, the forward's loop) stage their operand rows
//     by cp.async and read the packed weights (W, or W^T in the VJP) four
//     k-steps ahead from L2; the epilogues that read what they update
//     (dres, u) load it before their stores (dense_tc_in);
//   - the attention a warp per (head, 16 query rows) on the tensor cores
//     with the scores in the mma accumulators and the softmax over the quad
//     of lanes that holds a row (tc_probs, as the forward's attention_tc),
//     the VJP to the d_scores in the same registers (tc_attention_grad),
//     then dq, dk and dv from T(d_scores) and T(dropped) in shared memory,
//     every operand by ldmatrix (tc_attention_products), the qkv bias's
//     column sums in their epilogue: no f32 probs or dq, dk, dv buffer; a
//     head's columns staged at round_up(dh, 16) with zeros past dh, so that
//     any even head width takes whole k-steps (the padding adds 0);
//   - the row steps (the LayerNorms and their VJPs) hold a row in
//     registers, one load of it, and add their column sums (the LayerNorm
//     gradients, the out and ffn_out biases) into a slot of shared memory
//     a warp, summed over the warps in order (and over a cluster's CTAs in
//     rank order through distributed shared memory), not re-read from
//     device memory.
// Only the order of the f32 sums inside a product changes (and that of
// the column sums and of a softmax row's sum); every rounding stays where
// the f32 path has it.  Pass 2 is a split-K product on the tensor cores,
// one block per 64 x 64 tile of a dW and range of rows, so that hundreds
// of blocks run, its rows staged as they lie by cp.async (double-buffered)
// and read transposed by ldmatrix.trans.  Under f32 the products stay f32
// FMAs on CUDA cores (TF32 would break the f32 gradients' 1e-4 bound):
// pass 1 (fused_layer_bwd_rows_f32_kernel) splits a sequence across the
// forward's cluster, each CTA its heads and its share of every product's
// columns through f32_product (its operand rows staged from the workspace
// with the weight tiles), the row-wise steps split by rows, the CTAs
// sharing the workspace behind a fence and a cluster barrier; the
// attention's VJP a head group at a time, a warp per (head, query row)
// for dq and per (head, key row) for dk and dv; pass 2 the same split-K
// tiles with 4 x 4 register tiles over cp.async-staged rows.
//
// Section profile.  The forward and pass 1 of the backward take a stop
// stage (bf16: the template argument kStop; f32: a run-time argument, so
// that the f32 kernels compile once): the kernel stops after it and stores the
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
//             full      the four passes (fused_layer_bwd; f32 three)
// The JAX script's attn_bwd cut (dx0 before any parameter gradient) maps
// onto pass 1 without the per-sequence partial sums of the bias and
// LayerNorm gradients; the workspace writes stay, because pass 1 reads each
// rounded operand back as the input of its next product.  So full minus
// attn_bwd is those partial sums plus passes 2 and 3.  The full variants
// are the production kernels: a kStop branch that is not taken compiles to
// nothing, and the f32 kernels' stop tests are uniform branches.
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;  // the f32 kernels: 8 warps
// pass 1 of the bf16 backward: 16 warps (at most 128 registers a thread),
// so that more of its loads are in flight; the row steps' column sums take
// a slot a warp (ops/fused_layer.py BWD_WARPS)
constexpr int kBwdTcThreads = 512;
constexpr float kNegInf = -1e9f;
constexpr float kInvSqrt2 = 0.70710678118654752f;

// where a section-profile variant stops (see above); the order of FWD_STAGES
// and BWD_STAGES in ops/fused_sections.py
enum FwdStop { kStopQkv = 0, kStopAttn = 1, kStopOutLn1 = 2, kStopFfnGelu = 3, kFwdFull = 4 };
enum BwdStop { kStopRecompute = 0, kStopFfnBwd = 1, kStopAttnBwd = 2, kBwdFull = 3 };

// a stage's tensor: rows row0, row0 + step, ... < S, columns [c0, c1) of
// src (leading dimension ld) into the (S, D) rows of dst
template <typename T>
__device__ void store_rows(const T* src, int ld, int S, int D, int c0, int c1, int row0,
                           int step, T* dst) {
  const int w = c1 - c0;
  for (int i = threadIdx.x; i < S * w; i += blockDim.x) {
    const int r = i / w, c = c0 + i % w;
    if (r % step == row0) dst[(size_t)r * D + c] = src[r * ld + c];
  }
}

struct Params {
  const void* x;
  void* y;
  const int* mask;
  const float *qkv_w, *qkv_b, *out_w, *out_b, *ffn_in_w, *ffn_in_b;
  const float *ffn_out_w, *ffn_out_b, *ln1_s, *ln1_b, *ln2_s, *ln2_b;
  int S, D, H, F, causal, hg;
  xrt::Seeds seed;  // the three site seeds, read from device memory
  uint32_t attn_thr, hidden_thr;
  float attn_keep, hidden_keep;
  int attn_drop, hidden_drop;
  float eps;
  int cluster;  // CTAs a sequence is split across
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

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

// out[r] = T(LN(T(a[r] + b[r]))) over D features for rows r = row0,
// row0 + step, ... < S, one warp per row; out may alias a (each row is
// read in full before it is written).
template <typename T, typename O>
__device__ void add_layer_norm(const T* a, int a_ld, const T* b, int b_ld,
                               const float* __restrict__ gamma,
                               const float* __restrict__ beta, int S, int D,
                               float eps, O* out, int out_ld, int row0 = 0, int step = 1) {
  using A = xrt::Act<T>;
  const int lane = threadIdx.x & 31;
  for (int row = row0 + (threadIdx.x >> 5) * step; row < S; row += (blockDim.x >> 5) * step) {
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

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

constexpr float kInvSqrt2Pi = 0.3989422804014327f;

// Abramowitz-Stegun rational erf (|abs err| <= 2.5e-5), as
// ops/fused_layer.py:_erf_as: the JAX kernel's backward recompute uses it
// under a bf16 compute type
__device__ __forceinline__ float erf_as(float x) {
  const float ax = fabsf(x);
  const float t = __frcp_rn(1.f + 0.47047f * ax);  // 1 / x rounded once: the division's bits
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
  float *dres, *duf;                       // R x D, R x F (duf, du before its rounding: bf16 only)
  float* partial;                          // B x (9D + F) column sums
  int B, S, D, H, F, causal;
  xrt::Seeds seed;  // the three site seeds, read from device memory
  uint32_t attn_thr, hidden_thr;
  float attn_keep, hidden_keep_fwd, hidden_keep_bwd;
  int attn_drop, hidden_drop;
  float eps;
  // bf16 only (the tensor-core path): the four weights rounded to bf16 once
  // per call and packed in B-fragment order (pack_weights_kernel), W at
  // WOffsets, then W^T at WOffsets::total + WOffsets; the sequences a CTA
  // of pass 1 takes; whether its products stage each whole packed weight in
  // shared memory.  Both: the weight-gradient partial tiles, splits x
  // WOffsets::total; the heads whose attention pass 1 stages at once; pass
  // 2's rows per split; the CTAs a sequence of pass 1 is split across
  uint2* wp;
  float* wpart;
  int hg, splits, rows_per_split, cluster, seqs;
};

// offsets of the four weights (and of their gradients) laid end to end:
// qkv (D, 3D), out (D, D), ffn_in (D, F), ffn_out (F, D)
struct WOffsets {
  size_t qkv, out, ffn_in, ffn_out, total;
  __host__ __device__ WOffsets(int D, int F)
      : qkv(0), out((size_t)3 * D * D), ffn_in((size_t)4 * D * D),
        ffn_out((size_t)4 * D * D + (size_t)D * F), total((size_t)4 * D * D + (size_t)2 * D * F) {}
};

// offsets of the per-sequence column sums in a row of BwdParams::partial
struct VecOffsets {
  int qkv_b, out_b, ffn_in_b, ffn_out_b, ln1_s, ln1_b, ln2_s, ln2_b, total;
  __host__ __device__ explicit VecOffsets(int D, int F)
      : qkv_b(0), out_b(3 * D), ffn_in_b(4 * D), ffn_out_b(4 * D + F), ln1_s(5 * D + F),
        ln1_b(6 * D + F), ln2_s(7 * D + F), ln2_b(8 * D + F), total(9 * D + F) {}
};

// ---- tensor-core products: mma.sync m16n8k16 and its fragment loaders,
// shared with the pool InfoNCE kernels (common.cuh)

using bf16 = __nv_bfloat16;
using xrt::col_pair;
using xrt::mma_bf16;
using xrt::row_pair;

// rows [0, S) x columns [0, K) of a bf16 matrix (leading dimension
// in_ld) into shared memory with leading dimension K + 8 (fragment loads
// then fall on distinct banks), 16 bytes at a time where the layout allows
__device__ void stage_rows(const bf16* in, int in_ld, int S, int K, bf16* dst) {
  const int ld = K + 8;
  if (K % 8 == 0 && in_ld % 8 == 0 && (reinterpret_cast<uintptr_t>(in) & 15) == 0) {
    const int per_row = K / 8;
    for (int i = threadIdx.x; i < S * per_row; i += blockDim.x) {
      const int r = i / per_row, c = (i % per_row) * 8;
      *reinterpret_cast<uint4*>(dst + r * ld + c) =
          *reinterpret_cast<const uint4*>(in + (size_t)r * in_ld + c);
    }
  } else {
    for (int i = threadIdx.x; i < S * K; i += blockDim.x)
      dst[(i / K) * ld + i % K] = in[(size_t)(i / K) * in_ld + i % K];
  }
}

// The row steps of the bf16 pass 1 hold a row's D <= 32 kRowJ columns in
// registers, kRowJ a lane (every load of the row in flight at once); wider
// rows take the same sums in the same order from memory.
constexpr int kRowJ = 12;

// h = T(a + b) over one row of D (written over a), by one warp: its
// two-pass f32 LayerNorm statistics, returned as (mean, rstd), and with
// out T(LN(h)) into out
__device__ float2 add_ln_row(bf16* __restrict__ a, const bf16* __restrict__ b,
                             const float* __restrict__ gamma, const float* __restrict__ beta,
                             int D, float eps, bf16* __restrict__ out) {
  using A = xrt::Act<bf16>;
  const int lane = threadIdx.x & 31;
  float sum = 0.f, sq = 0.f, mean, rstd;
  if (D <= 32 * kRowJ) {
    float h[kRowJ];
#pragma unroll
    for (int j = 0; j < kRowJ; ++j) {
      const int c = lane + 32 * j;
      h[j] = c < D ? A::round(A::load(a[c]) + A::load(b[c])) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kRowJ; ++j) {
      const int c = lane + 32 * j;
      if (c < D) {
        a[c] = A::store(h[j]);
        sum += h[j];
      }
    }
    mean = xrt::warp_sum(sum) / (float)D;
#pragma unroll
    for (int j = 0; j < kRowJ; ++j)
      if (lane + 32 * j < D) sq += (h[j] - mean) * (h[j] - mean);
    rstd = 1.f / sqrtf(xrt::warp_sum(sq) / (float)D + eps);
    if (out != nullptr) {
#pragma unroll
      for (int j = 0; j < kRowJ; ++j) {
        const int c = lane + 32 * j;
        if (c < D) out[c] = A::store((h[j] - mean) * rstd * __ldg(gamma + c) + __ldg(beta + c));
      }
    }
    return make_float2(mean, rstd);
  }
  for (int c = lane; c < D; c += 32) {
    const float h = A::round(A::load(a[c]) + A::load(b[c]));
    a[c] = A::store(h);
    sum += h;
  }
  mean = xrt::warp_sum(sum) / (float)D;
  for (int c = lane; c < D; c += 32) {
    const float h = A::load(a[c]);
    sq += (h - mean) * (h - mean);
  }
  rstd = 1.f / sqrtf(xrt::warp_sum(sq) / (float)D + eps);
  if (out != nullptr)
    for (int c = lane; c < D; c += 32)
      out[c] = A::store((A::load(a[c]) - mean) * rstd * __ldg(gamma + c) + __ldg(beta + c));
  return make_float2(mean, rstd);
}

// the dropout VJP at a hidden site, recomputed from the undropped f32
// cotangent: where the hash kept (row, c), d / keep_div, else 0
__device__ __forceinline__ float hidden_drop_bwd(float d, int drop, uint32_t row, int c, int D,
                                                 uint32_t seed, uint32_t thr, float keep_div) {
  if (!drop) return d;
  return xrt::keep(row * (uint32_t)D + (uint32_t)c, seed, thr) ? d / keep_div : 0.f;
}

// the LayerNorm VJP of ops/fused_layer.py:_ln_bwd over one row of D, by one
// warp: dh = rstd * (g - mean(g) - n * mean(g * n)), g = dy * scale,
// n = (h - mean) * rstd; dh goes to dres (which may be dy), then
// dm = T(dropout'(dh)) at the global row ``row``; with red, the row's terms
// of the scale's, the bias's and the dropped cotangent's column sums (dy n,
// dy, dropout'(dh)) added to red[c], red[D + c], red[2 D + c]
template <typename DyT>
__device__ void ln_bwd_row(const DyT* dy, const bf16* __restrict__ h, float2 stat,
                           const float* __restrict__ scale, int D, float* dres,
                           bf16* __restrict__ dm, uint32_t row, int drop, uint32_t seed,
                           uint32_t thr, float keep_div, float* __restrict__ red) {
  using A = xrt::Act<bf16>;
  const int lane = threadIdx.x & 31;
  const float mean = stat.x, rstd = stat.y;
  float sg = 0.f, sgn = 0.f;
  if (D <= 32 * kRowJ) {
    float n[kRowJ], d[kRowJ];
#pragma unroll
    for (int j = 0; j < kRowJ; ++j) {
      const int c = lane + 32 * j;
      n[j] = c < D ? (A::load(h[c]) - mean) * rstd : 0.f;
      d[j] = c < D ? xrt::Act<DyT>::load(dy[c]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kRowJ; ++j) {
      const int c = lane + 32 * j;
      if (c < D) {
        const float g = d[j] * __ldg(scale + c);
        sg += g;
        sgn += g * n[j];
      }
    }
    const float gm = xrt::warp_sum(sg) / (float)D;
    const float gnm = xrt::warp_sum(sgn) / (float)D;
#pragma unroll
    for (int j = 0; j < kRowJ; ++j) {
      const int c = lane + 32 * j;
      if (c < D) {
        const float dh = rstd * (d[j] * __ldg(scale + c) - gm - n[j] * gnm);
        const float df = hidden_drop_bwd(dh, drop, row, c, D, seed, thr, keep_div);
        dres[c] = dh;
        dm[c] = A::store(df);
        if (red != nullptr) {
          red[c] += d[j] * n[j];
          red[D + c] += d[j];
          red[2 * D + c] += df;
        }
      }
    }
    return;
  }
  for (int c = lane; c < D; c += 32) {
    const float n = (A::load(h[c]) - mean) * rstd;
    const float g = xrt::Act<DyT>::load(dy[c]) * __ldg(scale + c);
    sg += g;
    sgn += g * n;
  }
  const float gm = xrt::warp_sum(sg) / (float)D;
  const float gnm = xrt::warp_sum(sgn) / (float)D;
  for (int c = lane; c < D; c += 32) {
    const float n = (A::load(h[c]) - mean) * rstd;
    const float dv = xrt::Act<DyT>::load(dy[c]);
    const float dh = rstd * (dv * __ldg(scale + c) - gm - n * gnm);
    const float df = hidden_drop_bwd(dh, drop, row, c, D, seed, thr, keep_div);
    dres[c] = dh;
    dm[c] = A::store(df);
    if (red != nullptr) {
      red[c] += dv * n;
      red[D + c] += dv;
      red[2 * D + c] += df;
    }
  }
}

// LN2 and its VJP over one row of D, by one warp, from one load of f, x1
// and dy: h = T(f + x1) (written over f) and its statistics (returned);
// with y the recomputed T(LN2(h)) into y (the section variant), else the
// VJP as ln_bwd_row (and with red its column sums' terms)
__device__ float2 ln2_row(bf16* __restrict__ f, const bf16* __restrict__ x1,
                          const bf16* __restrict__ dy, const float* __restrict__ gamma,
                          const float* __restrict__ beta, int D, float eps, bf16* __restrict__ y,
                          float* __restrict__ dres, bf16* __restrict__ dm, uint32_t row, int drop,
                          uint32_t seed, uint32_t thr, float keep_div, float* __restrict__ red) {
  using A = xrt::Act<bf16>;
  if (D > 32 * kRowJ) {
    const float2 st = add_ln_row(f, x1, gamma, beta, D, eps, y);
    if (y == nullptr)
      ln_bwd_row<bf16>(dy, f, st, gamma, D, dres, dm, row, drop, seed, thr, keep_div, red);
    return st;
  }
  const int lane = threadIdx.x & 31;
  float h[kRowJ], d[kRowJ];
#pragma unroll
  for (int j = 0; j < kRowJ; ++j) {
    const int c = lane + 32 * j;
    h[j] = c < D ? A::round(A::load(f[c]) + A::load(x1[c])) : 0.f;
    d[j] = c < D && y == nullptr ? A::load(dy[c]) : 0.f;
  }
  float sum = 0.f, sq = 0.f;
#pragma unroll
  for (int j = 0; j < kRowJ; ++j) {
    const int c = lane + 32 * j;
    if (c < D) {
      f[c] = A::store(h[j]);
      sum += h[j];
    }
  }
  const float mean = xrt::warp_sum(sum) / (float)D;
#pragma unroll
  for (int j = 0; j < kRowJ; ++j)
    if (lane + 32 * j < D) sq += (h[j] - mean) * (h[j] - mean);
  const float rstd = 1.f / sqrtf(xrt::warp_sum(sq) / (float)D + eps);
  if (y != nullptr) {
#pragma unroll
    for (int j = 0; j < kRowJ; ++j) {
      const int c = lane + 32 * j;
      if (c < D) y[c] = A::store((h[j] - mean) * rstd * __ldg(gamma + c) + __ldg(beta + c));
    }
    return make_float2(mean, rstd);
  }
  float sg = 0.f, sgn = 0.f;
#pragma unroll
  for (int j = 0; j < kRowJ; ++j) {
    const int c = lane + 32 * j;
    if (c < D) {
      h[j] = (h[j] - mean) * rstd;  // n
      const float g = d[j] * __ldg(gamma + c);
      sg += g;
      sgn += g * h[j];
    }
  }
  const float gm = xrt::warp_sum(sg) / (float)D;
  const float gnm = xrt::warp_sum(sgn) / (float)D;
#pragma unroll
  for (int j = 0; j < kRowJ; ++j) {
    const int c = lane + 32 * j;
    if (c < D) {
      const float dh = rstd * (d[j] * __ldg(gamma + c) - gm - h[j] * gnm);
      const float df = hidden_drop_bwd(dh, drop, row, c, D, seed, thr, keep_div);
      dres[c] = dh;
      dm[c] = A::store(df);
      if (red != nullptr) {
        red[c] += d[j] * h[j];
        red[D + c] += d[j];
        red[2 * D + c] += df;
      }
    }
  }
  return make_float2(mean, rstd);
}

// The bf16 pass 1's shared memory (ops/fused_layer.py bwd_tc_smem_bytes
// mirrors it), for a CTA of ``seqs`` sequences, or of a cluster of C CTAs
// that split one sequence (the CTA's H / C heads): the key mask of
// the CTA's rows, then one of two uses at a time:
//   - a product's operand, round_up(seqs S, 16) rows (ldmatrix reads whole
//     m-tiles) of the widest K, max(3D, F) + 8 bf16 (dqm in dx's product);
//   - the row steps' column sums, 3 D f32 a warp;
//   - one sequence's attention: its rows of the CTA's heads' q|k|v (3 hc +
//     8, with hc = H / C round_up(D / H, 16): each head's columns padded to
//     whole k-steps) and gw (hc + 8), then for hg heads T(dropped) and
//     T(d_scores) (Sp x (Sp + 8) each), bf16, with Sp = round_up(S, 16)
//     rows, zero past S (whole 16 x 16 blocks for ldmatrix)
struct BwdTcLayout {
  size_t ops, gw, heads, total;
  __host__ __device__ BwdTcLayout(int S, int D, int H, int F, int seqs, int C, int hg) {
    const int hc = H / C * round_up(D / H, 16), sp = round_up(S, 16);
    ops = (size_t)round_up(seqs * S, 4) * sizeof(int);
    size_t product =
        (size_t)round_up(seqs * S, 16) * ((3 * D > F ? 3 * D : F) + 8) * sizeof(bf16);
    const size_t sums = (size_t)(kBwdTcThreads / 32) * 3 * D * sizeof(float);
    if (sums > product) product = sums;
    gw = ops + (size_t)sp * (3 * hc + 8) * sizeof(bf16);
    heads = gw + (size_t)sp * (hc + 8) * sizeof(bf16);
    const size_t attention = heads + (size_t)hg * 2 * sp * (sp + 8) * sizeof(bf16);
    total = ops + product > attention ? ops + product : attention;
  }
};

// The bias and LayerNorm gradient i (of VecOffsets::total): the per-sequence
// column sums added over the sequences in order
__device__ __forceinline__ void vector_grad(const BwdParams& p, int i) {
  const VecOffsets off(p.D, p.F);
  float s = 0.f;
#pragma unroll 16
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

// ---- bf16: passes 2 and 3 around pass 1 on the tensor cores (pass 0 packs
// the weights: pack_weights_kernel, below)

constexpr int kWgTile = 64;   // pass 2: a kWgTile x kWgTile tile of dW per block
constexpr int kWgRows = 32;   // f32: rows staged per step
constexpr int kWgChunk = 64;  // bf16: rows staged per step, four mma k-steps
constexpr int kWgLd = kWgTile + 8;  // a staged bf16 row: conflict-free ldmatrix

__host__ __device__ inline int wg_tiles(int K, int N) {
  return ((K + kWgTile - 1) / kWgTile) * ((N + kWgTile - 1) / kWgTile);
}

// Pass 2: dW = X^T Y for the four weights as a split-K product on the
// tensor cores.  Block (t, s) owns tile t of the four products' tiles and
// rows [s * rows_per_split, (s + 1) * rows_per_split).  It stages 64 rows of
// X's and Y's tile columns at a time as they lie in the workspace (a row of
// 64 columns) by 16-byte cp.async, double-buffered; four warps each take 16
// rows (k) of the tile across its 64 columns (n), the A fragments (of X^T)
// and the B fragments (of Y) by ldmatrix.trans, so nothing is transposed on
// the way in.  The partial tile goes to wpart[s] (no atomics).
__global__ void __launch_bounds__(128) weight_grad_mma_kernel(BwdParams p) {
  __shared__ __align__(16) bf16 sx[2][kWgChunk][kWgLd];  // X(r, k0 + c)
  __shared__ __align__(16) bf16 sy[2][kWgChunk][kWgLd];  // Y(r, n0 + c)
  const WOffsets w(p.D, p.F);
  const int D = p.D, F = p.F, R = p.B * p.S;
  int t = blockIdx.x, K = 0, N = 0;
  const bf16 *X = nullptr, *Y = nullptr;
  size_t base = 0;
  for (int prod = 0; prod < 4; ++prod) {
    switch (prod) {
      case 0: X = static_cast<const bf16*>(p.x); Y = static_cast<const bf16*>(p.dqm); K = D; N = 3 * D; base = w.qkv; break;
      case 1: X = static_cast<const bf16*>(p.ctx); Y = static_cast<const bf16*>(p.dam); K = D; N = D; base = w.out; break;
      case 2: X = static_cast<const bf16*>(p.x1); Y = static_cast<const bf16*>(p.dum); K = D; N = F; base = w.ffn_in; break;
      default: X = static_cast<const bf16*>(p.g); Y = static_cast<const bf16*>(p.dfm); K = F; N = D; base = w.ffn_out; break;
    }
    if (t < wg_tiles(K, N)) break;
    t -= wg_tiles(K, N);
  }
  const int tn = (N + kWgTile - 1) / kWgTile;
  const int k0 = (t / tn) * kWgTile, n0 = (t % tn) * kWgTile;
  const int r_begin = blockIdx.y * p.rows_per_split;
  const int r_end = min(R, r_begin + p.rows_per_split);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t2 = (lane & 3) * 2;
  constexpr int kPieces = kWgChunk * (kWgTile / 8);  // 16-byte pieces of a staged matrix
  // rows [r0, r0 + 64) of X's and Y's tile columns into buffer buf (zero
  // past the split's rows and the matrices' columns: D, F are multiples of 16)
  auto stage = [&](int r0, int buf) {
    for (int i = tid; i < 2 * kPieces; i += 128) {
      const bool y = i >= kPieces;
      const int rr = (i % kPieces) / (kWgTile / 8), c = (i % (kWgTile / 8)) * 8, r = r0 + rr;
      const int c0 = y ? n0 : k0, cols = y ? N : K;
      const bf16* src = y ? Y : X;
      const bool in = r < r_end && c0 + c < cols;
      xrt::cp_async16(y ? &sy[buf][rr][c] : &sx[buf][rr][c],
                      in ? src + (size_t)r * cols + c0 + c : src, in);
    }
  };
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  const int chunks = (r_end - r_begin + kWgChunk - 1) / kWgChunk;
  stage(r_begin, 0);
  xrt::cp_async_commit();
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks) stage(r_begin + (ch + 1) * kWgChunk, (ch + 1) & 1);
    xrt::cp_async_commit();
    xrt::cp_async_wait<1>();
    __syncthreads();
    const int buf = ch & 1;
#pragma unroll
    for (int ks = 0; ks < kWgChunk; ks += 16) {
      // A(m, kk) = X(kk, k0 + m): the transposed 8 x 8 blocks of the staged
      // rows, in the fragment's order (rows 0-7, 8-15 of m, then k + 8)
      uint32_t x4[4];
      xrt::ldmatrix_x4_trans(x4, &sx[buf][ks][warp * 16], kWgLd);
      const uint32_t a[4] = {x4[0], x4[2], x4[1], x4[3]};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t y4[4];
        xrt::ldmatrix_x4_trans(y4, &sy[buf][ks][j * 16], kWgLd);
        const uint32_t b0[2] = {y4[0], y4[1]}, b1[2] = {y4[2], y4[3]};
        mma_bf16(acc[2 * j], a, b0);
        mma_bf16(acc[2 * j + 1], a, b1);
      }
    }
    __syncthreads();
  }
  float* out = p.wpart + (size_t)blockIdx.y * w.total + base;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + warp * 16 + g + (i >= 2 ? 8 : 0), n = n0 + j * 8 + t2 + (i & 1);
      if (k < K && n < N) out[(size_t)k * N + n] = acc[j][i];
    }
}

// Pass 3 (bf16 and f32): each weight gradient the sum of its partial tiles
// in split order, then the bias and LayerNorm gradients
__global__ void grad_reduce_kernel(BwdParams p) {
  const WOffsets w(p.D, p.F);
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= w.total) {
    if (i - w.total < (size_t)VecOffsets(p.D, p.F).total) vector_grad(p, (int)(i - w.total));
    return;
  }
  float s = 0.f;
#pragma unroll 8
  for (int sp = 0; sp < p.splits; ++sp) s += p.wpart[(size_t)sp * w.total + i];
  float* dst = i < w.out      ? p.d_qkv_w + i
               : i < w.ffn_in ? p.d_out_w + (i - w.out)
               : i < w.ffn_out ? p.d_ffn_in_w + (i - w.ffn_in)
                               : p.d_ffn_out_w + (i - w.ffn_out);
  *dst = s;
}

// Pass 2 (f32): dW = X^T Y for the four weights as a split-K product on the
// CUDA cores, over the tiles and row splits of weight_grad_mma_kernel.
// Block (t, s) stages 32 rows of X's and Y's tile columns at a time by
// 16-byte cp.async, double-buffered; each thread sums a 4 x 4 register tile
// (four k, four n, from 16-byte shared loads) over the rows in order, and
// the partial tile goes to wpart[s] (no atomics).
__global__ void __launch_bounds__(256) weight_grad_f32_kernel(BwdParams p) {
  __shared__ __align__(16) float sx[2][kWgRows][kWgTile];  // X(r, k0 + c)
  __shared__ __align__(16) float sy[2][kWgRows][kWgTile];  // Y(r, n0 + c)
  const WOffsets w(p.D, p.F);
  const int D = p.D, F = p.F, R = p.B * p.S;
  int t = blockIdx.x, K = 0, N = 0;
  const float *X = nullptr, *Y = nullptr;
  size_t base = 0;
  for (int prod = 0; prod < 4; ++prod) {
    switch (prod) {
      case 0: X = static_cast<const float*>(p.x); Y = static_cast<const float*>(p.dqm); K = D; N = 3 * D; base = w.qkv; break;
      case 1: X = static_cast<const float*>(p.ctx); Y = static_cast<const float*>(p.dam); K = D; N = D; base = w.out; break;
      case 2: X = static_cast<const float*>(p.x1); Y = static_cast<const float*>(p.dum); K = D; N = F; base = w.ffn_in; break;
      default: X = static_cast<const float*>(p.g); Y = static_cast<const float*>(p.dfm); K = F; N = D; base = w.ffn_out; break;
    }
    if (t < wg_tiles(K, N)) break;
    t -= wg_tiles(K, N);
  }
  const int tn = (N + kWgTile - 1) / kWgTile;
  const int k0 = (t / tn) * kWgTile, n0 = (t % tn) * kWgTile;
  const int r_begin = blockIdx.y * p.rows_per_split;
  const int r_end = min(R, r_begin + p.rows_per_split);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  constexpr int kQuads = kWgRows * (kWgTile / 4);  // 16-byte pieces of a staged matrix
  auto stage = [&](int r0, int buf) {
    for (int i = tid; i < 2 * kQuads; i += 256) {
      const bool y = i >= kQuads;
      const int rr = (i % kQuads) / (kWgTile / 4), c = (i % (kWgTile / 4)) * 4, r = r0 + rr;
      const int c0 = y ? n0 : k0, cols = y ? N : K;
      const float* src = y ? Y : X;
      const bool in = r < r_end && c0 + c < cols;
      xrt::cp_async16(y ? &sy[buf][rr][c] : &sx[buf][rr][c],
                      in ? src + (size_t)r * cols + c0 + c : src, in);
    }
  };
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i / 4][i % 4] = 0.f;
  const int chunks = (r_end - r_begin + kWgRows - 1) / kWgRows;
  stage(r_begin, 0);
  xrt::cp_async_commit();
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks) stage(r_begin + (ch + 1) * kWgRows, (ch + 1) & 1);
    xrt::cp_async_commit();
    xrt::cp_async_wait<1>();
    __syncthreads();
    const int rows = min(kWgRows, r_end - r_begin - ch * kWgRows);
#pragma unroll 4
    for (int rr = 0; rr < rows; ++rr) {
      const float4 a = *reinterpret_cast<const float4*>(&sx[ch & 1][rr][4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&sy[ch & 1][rr][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = p.wpart + (size_t)blockIdx.y * w.total + base;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + 4 * ty + i, n = n0 + 4 * tx + j;
      if (k < K && n < N) out[(size_t)k * N + n] = acc[i][j];
    }
}

// ---------------------------------------------------------------------------
// the bf16 forward on the tensor cores (see the top of this file)
// ---------------------------------------------------------------------------

constexpr int kMaxCluster = 4;

constexpr int kTcThreads = 384;  // 12 warps: the bf16 forward is latency-bound

// byte offsets of the bf16 forward's shared memory: sx at 0, then ctx, hb
// and big (qkv, then g), each of round_up(S, 16) rows (ldmatrix reads
// whole m-tiles; rows past S only feed outputs that are dropped), then the
// key mask; total bytes.  ops/fused_layer.py:smem_bytes mirrors it.
struct TcLayout {
  size_t ctx, hb, big, mask, total;
  __host__ __device__ TcLayout(int S, int D, int F) {
    const int sp = round_up(S, 16);
    const size_t rows = (size_t)sp * (D + 8) * sizeof(bf16);
    const int wb = (3 * D > F ? 3 * D : F) + 8;
    ctx = rows;
    hb = 2 * rows;
    big = 3 * rows;
    mask = big + (size_t)sp * wb * sizeof(bf16);
    total = mask + (size_t)S * sizeof(int);
  }
};

// a buffer of every CTA of the cluster: put2() writes two adjacent bf16
// values, put() one f32 value, into each copy (distributed shared memory;
// the CTA's own copy with a cluster of 1)
template <typename T>
struct Copies {
  T* at[kMaxCluster];
  int n;
  __device__ Copies(T* local, int cluster) : n(cluster) {
    for (int r = 0; r < kMaxCluster; ++r)
      at[r] = r < cluster ? (cluster > 1 ? cg::this_cluster().map_shared_rank(local, r) : local)
                          : local;
  }
  // elements off and off + 1 (off even)
  __device__ __forceinline__ void put2(int off, float v0, float v1) const {
    const uint32_t w = xrt::pack_bf16(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < n) *reinterpret_cast<uint32_t*>(at[r] + off) = w;
  }
  __device__ __forceinline__ void put(int off, float v) const {
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < n) at[r][off] = v;
  }
};

// epi(r, n, v0, v1) with v0, v1 = sum_k a[r, k] W[k, n (+ 1)], for rows
// r < S and even n in the 8-column blocks [blk0, blk1) of each of
// ``parts`` parts, part i starting at block i * part_blocks (qkv: its q, k
// and v thirds).  a (leading dimension lda, a multiple of 8) in shared
// memory, its A fragments by ldmatrix; Wp the weight packed in fragment
// order (pack_weights_kernel), so a warp's B fragments of one k-step are
// one coalesced 8-byte load a lane.  A warp item is two column blocks, or
// one where that leaves warps idle, or one block of one m-tile where even
// that does; its B fragments come four k-steps ahead.  Each output's sum
// runs over the k-steps in order inside one warp, whatever the item.  With
// pre (dense_tc_in), pre(r, n) loads what epi(r, n, v0, v1, in) takes of
// each of the item's output pairs before any epi stores, so those loads are
// in flight together.
template <typename Pre, typename Epi>
__device__ void dense_tc_in(const bf16* a, int lda, int K, const uint2* __restrict__ Wp, int S,
                            int parts, int part_blocks, int blk0, int blk1, Pre pre, Epi epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int g = lane >> 2, t2 = (lane & 3) * 2, nks = K / 16, mtiles = (S + 15) / 16;
  const int nb = blk1 - blk0;
  const int width = parts * ((nb + 1) / 2) >= nwarps ? 2 : 1;
  const int mg = width == 1 && parts * nb < nwarps ? mtiles : 1;  // m-tile groups
  const int groups = (nb + width - 1) / width;
  for (int item = warp; item < parts * groups * mg; item += nwarps) {
    const int mi = item % mg, rest = item / mg;
    const int b0 = blk0 + width * (rest % groups), part = rest / groups;
    const bool two = width == 2 && b0 + 1 < blk1;
    const int mt0 = mg > 1 ? mi : 0, mt1 = mg > 1 ? mi + 1 : mtiles;
    const int cb = part * part_blocks + b0;
    const uint2* w0 = Wp + (size_t)cb * nks * 32 + lane;
    const uint2* w1 = w0 + (size_t)nks * 32;
    float acc[4][2][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i / 8][(i / 4) % 2][i % 4] = 0.f;
    for (int ks0 = 0; ks0 < nks; ks0 += 4) {
      uint2 b[4][2];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int ks = ks0 + s;
        const uint2 zero = make_uint2(0u, 0u);
        b[s][0] = ks < nks ? __ldg(w0 + ks * 32) : zero;
        b[s][1] = ks < nks && two ? __ldg(w1 + ks * 32) : zero;
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int ks = ks0 + s;
        if (ks < nks) {
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            if (mt >= mt0 && mt < mt1) {
              uint32_t af[4];
              xrt::ldmatrix_x4(af, a + 16 * mt * lda + 16 * ks, lda);
              const uint32_t bf0[2] = {b[s][0].x, b[s][0].y}, bf1[2] = {b[s][1].x, b[s][1].y};
              mma_bf16(acc[mt][0], af, bf0);
              if (two) mma_bf16(acc[mt][1], af, bf1);
            }
          }
        }
      }
    }
    float2 in[4][2][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * mt + g + 8 * h;
          in[mt][j][h] = mt >= mt0 && mt < mt1 && (j == 0 || two) && r < S
                             ? pre(r, 8 * (cb + j) + t2)
                             : make_float2(0.f, 0.f);
        }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      if (mt >= mt0 && mt < mt1) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (j == 0 || two) {
            const int n = 8 * (cb + j) + t2;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = 16 * mt + g + 8 * h;
              if (r < S) epi(r, n, acc[mt][j][2 * h], acc[mt][j][2 * h + 1], in[mt][j][h]);
            }
          }
        }
      }
    }
  }
}

template <typename Epi>
__device__ __forceinline__ void dense_tc(const bf16* a, int lda, int K,
                                         const uint2* __restrict__ Wp, int S, int parts,
                                         int part_blocks, int blk0, int blk1, Epi epi) {
  dense_tc_in(a, lda, K, Wp, S, parts, part_blocks, blk0, blk1,
              [](int, int) { return make_float2(0.f, 0.f); },
              [&](int r, int n, float v0, float v1, float2) { epi(r, n, v0, v1); });
}

// The attention of heads [h0, h1) for the S rows of sequence b, qkv in
// ``big`` (leading dimension lbig), ctx into every copy: a warp per (head,
// 16-row m-tile).  The scores stay in the mma accumulators (the query rows
// as A, the key rows as B, k-steps of 16 over dh in order), the softmax
// runs across the quad of lanes that holds a row, and the rounded,
// dropped probs are repacked as P V's A fragments (a C fragment of the
// scores is an A fragment of the next product); V's B fragments come from
// shared memory.  S <= 64 and dh <= 64: at most 8 column tiles each.
__device__ __forceinline__ void attention_tc(const Params& p, uint32_t attn_seed, int b, int h0,
                                             int h1, const bf16* big, int lbig, const int* smask,
                                             const Copies<bf16>& ctx_all, int ldx) {
  const int S = p.S, D = p.D, H = p.H, dh = D / H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int mtiles = (S + 15) / 16, ntn = (S + 7) / 8, nkh = (dh + 15) / 16, ntd = (dh + 7) / 8;
  const float scale = 1.f / sqrtf((float)dh);
  const float neg_inf = -__int_as_float(0x7f800000);
  for (int item = warp; item < (h1 - h0) * mtiles; item += nwarps) {
    const int h = h0 + item / mtiles, mt = item % mtiles;
    const bf16* q = big + h * dh;
    const bf16* k = q + D;
    const bf16* v = q + 2 * D;
    const int r0 = 16 * mt + g, r1 = r0 + 8;
    // scores x[j][.]: rows r0 (0, 1) and r1 (2, 3), columns 8 j + t2 (+ 1)
    float x[8][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i / 4][i % 4] = 0.f;
    for (int ks = 0; ks < nkh; ++ks) {
      const int kc = 16 * ks + t2;
      const uint32_t af[4] = {row_pair(q, lbig, r0, kc, S, dh), row_pair(q, lbig, r1, kc, S, dh),
                              row_pair(q, lbig, r0, kc + 8, S, dh),
                              row_pair(q, lbig, r1, kc + 8, S, dh)};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < ntn) {
          const uint32_t bf[2] = {row_pair(k, lbig, 8 * j + g, kc, S, dh),
                                  row_pair(k, lbig, 8 * j + g, kc + 8, S, dh)};
          mma_bf16(x[j], af, bf);
        }
      }
    }
    // scores plus the key-padding and causal bias; columns past S out
    float m[2] = {neg_inf, neg_inf};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < ntn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = 8 * j + t2 + (e & 1), sq = e < 2 ? r0 : r1;
          if (t < S) {
            const float bias = (smask[t] ? 0.f : kNegInf) + ((p.causal && t > sq) ? kNegInf : 0.f);
            x[j][e] = x[j][e] * scale + bias;
            m[e >> 1] = fmaxf(m[e >> 1], x[j][e]);
          }
        }
      }
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      m[hf] = fmaxf(m[hf], __shfl_xor_sync(0xffffffffu, m[hf], 1));
      m[hf] = fmaxf(m[hf], __shfl_xor_sync(0xffffffffu, m[hf], 2));
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < ntn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = 8 * j + t2 + (e & 1);
          x[j][e] = t < S ? expf(x[j][e] - m[e >> 1]) : 0.f;
          sum[e >> 1] += x[j][e];
        }
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      sum[hf] += __shfl_xor_sync(0xffffffffu, sum[hf], 1);
      sum[hf] += __shfl_xor_sync(0xffffffffu, sum[hf], 2);
    }
    // probs divided, dropped, rounded (zero past S and in rows past S)
    const uint32_t base = ((uint32_t)b * H + (uint32_t)h) * (uint32_t)(S * S);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < ntn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = 8 * j + t2 + (e & 1), sq = e < 2 ? r0 : r1;
          float pv = x[j][e] / sum[e >> 1];
          if (p.attn_drop)
            pv = xrt::keep(base + (uint32_t)(sq * S + t), attn_seed, p.attn_thr) ? pv / p.attn_keep
                                                                                   : 0.f;
          x[j][e] = t < S && sq < S ? xrt::Act<bf16>::round(pv) : 0.f;
        }
      }
    }
    // ctx = P V over the keys in k-steps of 16, in order
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      if (jn < ntd) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (2 * kk < ntn) {
            const bool hi = 2 * kk + 1 < ntn;
            auto pair = [&](int j, int e) {
              return xrt::pack_bf16(__float2bfloat16_rn(x[j][e]), __float2bfloat16_rn(x[j][e + 1]));
            };
            const uint32_t af[4] = {pair(2 * kk, 0), pair(2 * kk, 2),
                                    hi ? pair(2 * kk + 1, 0) : 0u, hi ? pair(2 * kk + 1, 2) : 0u};
            const int kt = 16 * kk + t2;
            const uint32_t bf[2] = {col_pair(v, lbig, kt, 8 * jn + g, S, dh),
                                    col_pair(v, lbig, kt + 8, 8 * jn + g, S, dh)};
            mma_bf16(acc, af, bf);
          }
        }
        const int c = 8 * jn + t2;
        if (c < dh) {  // dh even: c + 1 < dh too
          if (r0 < S) ctx_all.put2(r0 * ldx + h * dh + c, acc[0], acc[1]);
          if (r1 < S) ctx_all.put2(r1 * ldx + h * dh + c, acc[2], acc[3]);
        }
      }
    }
  }
}

// The layer for one sequence, split across the p.cluster CTAs of a
// cluster (blockIdx.x / cluster is the sequence).  CTA ``rank`` computes
// the qkv columns of heads [rank H / C, (rank + 1) H / C) (q, k and v: it
// alone reads them), those heads' attention, and the rank-th share of the
// 8-column blocks of the other products; ctx, hb and g go to every CTA's
// copy.
template <int kStop>
__global__ void __launch_bounds__(kTcThreads, 1)
    fused_layer_fwd_tc_kernel(Params p, const uint2* __restrict__ wp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = p.S, D = p.D, H = p.H, F = p.F, C = p.cluster;
  const uint32_t seed[3] = {p.seed[0], p.seed[1], p.seed[2]};  // read once, into registers
  const int ldx = D + 8, lbig = (3 * D > F ? 3 * D : F) + 8;
  const int rank = C > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int b = blockIdx.x / C;
  const TcLayout L(S, D, F);
  bf16* sx = reinterpret_cast<bf16*>(smem);
  bf16* ctx = reinterpret_cast<bf16*>(smem + L.ctx);
  bf16* hb = reinterpret_cast<bf16*>(smem + L.hb);
  bf16* big = reinterpret_cast<bf16*>(smem + L.big);
  int* smask = reinterpret_cast<int*>(smem + L.mask);
  // every CTA of the cluster has started (so its shared memory may be
  // written) and this CTA's loads are done
  auto cluster_sync = [&]() {
    if (C > 1) cg::this_cluster().sync();
    else __syncthreads();
  };
  const Copies<bf16> ctx_all(ctx, C), hb_all(hb, C), big_all(big, C);
  // the packed weights (uint2 units; WOffsets counts bf16)
  const WOffsets woff(D, F);
  const uint2* wqkv = wp + woff.qkv / 4;
  const uint2* wout = wp + woff.out / 4;
  const uint2* wffn_in = wp + woff.ffn_in / 4;
  const uint2* wffn_out = wp + woff.ffn_out / 4;
  bf16* yg = static_cast<bf16*>(p.y) + (size_t)b * S * D;

  stage_rows(static_cast<const bf16*>(p.x) + (size_t)b * S * D, D, S, D, sx);
  for (int i = threadIdx.x; i < S; i += blockDim.x) smask[i] = p.mask[b * S + i] != 0;
  cluster_sync();

  // qkv: this CTA's heads' columns of q, k and v, kept local
  const int hpc = H / C, cols = D / C;
  const float* qkv_b = p.qkv_b;
  dense_tc(sx, ldx, D, wqkv, S, 3, D / 8, rank * cols / 8, (rank + 1) * cols / 8,
           [=](int r, int n, float v0, float v1) {
             *reinterpret_cast<uint32_t*>(big + r * lbig + n) = xrt::pack_bf16(
                 __float2bfloat16_rn(v0 + __ldg(qkv_b + n)),
                 __float2bfloat16_rn(v1 + __ldg(qkv_b + n + 1)));
           });
  __syncthreads();
  if constexpr (kStop == kStopQkv) {
    store_rows(big, lbig, S, D, rank * cols, (rank + 1) * cols, 0, 1, yg);
    return;
  }

  // attention of this CTA's heads
  attention_tc(p, seed[0], b, rank * hpc, (rank + 1) * hpc, big, lbig, smask, ctx_all, ldx);
  cluster_sync();
  if constexpr (kStop == kStopAttn) {
    store_rows(ctx, ldx, S, D, 0, D, rank, C, yg);
    return;
  }

  // a = dropout(T(ctx Wout + b)) into hb, then x1 = T(LN1(T(x + a)))
  const uint32_t row0 = (uint32_t)b * S;
  const int nbd = D / 8, nbf = F / 8;
  const int hidden_drop = p.hidden_drop;
  const uint32_t hidden_thr = p.hidden_thr;
  const float hidden_keep = p.hidden_keep;
  auto dropout_into = [=](const Copies<bf16>& dst, const float* bias, uint32_t seed) {
    return [=](int r, int n, float v0, float v1) {
      float v[2] = {v0, v1};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        v[i] = xrt::Act<bf16>::round(v[i] + __ldg(bias + n + i));
        if (hidden_drop) {
          const uint32_t idx = (row0 + (uint32_t)r) * (uint32_t)D + (uint32_t)(n + i);
          v[i] = xrt::keep(idx, seed, hidden_thr) ? xrt::Act<bf16>::round(v[i] / hidden_keep)
                                                  : 0.f;
        }
      }
      dst.put2(r * ldx + n, v[0], v[1]);
    };
  };
  dense_tc(ctx, ldx, D, wout, S, 1, 0, rank * nbd / C, (rank + 1) * nbd / C,
           dropout_into(hb_all, p.out_b, seed[1]));
  cluster_sync();
  add_layer_norm<bf16, bf16>(sx, ldx, hb, ldx, p.ln1_s, p.ln1_b, S, D, p.eps, sx, ldx);
  __syncthreads();
  if constexpr (kStop == kStopOutLn1) {
    store_rows(sx, ldx, S, D, 0, D, rank, C, yg);
    return;
  }

  // g = T(gelu(T(x1 Win + b))) into big
  const float* ffn_in_b = p.ffn_in_b;
  dense_tc(sx, ldx, D, wffn_in, S, 1, 0, rank * nbf / C, (rank + 1) * nbf / C,
           [&](int r, int n, float v0, float v1) {
             const float u0 = xrt::Act<bf16>::round(v0 + __ldg(ffn_in_b + n));
             const float u1 = xrt::Act<bf16>::round(v1 + __ldg(ffn_in_b + n + 1));
             big_all.put2(r * lbig + n, 0.5f * u0 * (1.f + erf_eigen(u0 * kInvSqrt2)),
                          0.5f * u1 * (1.f + erf_eigen(u1 * kInvSqrt2)));
           });
  cluster_sync();
  if constexpr (kStop == kStopFfnGelu) {
    store_rows(big, lbig, S, D, 0, D, rank, C, yg);
    return;
  }

  // f = dropout(T(g Wffn_out + b)) into hb, then y = T(LN2(T(x1 + f)))
  dense_tc(big, lbig, F, wffn_out, S, 1, 0, rank * nbd / C, (rank + 1) * nbd / C,
           dropout_into(hb_all, p.ffn_out_b, seed[2]));
  cluster_sync();
  add_layer_norm<bf16, bf16>(sx, ldx, hb, ldx, p.ln2_s, p.ln2_b, S, D, p.eps, yg, D, rank, C);
}

// ---------------------------------------------------------------------------
// pass 1 of the bf16 backward on the tensor cores
// ---------------------------------------------------------------------------

// ---- pass 1's attention on the tensor cores, a warp per (head, 16 query
// rows) with the scores in the mma accumulators and the softmax across the
// quad of lanes that holds a row (as attention_tc in the forward)

// B fragments of the two n8 tiles of rows [0, 8) and [8, 16) (b[0..1],
// b[2..3]) for one k-step of 16 columns of a matrix stored as rows n, k
// along a row (q k^T's keys, d_dropped's V), shared memory, 16-byte rows
__device__ __forceinline__ void ldmatrix_b_nk(uint32_t b[4], const bf16* m, int ld) {
  const int lane = threadIdx.x & 31, mi = lane >> 3;
  const bf16* row = m + ((lane & 7) + (mi >> 1) * 8) * ld + (mi & 1) * 8;
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(addr)
               : "memory");
}

// what pass 1's attention needs of the layer and of one sequence
struct TcAttn {
  // the sequence's S rows of the CTA's heads' q|k|v (columns 0, hc, 2 hc),
  // head hh's at hh dhp, zero past dh: dhp = round_up(dh, 16)
  const bf16* qkv;
  const bf16* gw;   // and of their gw
  const int* mask;  // its key mask
  bf16* spb;        // a stage's heads' T(dropped), S x S each
  bf16* sdsb;       // and T(d_scores)
  bf16* ctx;        // the sequence's ctx rows in the workspace (leading dimension D)
  int S, D, H, dh, dhp, hc, lq, lg, causal, drop;
  int b, hlo;  // the sequence (of B) and the CTA's first head (of H)
  float scale, keep;
  uint32_t seed, thr;
};

// the probabilities of query rows r0 = 16 mt + g and r1 = r0 + 8 of head
// hh (of the CTA's) against the keys 8 j + t2 (+ 1) into x[j][0..1] and
// x[j][2..3]: q k^T on the tensor cores (k-steps of 16 over dh in order),
// times scale plus the key-padding and causal bias, the softmax over the
// row's quad of lanes; zero at keys past S
template <int kN>
__device__ __forceinline__ void tc_probs(const TcAttn& at, int hh, int mt, float (&x)[kN][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = (lane & 3) * 2;
  const int S = at.S, ntn = (S + 7) / 8, nkh = at.dhp / 16;
  const bf16* q = at.qkv + hh * at.dhp;
  const bf16* k = q + at.hc;
  const int r0 = 16 * mt + g, r1 = r0 + 8;
  const float neg_inf = -__int_as_float(0x7f800000);
#pragma unroll
  for (int i = 0; i < 4 * kN; ++i) x[i / 4][i % 4] = 0.f;
  // fragments by ldmatrix: the rows past S and the columns past dh staged as zeros
  for (int ks = 0; ks < nkh; ++ks) {
    uint32_t af[4];
    xrt::ldmatrix_x4(af, q + 16 * mt * at.lq + 16 * ks, at.lq);
#pragma unroll
    for (int j = 0; j < kN; j += 2) {
      if (j < ntn) {
        uint32_t b4[4];
        ldmatrix_b_nk(b4, k + 8 * j * at.lq + 16 * ks, at.lq);
        const uint32_t b0[2] = {b4[0], b4[1]}, b1[2] = {b4[2], b4[3]};
        mma_bf16(x[j], af, b0);
        if (j + 1 < ntn) mma_bf16(x[j + 1], af, b1);
      }
    }
  }
  float m[2] = {neg_inf, neg_inf};
#pragma unroll
  for (int j = 0; j < kN; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = 8 * j + t2 + (e & 1), sq = e < 2 ? r0 : r1;
      if (t < S) {
        const float bias =
            (at.mask[t] ? 0.f : kNegInf) + ((at.causal && t > sq) ? kNegInf : 0.f);
        x[j][e] = x[j][e] * at.scale + bias;
        m[e >> 1] = fmaxf(m[e >> 1], x[j][e]);
      }
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    m[hf] = fmaxf(m[hf], __shfl_xor_sync(0xffffffffu, m[hf], 1));
    m[hf] = fmaxf(m[hf], __shfl_xor_sync(0xffffffffu, m[hf], 2));
  }
#pragma unroll
  for (int j = 0; j < kN; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = 8 * j + t2 + (e & 1);
      x[j][e] = t < S ? expf(x[j][e] - m[e >> 1]) : 0.f;
      sum[e >> 1] += x[j][e];
    }
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    sum[hf] += __shfl_xor_sync(0xffffffffu, sum[hf], 1);
    sum[hf] += __shfl_xor_sync(0xffffffffu, sum[hf], 2);
  }
#pragma unroll
  for (int j = 0; j < kN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = x[j][e] / sum[e >> 1];
}

// the dropped probability of (sq, t) of head hh (of the CTA's), f32
__device__ __forceinline__ float tc_dropped(const TcAttn& at, int hh, int sq, int t, float prob) {
  if (!at.drop) return prob;
  const uint32_t idx = (((uint32_t)at.b * at.H + (uint32_t)(at.hlo + hh)) * (uint32_t)at.S +
                        (uint32_t)sq) * (uint32_t)at.S + t;
  return xrt::keep(idx, at.seed, at.thr) ? prob / at.keep : 0.f;
}

// The recompute: ctx = T(T(dropped) V) of the CTA's heads, a warp per
// (head, m-tile), the rounded dropped probs repacked as P V's A fragments
// (a C fragment of the scores is an A fragment of the next product), V's B
// fragments from shared memory, ctx into the workspace
template <int kN>
__device__ __noinline__ void tc_attention(const TcAttn at_, int nh) {
  const TcAttn at = at_;  // the fields in registers
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int g = lane >> 2, t2 = (lane & 3) * 2, S = at.S, dh = at.dh;
  const int mtiles = (S + 15) / 16, ntn = (S + 7) / 8, ntd = at.dhp / 8;
  for (int item = warp; item < nh * mtiles; item += nwarps) {
    const int hh = item / mtiles, mt = item % mtiles, r0 = 16 * mt + g, r1 = r0 + 8;
    float x[kN][4];
    tc_probs<kN>(at, hh, mt, x);
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 8 * j + t2 + (e & 1), sq = e < 2 ? r0 : r1;
        x[j][e] = t < S && sq < S ? xrt::Act<bf16>::round(tc_dropped(at, hh, sq, t, x[j][e]))
                                  : 0.f;
      }
    const bf16* v = at.qkv + 2 * at.hc + hh * at.dhp;
    bf16* out = at.ctx + (at.hlo + hh) * dh;
    for (int jn = 0; jn < ntd; jn += 2) {  // 16 columns of dh at a time
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < kN / 2; ++kk) {
        if (2 * kk < ntn) {
          const bool hi = 2 * kk + 1 < ntn;
          auto pair = [&](int j, int e) {
            return xrt::pack_bf16(__float2bfloat16_rn(x[j][e]), __float2bfloat16_rn(x[j][e + 1]));
          };
          const uint32_t af[4] = {pair(2 * kk, 0), pair(2 * kk, 2),
                                  hi ? pair(2 * kk + 1, 0) : 0u, hi ? pair(2 * kk + 1, 2) : 0u};
          uint32_t b4[4];
          xrt::ldmatrix_x4_trans(b4, v + 16 * kk * at.lq + 8 * jn, at.lq);
          const uint32_t b0[2] = {b4[0], b4[1]}, b1[2] = {b4[2], b4[3]};
          mma_bf16(acc[0], af, b0);
          mma_bf16(acc[1], af, b1);
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = 8 * (jn + u) + t2;
        if (c >= dh) continue;  // the padding (dh even: c + 1 < dh too)
        if (r0 < S)
          *reinterpret_cast<uint32_t*>(out + (size_t)r0 * at.D + c) =
              xrt::pack_bf16(__float2bfloat16_rn(acc[u][0]), __float2bfloat16_rn(acc[u][1]));
        if (r1 < S)
          *reinterpret_cast<uint32_t*>(out + (size_t)r1 * at.D + c) =
              xrt::pack_bf16(__float2bfloat16_rn(acc[u][2]), __float2bfloat16_rn(acc[u][3]));
      }
    }
  }
}

// The VJP of the attention of the CTA's heads [h0, h0 + nh) up to the
// d_scores, a warp per (head, m-tile): the probs again (tc_probs), then
// d_dropped = gw V^T on the tensor cores in the same layout (gw's rows as A,
// V's as B), the dropout's VJP (the keep mask read off dropped != 0, as the
// JAX kernel does), the softmax's (the row sum of d_probs * probs over the
// quad) and T(d_scores) = T(probs (d_probs - row sum) scale); T(dropped)
// and T(d_scores) go to spb and sdsb for the products over the query rows
template <int kN>
__device__ __noinline__ void tc_attention_grad(const TcAttn at_, int h0, int nh) {
  const TcAttn at = at_;  // the fields in registers
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int g = lane >> 2, t2 = (lane & 3) * 2, S = at.S, dhp = at.dhp;
  const int mtiles = (S + 15) / 16, ntn = (S + 7) / 8, nkh = dhp / 16;
  for (int item = warp; item < nh * mtiles; item += nwarps) {
    const int hl = item / mtiles, hh = h0 + hl, mt = item % mtiles, r0 = 16 * mt + g, r1 = r0 + 8;
    float x[kN][4], dd[kN][4];
    tc_probs<kN>(at, hh, mt, x);
#pragma unroll
    for (int i = 0; i < 4 * kN; ++i) dd[i / 4][i % 4] = 0.f;
    const bf16* gr = at.gw + hh * dhp;
    const bf16* v = at.qkv + 2 * at.hc + hh * dhp;
    for (int ks = 0; ks < nkh; ++ks) {
      uint32_t af[4];
      xrt::ldmatrix_x4(af, gr + 16 * mt * at.lg + 16 * ks, at.lg);
#pragma unroll
      for (int j = 0; j < kN; j += 2) {
        if (j < ntn) {
          uint32_t b4[4];
          ldmatrix_b_nk(b4, v + 8 * j * at.lq + 16 * ks, at.lq);
          const uint32_t b0[2] = {b4[0], b4[1]}, b1[2] = {b4[2], b4[3]};
          mma_bf16(dd[j], af, b0);
          if (j + 1 < ntn) mma_bf16(dd[j + 1], af, b1);
        }
      }
    }
    const int sp = round_up(S, 16), lp = sp + 8;
    bf16* pb = at.spb + hl * sp * lp;
    bf16* ds = at.sdsb + hl * sp * lp;
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 8 * j + t2 + (e & 1), sq = e < 2 ? r0 : r1;
        if (t < S && sq < S) {
          const float d = tc_dropped(at, hh, sq, t, x[j][e]);
          pb[sq * lp + t] = __float2bfloat16_rn(d);
          if (at.drop) dd[j][e] = d != 0.f ? dd[j][e] / at.keep : 0.f;
          rs[e >> 1] += dd[j][e] * x[j][e];
        } else if (t < sp && sq < sp) {
          pb[sq * lp + t] = __float2bfloat16_rn(0.f);  // the 16 x 16 blocks' padding
        }
      }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      rs[hf] += __shfl_xor_sync(0xffffffffu, rs[hf], 1);
      rs[hf] += __shfl_xor_sync(0xffffffffu, rs[hf], 2);
    }
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 8 * j + t2 + (e & 1), sq = e < 2 ? r0 : r1;
        if (t < sp && sq < sp)
          ds[sq * lp + t] = __float2bfloat16_rn(
              t < S && sq < S ? x[j][e] * (dd[j][e] - rs[e >> 1]) * at.scale : 0.f);
      }
  }
}

// dq = T(d_scores) K, dk = T(d_scores)^T Q and dv = T(dropped)^T gw of the
// CTA's heads [h0, h0 + nh) of one sequence, a warp per (product, head, 16
// columns of dh), every operand by ldmatrix from shared memory (the
// transposed ones by ldmatrix.trans), k over the rows in steps of 16 in
// order (the padding past S zero); T(.) into rows (leading dimension ld)
// at the product's third of dqm's columns, and with bias the f32 column
// sums over the sequence's rows (each thread's rows in order, then its
// warp's 8 row groups in a fixed order) into bias at the same columns
__device__ __noinline__ void tc_attention_products(const TcAttn at_, int h0, int nh, bf16* rows,
                                                   int ld, float* bias) {
  const TcAttn at = at_;  // the fields in registers
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int g = lane >> 2, t2 = (lane & 3) * 2, S = at.S, dh = at.dh;
  const int sp = round_up(S, 16), lp = sp + 8, mtiles = sp / 16, nt = (dh + 15) / 16;
  for (int item = warp; item < 3 * nh * nt; item += nwarps) {
    const int which = item / (nh * nt), hl = (item / nt) % nh, n0 = (item % nt) * 16;
    const int col = (h0 + hl) * at.dhp, gcol = which * at.D + (at.hlo + h0 + hl) * dh;
    // A: T(d_scores) (dq: as stored; dk: transposed) or T(dropped)^T (dv);
    // B: K (dq), Q (dk), gw (dv), rows the keys or the query rows
    const bf16* am = (which == 2 ? at.spb : at.sdsb) + hl * sp * lp;
    const bf16* bm = which == 0 ? at.qkv + at.hc + col : which == 1 ? at.qkv + col : at.gw + col;
    const int ldb = which == 2 ? at.lg : at.lq;
    float cs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    for (int mt = 0; mt < mtiles; ++mt) {
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int ks = 0; ks < mtiles; ++ks) {
        uint32_t af[4], b4[4];
        if (which == 0) {
          xrt::ldmatrix_x4(af, am + 16 * mt * lp + 16 * ks, lp);
        } else {  // A(m, k) = stored(k, m): the transposed blocks in the fragment's order
          uint32_t x4[4];
          xrt::ldmatrix_x4_trans(x4, am + 16 * ks * lp + 16 * mt, lp);
          af[0] = x4[0];
          af[1] = x4[2];
          af[2] = x4[1];
          af[3] = x4[3];
        }
        xrt::ldmatrix_x4_trans(b4, bm + 16 * ks * ldb + n0, ldb);
        const uint32_t b0[2] = {b4[0], b4[1]}, b1[2] = {b4[2], b4[3]};
        mma_bf16(acc[0], af, b0);
        mma_bf16(acc[1], af, b1);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = n0 + 8 * j + t2;
        if (n < dh) {  // dh even: n + 1 < dh too
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * mt + g + 8 * h;
            if (r < S) {
              *reinterpret_cast<uint32_t*>(rows + (size_t)r * ld + gcol + n) = xrt::pack_bf16(
                  __float2bfloat16_rn(acc[j][2 * h]), __float2bfloat16_rn(acc[j][2 * h + 1]));
              cs[j][0] += acc[j][2 * h];
              cs[j][1] += acc[j][2 * h + 1];
            }
          }
        }
      }
    }
    if (bias != nullptr) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          cs[j][0] += __shfl_xor_sync(0xffffffffu, cs[j][0], o);
          cs[j][1] += __shfl_xor_sync(0xffffffffu, cs[j][1], o);
        }
        const int n = n0 + 8 * j + t2;
        if (lane < 4 && n < dh) {
          bias[gcol + n] = cs[j][0];
          bias[gcol + n + 1] = cs[j][1];
        }
      }
    }
  }
}

// Pass 1 of the bf16 backward.  A CTA takes ``seqs`` whole sequences, or
// with a cluster of C > 1 CTAs one sequence, each CTA its H / C heads and
// its C-th of every other product's 8-column blocks (as the forward).  It
// recomputes the layer from x (as the TPU kernel does), then walks the VJP
// down to dx.  Every product stages its operand rows (all the CTA's rows)
// from the workspace into shared memory by cp.async and runs dense_tc on
// the weights packed in B-fragment order, W in the recompute and W^T in the
// VJP, so each weight fragment a warp loads feeds every m-tile of the CTA's
// rows (four at 2 x 32).  The row-wise steps (the LayerNorms and their VJPs)
// take rows rank, rank + C, ...; the CTAs of a cluster share the workspace
// behind a fence and a cluster barrier.  The rounded operands of the four
// weight-gradient products go to the workspace for pass 2; the bias and
// LayerNorm gradients are summed over each sequence's rows into its row of
// ``partial`` for pass 3, the qkv bias's in the attention VJP's epilogue, so
// that dq, dk and dv reach the workspace only rounded, as dqm.
template <int kStop>
__global__ void __launch_bounds__(kBwdTcThreads, 1) fused_layer_bwd_rows_kernel(BwdParams p) {
  using T = bf16;
  using A = xrt::Act<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = p.S, D = p.D, H = p.H, F = p.F, C = p.cluster, hg = p.hg;
  const uint32_t seed[3] = {p.seed[0], p.seed[1], p.seed[2]};  // read once, into registers
  const int rank = C > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int b0 = blockIdx.x / C * p.seqs;  // the CTA's first sequence
  const int nseq = min(p.seqs, p.B - b0), M = nseq * S, Mp = round_up(M, 16);
  const int dh = D / H, ld3 = 3 * D, hpc = H / C, hlo = rank * hpc;
  const int dhp = round_up(dh, 16), hc = hpc * dhp;  // a head's staged columns, a third's
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const BwdTcLayout L(S, D, H, F, p.seqs, C, hg);
  int* smask = reinterpret_cast<int*>(smem);
  bf16* sa = reinterpret_cast<bf16*>(smem + L.ops);  // a product's operand; a sequence's q|k|v
  float* red = reinterpret_cast<float*>(smem + L.ops);  // the row steps' column sums
  bf16* sgw = reinterpret_cast<bf16*>(smem + L.gw);
  bf16* spb = reinterpret_cast<bf16*>(smem + L.heads);  // hg x Sp x (Sp + 8) T(dropped)
  bf16* sdsb = spb + hg * round_up(S, 16) * (round_up(S, 16) + 8);  // and T(d_scores)
  const size_t row_base = (size_t)b0 * S;
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
  float* duf = p.duf + row_base * F;
  const VecOffsets off(D, F);
  float* part = p.partial + (size_t)b0 * off.total;  // row s: sequence b0 + s
  const WOffsets woff(D, F);
  const uint2* wfw = p.wp;                   // W, packed (uint2 units: WOffsets / 4)
  const uint2* wbw = p.wp + woff.total / 4;  // W^T, packed
  // the CTA's 8-column blocks [lo, hi) of a product of N columns
  auto blk_lo = [&](int N) { return rank * (N / 8) / C; };
  auto blk_hi = [&](int N) { return (rank + 1) * (N / 8) / C; };
  const int d0 = 8 * blk_lo(D), d1 = 8 * blk_hi(D), f0 = 8 * blk_lo(F), f1 = 8 * blk_hi(F);
  // the workspace is written by every CTA of the cluster: a fence, then the
  // barrier, before a step reads another CTA's part (one CTA: the block
  // barrier alone makes its writes visible to its threads)
  auto cluster_barrier = [&]() {
    if (C > 1) {
      __threadfence();
      cg::this_cluster().sync();
    } else {
      __syncthreads();
    }
  };
  // the row-wise steps: a warp a row, the CTA's rows of a sequence (s S +
  // rank + C i, i < nr) in blocks over the sequence's wps warps, so that a
  // warp's rows are of one sequence
  const int wps = nwarps / p.seqs, nr = (S - rank + C - 1) / C, qr = (nr + wps - 1) / wps;
  auto each_row = [&](auto body) {
    const int s = warp / wps, i0 = (warp % wps) * qr;
    if (s < nseq)
      for (int i = i0; i < min(nr, i0 + qr); ++i) body(s * S + rank + C * i);
  };
  // the column sums of a row step: each warp's slot of red (3 D: the row
  // step's three sums' terms over its rows, in order), summed over the
  // sequence's warps in order, and with a cluster over its CTAs in rank
  // order (distributed shared memory), into the partials at o0, o1, o2
  float* wred = red + warp * 3 * D;
  auto zero_sums = [&]() {
    for (int c = lane; c < 3 * D; c += 32) wred[c] = 0.f;
    __syncwarp();
  };
  auto column_sums = [&](int o0, int o1, int o2) {
    const int o[3] = {o0, o1, o2};
    __syncthreads();
    if (C == 1) {
      for (int i = threadIdx.x; i < nseq * 3 * D; i += blockDim.x) {
        const int s = i / (3 * D), qc = i % (3 * D);
        float sum = 0.f;
        for (int w = s * wps; w < (s + 1) * wps; ++w) sum += red[w * 3 * D + qc];
        part[(size_t)s * off.total + o[qc / D] + qc % D] = sum;
      }
      __syncthreads();
      return;
    }
    for (int i = threadIdx.x; i < 3 * D; i += blockDim.x) {  // the CTA's, into warp 0's slot
      float sum = 0.f;
      for (int w = 0; w < nwarps; ++w) sum += red[w * 3 * D + i];
      red[i] = sum;
    }
    cg::this_cluster().sync();
    for (int i = threadIdx.x; i < 3 * (d1 - d0); i += blockDim.x) {
      const int q = i / (d1 - d0), c = d0 + i % (d1 - d0);
      float sum = 0.f;
      for (int k = 0; k < C; ++k) sum += cg::this_cluster().map_shared_rank(red, k)[q * D + c];
      part[o[q] + c] = sum;
    }
    cg::this_cluster().sync();  // every CTA's sums read before its shared memory is reused
  };
  // the ffn_in bias: a thread per (sequence, column) of the CTA's [c0, c1)
  auto each_col = [&](int c0, int c1, auto body) {
    const int w = c1 - c0;
    for (int i = threadIdx.x; i < nseq * w; i += blockDim.x)
      body(part + (size_t)(i / w) * off.total, (i / w) * S, c0 + i % w);
  };
  // epi(r, n, v0, v1) of the CTA's 8-column blocks [blk0, blk1) of each of
  // ``parts`` parts of A W over its M rows: A (leading dimension K) staged
  // from the workspace, W packed (dense_tc: every m-tile of the CTA's rows
  // takes each weight fragment a warp loads)
  auto product_in = [&](const T* a, int K, const uint2* W, int parts, int part_blocks, int blk0,
                        int blk1, auto pre, auto epi) {
    xrt::stage_rows_async(a, M, K, 0, Mp, sa, K + 8);
    xrt::cp_async_commit();
    xrt::cp_async_wait<0>();
    __syncthreads();
    dense_tc_in(sa, K + 8, K, W, M, parts, part_blocks, blk0, blk1, pre, epi);
    __syncthreads();
  };
  auto product = [&](const T* a, int K, const uint2* W, int parts, int part_blocks, int blk0,
                     int blk1, auto epi) {
    product_in(a, K, W, parts, part_blocks, blk0, blk1,
               [](int, int) { return make_float2(0.f, 0.f); },
               [&](int r, int n, float v0, float v1, float2) { epi(r, n, v0, v1); });
  };
  // what an epilogue adds to its output pair (r, n): the f32 pair of a
  // row-major f32 matrix
  auto f32_pair = [](const float* m, int ld) {
    return [=](int r, int n) { return *reinterpret_cast<const float2*>(m + (size_t)r * ld + n); };
  };
  auto pair = [](float v0, float v1) {
    return xrt::pack_bf16(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
  };

  for (int i = threadIdx.x; i < M; i += blockDim.x) smask[i] = p.mask[row_base + i] != 0;

  // ---- recompute: qkv = T(x Wqkv + b), the CTA's heads' columns of q, k, v
  const float* qkv_b = p.qkv_b;
  product(x, D, wfw + woff.qkv / 4, 3, D / 8, hlo * dh / 8, (hlo + hpc) * dh / 8,
          [=](int r, int n, float v0, float v1) {
            *reinterpret_cast<uint32_t*>(qkv + (size_t)r * ld3 + n) =
                pair(v0 + __ldg(qkv_b + n), v1 + __ldg(qkv_b + n + 1));
          });

  // the attention of sequence s: its rows of the CTA's heads' q|k|v into sa
  // (q, k, v at columns 0, hc, 2 hc, head hh's at hh dhp), with want_gw gw's
  // into sgw, zero in the rows past S and the columns past dh; 16-byte
  // copies where dh % 8 == 0, else 4-byte loads
  const float scale = 1.f / sqrtf((float)dh);
  const int lq = 3 * hc + 8, lg = hc + 8;
  const int causal = p.causal;
  auto stage_heads = [&](int s, bool want_gw) {
    const int hp = dhp / 8, pieces = hc / 8;  // 8-column pieces of a head, of a third
    for (int i = threadIdx.x; i < round_up(S, 16) * 4 * pieces; i += blockDim.x) {
      const int r = i / (4 * pieces), which = (i / pieces) % 4, hh = (i % pieces) / hp;
      const int c = (i % hp) * 8;
      if (which == 3 && !want_gw) continue;
      const size_t row = (size_t)s * S + (r < S ? r : 0);
      const T* src = which < 3 ? qkv + row * ld3 + which * D : h2 + row * D;  // gw (in h2)
      bf16* dst = which < 3 ? sa + r * lq + which * hc : sgw + r * lg;
      src += (hlo + hh) * dh + c;
      dst += hh * dhp + c;
      if (dh % 8 == 0) {
        const bool in = r < S && c < dh;
        xrt::cp_async16(dst, in ? src : qkv, in);
      } else {
#pragma unroll
        for (int e = 0; e < 8; e += 2)
          *reinterpret_cast<uint32_t*>(dst + e) =
              r < S && c + e < dh ? *reinterpret_cast<const uint32_t*>(src + e) : 0u;
      }
    }
    xrt::cp_async_commit();
    xrt::cp_async_wait<0>();
    __syncthreads();
  };
  // sequence s's attention (its q|k|v and gw staged in sa and sgw)
  auto attn_of = [&](int s) {
    return TcAttn{sa, sgw, smask + s * S, spb, sdsb, ctx + (size_t)s * S * D, S, D, H, dh, dhp, hc,
                  lq, lg, causal, p.attn_drop, b0 + s, hlo, scale, p.attn_keep, seed[0],
                  p.attn_thr};
  };

  // ---- recompute: attention, ctx = T(T(dropped) V), every head of the CTA
  // at once
  for (int s = 0; s < nseq; ++s) {
    stage_heads(s, false);
    if (S <= 32) tc_attention<4>(attn_of(s), hpc);
    else tc_attention<8>(attn_of(s), hpc);
    __syncthreads();
  }
  cluster_barrier();

  // ---- recompute: a = dropout(T(ctx Wout + b)) into h1, then (rows) h1 =
  // T(x + a), the LN1 statistics, x1 = T(LN1(h1))
  const int hidden_drop = p.hidden_drop;
  const uint32_t hidden_thr = p.hidden_thr;
  const float keep_fwd = p.hidden_keep_fwd, keep_bwd = p.hidden_keep_bwd;
  auto dense_dropout = [=](const float* bias, T* out, uint32_t sd) {
    return [=](int r, int n, float v0, float v1) {
      float v[2] = {v0, v1};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        v[i] = A::round(v[i] + __ldg(bias + n + i));
        if (hidden_drop) {
          const uint32_t idx = (row0 + (uint32_t)r) * (uint32_t)D + (uint32_t)(n + i);
          v[i] = xrt::keep(idx, sd, hidden_thr) ? A::round(v[i] / keep_fwd) : 0.f;
        }
      }
      *reinterpret_cast<uint32_t*>(out + (size_t)r * D + n) = pair(v[0], v[1]);
    };
  };
  product(ctx, D, wfw + woff.out / 4, 1, 0, blk_lo(D), blk_hi(D),
          dense_dropout(p.out_b, h1, seed[1]));
  cluster_barrier();
  each_row([&](int r) {
    const float2 st = add_ln_row(h1 + (size_t)r * D, x + (size_t)r * D, p.ln1_s, p.ln1_b, D,
                                 p.eps, x1 + (size_t)r * D);
    if (lane == 0) {
      stats[r * 4 + 0] = st.x;
      stats[r * 4 + 1] = st.y;
    }
  });
  cluster_barrier();

  // ---- recompute: u = T(x1 Win + b), g = T(gelu(u)) with the A&S erf
  const float* ffn_in_b = p.ffn_in_b;
  product(x1, D, wfw + woff.ffn_in / 4, 1, 0, blk_lo(F), blk_hi(F),
          [=](int r, int n, float v0, float v1) {
            const float u0 = A::round(v0 + __ldg(ffn_in_b + n));
            const float u1 = A::round(v1 + __ldg(ffn_in_b + n + 1));
            const size_t i = (size_t)r * F + n;
            *reinterpret_cast<uint32_t*>(u + i) = pair(u0, u1);
            *reinterpret_cast<uint32_t*>(g + i) =  // _APPROX_RECOMPUTE_ERF
                pair(0.5f * u0 * (1.f + erf_as(u0 * kInvSqrt2)),
                     0.5f * u1 * (1.f + erf_as(u1 * kInvSqrt2)));
          });
  cluster_barrier();

  // ---- recompute: f = dropout(T(g Wffn_out + b)) into h2; then (rows) h2 =
  // T(x1 + f) and the LN2 statistics, and the LN2 VJP: dh2 into dres (= dx1
  // so far), dfm = T(dropout'(dh2))
  product(g, F, wfw + woff.ffn_out / 4, 1, 0, blk_lo(D), blk_hi(D),
          dense_dropout(p.ffn_out_b, h2, seed[2]));
  cluster_barrier();
  if constexpr (kStop == kBwdFull) zero_sums();
  each_row([&](int r) {
    const size_t i = (size_t)r * D;
    const float2 st = ln2_row(
        h2 + i, x1 + i, dy + i, p.ln2_s, p.ln2_b, D, p.eps,
        kStop == kStopRecompute ? static_cast<T*>(p.dx) + row_base * D + i : nullptr, dres + i,
        dfm + i, row0 + r, hidden_drop, seed[2], hidden_thr, keep_bwd,
        kStop == kBwdFull ? wred : nullptr);
    if (lane == 0) {
      stats[r * 4 + 2] = st.x;
      stats[r * 4 + 3] = st.y;
    }
  });
  if constexpr (kStop == kStopRecompute) return;
  cluster_barrier();
  // the LN2 and ffn_out bias gradients
  if constexpr (kStop == kBwdFull) column_sums(off.ln2_s, off.ln2_b, off.ffn_out_b);

  // ---- FFN backward: du = (dfm Wffn_out^T) * gelu'(u), dum = T(du) (and
  // du in f32 for its bias gradient)
  product_in(dfm, D, wbw + woff.ffn_out / 4, 1, 0, blk_lo(F), blk_hi(F),
             [=](int r, int n) {  // u's pair, loaded before the epilogue's stores
               const __nv_bfloat162 v =
                   *reinterpret_cast<const __nv_bfloat162*>(u + (size_t)r * F + n);
               return make_float2(__low2float(v), __high2float(v));
             },
             [=](int r, int n, float v0, float v1, float2 uu) {
               const size_t i = (size_t)r * F + n;
               const float acc[2] = {v0, v1}, us[2] = {uu.x, uu.y};
               float du[2];
#pragma unroll
               for (int j = 0; j < 2; ++j) {
                 const float uv = us[j];
                 const float e = erf_as(uv * kInvSqrt2);  // _APPROX_RECOMPUTE_ERF
                 const float phi = expf(-0.5f * uv * uv) * kInvSqrt2Pi;
                 du[j] = acc[j] * (0.5f * (1.f + e) + uv * phi);
               }
               *reinterpret_cast<uint32_t*>(dum + i) = pair(du[0], du[1]);
               duf[i] = du[0];
               duf[i + 1] = du[1];
             });
  if constexpr (kStop == kBwdFull) {  // the ffn_in bias gradient
    each_col(f0, f1, [&](float* ps, int r0, int c) {
      float s = 0.f;
#pragma unroll 8
      for (int r = r0; r < r0 + S; ++r) s += duf[(size_t)r * F + c];
      ps[off.ffn_in_b + c] = s;
    });
  }
  cluster_barrier();
  // dx1 = dh2 + dum Win^T into dres
  product_in(dum, F, wbw + woff.ffn_in / 4, 1, 0, blk_lo(D), blk_hi(D), f32_pair(dres, D),
             [=](int r, int n, float v0, float v1, float2 d) {
               *reinterpret_cast<float2*>(dres + (size_t)r * D + n) =
                   make_float2(d.x + v0, d.y + v1);
             });
  cluster_barrier();

  // ---- (rows) the LN1 VJP: dh1 over dres, dam = T(dropout'(dh1))
  if constexpr (kStop == kBwdFull) zero_sums();
  each_row([&](int r) {
    const size_t i = (size_t)r * D;
    ln_bwd_row<float>(dres + i, h1 + i, make_float2(stats[r * 4], stats[r * 4 + 1]), p.ln1_s, D,
                      dres + i, dam + i, row0 + r, hidden_drop, seed[1], hidden_thr, keep_bwd,
                      kStop == kBwdFull ? wred : nullptr);
  });
  // the LN1 and out bias gradients
  if constexpr (kStop == kBwdFull) column_sums(off.ln1_s, off.ln1_b, off.out_b);
  cluster_barrier();
  // ---- gw = T(dam Wout^T) into h2 (no longer needed), this CTA's heads'
  // columns (D % (8 C) == 0), which its attention alone reads
  T* gw = h2;
  product(dam, D, wbw + woff.out / 4, 1, 0, blk_lo(D), blk_hi(D),
          [=](int r, int n, float v0, float v1) {
            *reinterpret_cast<uint32_t*>(gw + (size_t)r * D + n) = pair(v0, v1);
          });
  if constexpr (kStop == kStopFfnBwd) {
    store_rows<T>(gw, D, M, D, d0, d1, 0, 1, static_cast<T*>(p.dx) + row_base * D);
    return;
  }

  // ---- attention backward, hg heads at a time on the tensor cores: dq, dk
  // and dv rounded into dqm, their f32 column sums over the sequence's rows
  // into its qkv bias partials
  for (int s = 0; s < nseq; ++s) {
    stage_heads(s, true);
    float* ps = part + (size_t)s * off.total;
    T* dqs = dqm + (size_t)s * S * ld3;
    for (int h0 = 0; h0 < hpc; h0 += hg) {
      // spb = T(dropped), sdsb = T(d_scores) of heads [h0, h0 + hg)
      if (S <= 32) tc_attention_grad<4>(attn_of(s), h0, hg);
      else tc_attention_grad<8>(attn_of(s), h0, hg);
      __syncthreads();
      // dq, dk, dv into dqm, their column sums into the qkv bias partials
      tc_attention_products(attn_of(s), h0, hg, dqs, ld3,
                            kStop == kBwdFull ? ps + off.qkv_b : nullptr);
      __syncthreads();
    }
  }
  cluster_barrier();

  // ---- dx = T(dh1 + dqm Wqkv^T)
  T* dx = static_cast<T*>(p.dx) + row_base * D;
  product_in(dqm, ld3, wbw + woff.qkv / 4, 1, 0, blk_lo(D), blk_hi(D), f32_pair(dres, D),
             [=](int r, int n, float v0, float v1, float2 d) {
               *reinterpret_cast<uint32_t*>(dx + (size_t)r * D + n) = pair(d.x + v0, d.y + v1);
             });
}

// ---------------------------------------------------------------------------
// the f32 layer on the CUDA cores: the forward and pass 1 of the backward
// ---------------------------------------------------------------------------

// A product's tiles (see f32_product): 128 output columns a pass, 32 of k a
// staged tile; the transposed weight tile holds a column's k values in a row
// of kWtLd, a staged activation tile a row's in kALd (16-byte rows whose
// 16-byte index steps by an odd count: conflict-free 16-byte reads)
constexpr int kPassCols = 128;
constexpr int kKChunk = 32;
constexpr int kWtLd = kKChunk + 4;
constexpr int kALd = kKChunk + 4;
constexpr int kWTileFwd = kKChunk * kPassCols;  // a (K, N) weight's tile
constexpr int kWTile = kPassCols * kWtLd;       // either tile (the backward's buffers)

// rows a product's tiles cover: the 8 warps' 4-row groups, once (S <= 32)
// or twice
__host__ __device__ inline int f32_rows(int S) { return S <= 32 ? 32 : 64; }

// a leading dimension for rows of w floats (w % 4 == 0) read by eight
// lanes at eight rows in 16-byte pieces without bank conflicts
__host__ __device__ inline int odd_ld(int w) { return (w / 4) % 2 ? w : w + 4; }

// bytes and offsets of the f32 forward's shared memory (the rows of
// f32_rows; rows of D at odd_ld(D), of F at odd_ld(F)):
//   sx  rows x D      the layer input, then x1 = LN1(...)
//   a1  rows x max(D, F)   ctx (every CTA's heads), then the FFN hidden g
//   a2  rows x max(odd_ld(3 hg dh), D)   a head group's q|k|v, then a =
//       dropout(ctx Wout + b), then f = dropout(g Wffn_out + b)
//   two (K, N) weight tiles (the key mask is read from device memory)
struct F32Layout {
  size_t a1, a2, wbuf, total;
  __host__ __device__ F32Layout(int S, int D, int H, int F, int hg) {
    const size_t rows = f32_rows(S);
    const int ldx = odd_ld(D), ldf = odd_ld(F), w2 = odd_ld(3 * hg * (D / H));
    a1 = rows * ldx * sizeof(float);
    a2 = a1 + rows * (ldx > ldf ? ldx : ldf) * sizeof(float);
    wbuf = a2 + rows * (w2 > ldx ? w2 : ldx) * sizeof(float);
    total = wbuf + 2 * kWTileFwd * sizeof(float);
  }
};

// and of pass 1 of the f32 backward: two weight tiles and two activation
// tiles; a head group's q|k|v (S x odd_ld(3 hg dh)) and gw (S x hg dh), its
// d_scores and dropped probs (hg x S x S each); the key mask
struct F32BwdLayout {
  size_t abuf, qkv, gw, sds, sdr, mask, total;
  __host__ __device__ F32BwdLayout(int S, int D, int H, int hg) {
    const int dh = D / H;
    abuf = 2 * kWTile * sizeof(float);
    qkv = abuf + 2 * (size_t)f32_rows(S) * kALd * sizeof(float);
    gw = qkv + (size_t)S * odd_ld(3 * hg * dh) * sizeof(float);
    sds = gw + (size_t)S * hg * dh * sizeof(float);
    sdr = sds + (size_t)hg * S * S * sizeof(float);
    mask = sdr + (size_t)hg * S * S * sizeof(float);
    total = mask + (size_t)S * sizeof(int);
  }
};

// output columns of a product: ``parts`` runs of ``width`` columns (a
// multiple of 4), run i from column base + i * stride of the weight's N
struct Cols {
  int base, width, parts, stride;
  __device__ __forceinline__ int count() const { return parts * width; }
  __device__ __forceinline__ int at(int c) const {
    return base + (c / width) * stride + c % width;
  }
};

// CTA rank's share of N columns split across a cluster of C: whole blocks
// of 4 columns (head-aligned for D when D % (4 C) == 0)
__device__ __forceinline__ Cols share(int N, int rank, int C) {
  const int nb = N / 4, b0 = rank * nb / C, b1 = (rank + 1) * nb / C;
  return Cols{4 * b0, 4 * (b1 - b0), 1, 0};
}

template <int q>
__device__ __forceinline__ float comp(const float4& v) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// one k step q (of four loaded) of f32_product's register tiles: kT, wv[j]
// holds column j's four k; else wv[q] holds k step q's four columns
template <int q, bool kT, int kMT>
__device__ __forceinline__ void fma_k(float (&acc)[kMT][4][4], const float4 (&av)[kMT][4],
                                      const float4 (&wv)[4]) {
  const float w0 = kT ? comp<q>(wv[0]) : wv[q].x;
  const float w1 = kT ? comp<q>(wv[1]) : wv[q].y;
  const float w2 = kT ? comp<q>(wv[2]) : wv[q].z;
  const float w3 = kT ? comp<q>(wv[3]) : wv[q].w;
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = comp<q>(av[m][i]);
      acc[m][i][0] = fmaf(x, w0, acc[m][i][0]);
      acc[m][i][1] = fmaf(x, w1, acc[m][i][1]);
      acc[m][i][2] = fmaf(x, w2, acc[m][i][2]);
      acc[m][i][3] = fmaf(x, w3, acc[m][i][3]);
    }
}

// acc(r, n) = sum_k A(r, k) W(k, n) for the rows r < S and the columns
// ``cols`` of the weight, with W(k, n) = W[k N + n] (kT false: a (K, N)
// weight) or W[n K + k] (kT true: the product with the transpose of an (N,
// K) weight).  Each output is one thread's chain of f32 FMAs over k in
// increasing order, so its bits depend on neither the cluster nor the pass.
// Passes of 128 columns; per k chunk of 32 the pass's weight tile goes to
// shared memory by 16-byte cp.async, double-buffered, shared by all the
// CTA's rows, as a (k, column) tile, or for kT a (column, k) tile (so the
// copies and the reads stay 16-byte and unit-stride).  A is in shared memory
// (a, leading dimension lda with lda / 4 odd, f32_rows(S) rows readable)
// or, with kAG, in device memory, its chunk staged beside the weight's.
// Warp w holds the pass's columns [16 w, 16 w + 16), lane l = 4 g + q the
// rows g, g + 8, g + 16, g + 24 (and 32 more for kMT = 2) and the columns
// 16 w + 4 q .. + 3 (kT: 16 w + q + 4 j): a register tile of 4 x 4 outputs
// per 32 rows from 16-byte shared loads of A and W, each warp load eight
// (A) or four (W) distinct rows on distinct banks, broadcast to the lanes
// that share them.
// epi(r, c, n, acc) takes each output, c its index in cols.
template <bool kT, bool kAG, int kMT, typename Epi>
__device__ void f32_product_tiles(const float* a, int lda, int K, const float* __restrict__ W,
                                  int N, Cols cols, int S, float* wbuf, float* abuf, Epi epi) {
  constexpr int kWStride = kT ? kWTile : kWTileFwd;
  constexpr int kARows = 32 * kMT;
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, q = lane & 3, cw = 16 * (tid >> 5);
  const int nk = (K + kKChunk - 1) / kKChunk, total = cols.count();
  for (int c0 = 0; c0 < total; c0 += kPassCols) {
    const int pc = min(kPassCols, total - c0);
    auto stage = [&](int ch) {
      const int k0 = ch * kKChunk;
      float* wb = wbuf + (ch & 1) * kWStride;
      if constexpr (kT) {
        for (int i = tid; i < kPassCols * (kKChunk / 4); i += kThreads) {
          const int c = i / (kKChunk / 4), k = k0 + (i % (kKChunk / 4)) * 4;
          const bool in = c < pc && k < K;
          xrt::cp_async16(wb + c * kWtLd + (k - k0),
                          in ? W + (size_t)cols.at(c0 + c) * K + k : W, in);
        }
      } else {
        for (int i = tid; i < kKChunk * (kPassCols / 4); i += kThreads) {
          const int kk = i / (kPassCols / 4), c = (i % (kPassCols / 4)) * 4;
          const bool in = c < pc && k0 + kk < K;
          xrt::cp_async16(wb + kk * kPassCols + c,
                          in ? W + (size_t)(k0 + kk) * N + cols.at(c0 + c) : W, in);
        }
      }
      if constexpr (kAG) {
        float* ab = abuf + (ch & 1) * kARows * kALd;
        for (int i = tid; i < kARows * (kKChunk / 4); i += kThreads) {
          const int r = i / (kKChunk / 4), k = k0 + (i % (kKChunk / 4)) * 4;
          const bool in = r < S && k < K;
          xrt::cp_async16(ab + r * kALd + (k - k0), in ? a + (size_t)r * lda + k : a, in);
        }
      }
    };
    float acc[kMT][4][4];
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[m][i / 4][i % 4] = 0.f;
    stage(0);
    xrt::cp_async_commit();
    for (int ch = 0; ch < nk; ++ch) {
      if (ch + 1 < nk) stage(ch + 1);
      xrt::cp_async_commit();
      xrt::cp_async_wait<1>();
      __syncthreads();
      const float* wb = wbuf + (ch & 1) * kWStride;
      const float* ab = kAG ? abuf + (ch & 1) * kARows * kALd : a + ch * kKChunk;
      const int ald = kAG ? kALd : lda;
      const int kt = min(kKChunk, K - ch * kKChunk);  // a multiple of 4
#pragma unroll 2
      for (int kk = 0; kk < kt; kk += 4) {
        float4 av[kMT][4], wv[4];
#pragma unroll
        for (int m = 0; m < kMT; ++m)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            av[m][i] = *reinterpret_cast<const float4*>(ab + (32 * m + g + 8 * i) * ald + kk);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wv[j] = kT ? *reinterpret_cast<const float4*>(wb + (cw + q + 4 * j) * kWtLd + kk)
                     : *reinterpret_cast<const float4*>(wb + (kk + j) * kPassCols + cw + 4 * q);
        fma_k<0, kT>(acc, av, wv);
        fma_k<1, kT>(acc, av, wv);
        fma_k<2, kT>(acc, av, wv);
        fma_k<3, kT>(acc, av, wv);
      }
      __syncthreads();
    }
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = 32 * m + g + 8 * i, c = kT ? cw + q + 4 * j : cw + 4 * q + j;
          if (r < S && c < pc) epi(r, c0 + c, cols.at(c0 + c), acc[m][i][j]);
        }
  }
}

template <bool kT, bool kAG, typename Epi>
__device__ __forceinline__ void f32_product(const float* a, int lda, int K, const float* W, int N,
                                            Cols cols, int S, float* wbuf, float* abuf, Epi epi) {
  if (S <= 32) f32_product_tiles<kT, kAG, 1>(a, lda, K, W, N, cols, S, wbuf, abuf, epi);
  else f32_product_tiles<kT, kAG, 2>(a, lda, K, W, N, cols, S, wbuf, abuf, epi);
}

// what the f32 attention needs of the layer and the sequence
struct F32Attn {
  int S, H, dh, b, causal, drop;
  float scale, keep;
  uint32_t seed, thr;
};

// The probabilities of query row sq of one head against the keys t = lane
// and lane + 32 (0 at t >= S), across the warp: the softmax over t of
// (q . k_t) scale + the key-padding and causal bias, each dot in order over
// dh, the max and the sum across the warp's lanes; q the row's dh values,
// k the key rows (leading dimension ld, 16-byte aligned)
__device__ __forceinline__ void f32_row_probs(const F32Attn& at, const float* q, const float* k,
                                              int ld, int sq, const int* smask, float p[2]) {
  const int lane = threadIdx.x & 31;
  float x[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int t = lane + 32 * u;
    x[u] = -INFINITY;
    if (t < at.S) {
      const float* kr = k + t * ld;
      float dot = 0.f;
      for (int j = 0; j < at.dh; j += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(q + j);
        const float4 kv = *reinterpret_cast<const float4*>(kr + j);
        dot = fmaf(qv.x, kv.x, dot);
        dot = fmaf(qv.y, kv.y, dot);
        dot = fmaf(qv.z, kv.z, dot);
        dot = fmaf(qv.w, kv.w, dot);
      }
      const float bias = (smask[t] ? 0.f : kNegInf) + ((at.causal && t > sq) ? kNegInf : 0.f);
      x[u] = dot * at.scale + bias;
    }
  }
  const float m = xrt::warp_max(fmaxf(x[0], x[1]));
  float sum = 0.f;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    x[u] = lane + 32 * u < at.S ? expf(x[u] - m) : 0.f;
    sum += x[u];
  }
  sum = xrt::warp_sum(sum);
#pragma unroll
  for (int u = 0; u < 2; ++u) p[u] = x[u] / sum;
}

// the dropped probability of prob at element idx of the probs
__device__ __forceinline__ float f32_dropped(const F32Attn& at, float prob, uint32_t idx) {
  if (!at.drop) return prob;
  return xrt::keep(idx, at.seed, at.thr) ? prob / at.keep : 0.f;
}

// The attention of heads [h0, h0 + hg) of sequence at.b from their q, k and
// v in ``qkv`` (leading dimension ld; group head i's q at columns i dh, k
// at (hg + i) dh, v at (2 hg + i) dh): a warp per (head, query row) holds
// the row's dropped probs across its lanes, then sums ctx(sq, j) = sum_t
// p_t v(t, j) over t in order, lane j; out(sq, h dh + j, ctx) takes each
template <typename Out>
__device__ void f32_attention(const F32Attn& at, const float* qkv, int ld, int h0, int hg,
                              const int* smask, Out out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int S = at.S, dh = at.dh;
  for (int item = warp; item < hg * S; item += nwarps) {
    const int i = item / S, sq = item % S, h = h0 + i;
    const float* v = qkv + (2 * hg + i) * dh;
    float p[2];
    f32_row_probs(at, qkv + sq * ld + i * dh, qkv + (hg + i) * dh, ld, sq, smask, p);
    const uint32_t base = (((uint32_t)at.b * at.H + (uint32_t)h) * S + (uint32_t)sq) * S;
#pragma unroll
    for (int u = 0; u < 2; ++u) p[u] = f32_dropped(at, p[u], base + lane + 32 * u);
    for (int j0 = 0; j0 < dh; j0 += 32) {
      const int j = j0 + lane;
      float acc = 0.f;
#pragma unroll 8
      for (int t = 0; t < S; ++t) {
        const float pt = __shfl_sync(0xffffffffu, t < 32 ? p[0] : p[1], t & 31);
        if (j < dh) acc = fmaf(pt, v[t * ld + j], acc);
      }
      if (j < dh) out(sq, h * dh + j, acc);
    }
  }
}

// The attention's VJP for heads [h0, h0 + hg): q, k and v as f32_attention
// reads them, gw (leading dimension hg dh) the cotangent of their ctx.  A
// warp per (head, query row) recomputes the row's probs, takes d_dropped =
// gw(sq) . v_t, the dropout's VJP, the row sum of d_probs probs, d_scores =
// probs (d_probs - rowsum) scale and dq(sq, j) = sum_t d_scores_t k(t, j);
// the group's d_scores and dropped probs go to sds and sdr, and a warp per
// (head, key row t) sums dk(t, j) = sum_sq d_scores(sq, t) q(sq, j) and
// dv(t, j) = sum_sq dropped(sq, t) gw(sq, j) over the query rows in order.
// dq, dk and dv into dqkv (leading dimension 3D).
__device__ void f32_attention_bwd(const F32Attn& at, const float* qkv, int ld, const float* gw,
                                  int h0, int hg, const int* smask, float* sds, float* sdr,
                                  float* dqkv, int D) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int S = at.S, dh = at.dh, ldg = hg * dh, ld3 = 3 * D;
  for (int item = warp; item < hg * S; item += nwarps) {
    const int i = item / S, sq = item % S, h = h0 + i;
    const float* k = qkv + (hg + i) * dh;
    const float* v = qkv + (2 * hg + i) * dh;
    const float* gr = gw + sq * ldg + i * dh;
    float p[2], ds[2] = {0.f, 0.f};
    f32_row_probs(at, qkv + sq * ld + i * dh, k, ld, sq, smask, p);
    const uint32_t base = (((uint32_t)at.b * at.H + (uint32_t)h) * S + (uint32_t)sq) * S;
    float dr[2], rs = 0.f;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int t = lane + 32 * u;
      dr[u] = f32_dropped(at, p[u], base + t);
      if (t < S) {
        const float* vr = v + t * ld;
        float dd = 0.f;
        for (int j = 0; j < dh; j += 4) {
          const float4 gv = *reinterpret_cast<const float4*>(gr + j);
          const float4 vv = *reinterpret_cast<const float4*>(vr + j);
          dd = fmaf(gv.x, vv.x, dd);
          dd = fmaf(gv.y, vv.y, dd);
          dd = fmaf(gv.z, vv.z, dd);
          dd = fmaf(gv.w, vv.w, dd);
        }
        if (at.drop) dd = dr[u] != 0.f ? dd / at.keep : 0.f;
        ds[u] = dd;
        rs += dd * p[u];
      }
    }
    rs = xrt::warp_sum(rs);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int t = lane + 32 * u;
      if (t < S) {
        ds[u] = p[u] * (ds[u] - rs) * at.scale;
        sds[(i * S + sq) * S + t] = ds[u];
        sdr[(i * S + sq) * S + t] = dr[u];
      }
    }
    for (int j0 = 0; j0 < dh; j0 += 32) {
      const int j = j0 + lane;
      float acc = 0.f;
#pragma unroll 8
      for (int t = 0; t < S; ++t) {
        const float dst = __shfl_sync(0xffffffffu, t < 32 ? ds[0] : ds[1], t & 31);
        if (j < dh) acc = fmaf(dst, k[t * ld + j], acc);
      }
      if (j < dh) dqkv[(size_t)sq * ld3 + h * dh + j] = acc;
    }
  }
  __syncthreads();
  for (int item = warp; item < hg * S; item += nwarps) {
    const int i = item / S, t = item % S, h = h0 + i;
    const float* q = qkv + i * dh;
    const float* g = gw + i * dh;
    const float* dsc = sds + i * S * S + t;
    const float* drc = sdr + i * S * S + t;
    for (int j = lane; j < dh; j += 32) {
      float ak = 0.f, av = 0.f;
#pragma unroll 8
      for (int sq = 0; sq < S; ++sq) {
        ak = fmaf(dsc[sq * S], q[sq * ld + j], ak);
        av = fmaf(drc[sq * S], g[sq * ldg + j], av);
      }
      dqkv[(size_t)t * ld3 + D + h * dh + j] = ak;
      dqkv[(size_t)t * ld3 + 2 * D + h * dh + j] = av;
    }
  }
}

// The f32 layer for one sequence, split across the p.cluster CTAs of a
// cluster (blockIdx.x / cluster is the sequence).  CTA ``rank`` computes the
// q, k and v columns of heads [rank H / C, (rank + 1) H / C), p.hg heads at
// a time, and their attention, and the rank-th share of the 4-column
// blocks of the other products; ctx, a, g and f go to every CTA's copy
// through distributed shared memory, a cluster barrier before each
// LayerNorm and each product that reads them; each CTA runs LN1 on every
// row of its own copy and LN2 on rows rank, rank + C, ...
__global__ void __launch_bounds__(kThreads, 1) fused_layer_fwd_f32_kernel(Params p, int stop) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = p.S, D = p.D, H = p.H, F = p.F, C = p.cluster, hg = p.hg;
  const uint32_t seed[3] = {p.seed[0], p.seed[1], p.seed[2]};  // read once, into registers
  const int rank = C > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int b = blockIdx.x / C, dh = D / H, hpc = H / C, ldq = odd_ld(3 * hg * dh);
  const int ldx = odd_ld(D), ldf = odd_ld(F);  // rows of D and of F in shared memory
  const F32Layout L(S, D, H, F, hg);
  float* sx = reinterpret_cast<float*>(smem);
  float* a1 = reinterpret_cast<float*>(smem + L.a1);
  float* a2 = reinterpret_cast<float*>(smem + L.a2);
  float* wbuf = reinterpret_cast<float*>(smem + L.wbuf);
  const int* mask = p.mask + b * S;
  auto cluster_sync = [&]() {
    if (C > 1) cg::this_cluster().sync();
    else __syncthreads();
  };
  const Copies<float> a1_all(a1, C), a2_all(a2, C);
  float* yg = static_cast<float*>(p.y) + (size_t)b * S * D;

  const float4* xg = reinterpret_cast<const float4*>(static_cast<const float*>(p.x) +
                                                     (size_t)b * S * D);
  for (int i = threadIdx.x; i < S * D / 4; i += blockDim.x)
    *reinterpret_cast<float4*>(sx + (i / (D / 4)) * ldx + (i % (D / 4)) * 4) = xg[i];
  cluster_sync();  // every CTA has started: its shared memory may be written

  // qkv of this CTA's heads, hg at a time into a2, and their attention
  const F32Attn at{S, H, dh, b, p.causal, p.attn_drop, 1.f / sqrtf((float)dh), p.attn_keep,
                   seed[0], p.attn_thr};
  const float* qkv_b = p.qkv_b;
  for (int h0 = rank * hpc; h0 < (rank + 1) * hpc; h0 += hg) {
    f32_product<false, false>(sx, ldx, D, p.qkv_w, 3 * D, Cols{h0 * dh, hg * dh, 3, D}, S, wbuf,
                              nullptr, [=](int r, int c, int n, float acc) {
                                a2[r * ldq + c] = acc + __ldg(qkv_b + n);
                              });
    __syncthreads();
    if (stop == kStopQkv) {
      store_rows<float>(a2, ldq, S, D, 0, hg * dh, 0, 1, yg + h0 * dh);
    } else {
      f32_attention(at, a2, ldq, h0, hg, mask,
                    [=](int sq, int col, float v) { a1_all.put(sq * ldx + col, v); });
    }
    __syncthreads();
  }
  if (stop == kStopQkv) return;
  cluster_sync();
  if (stop == kStopAttn) {
    store_rows<float>(a1, ldx, S, D, 0, D, rank, C, yg);
    return;
  }

  // a = dropout(ctx Wout + b) into a2, then x1 = LN1(x + a)
  const uint32_t row0 = (uint32_t)b * S;
  const int hidden_drop = p.hidden_drop;
  const uint32_t hidden_thr = p.hidden_thr;
  const float hidden_keep = p.hidden_keep;
  auto dropout_into = [=](const Copies<float>& dst, const float* bias, uint32_t seed) {
    return [=](int r, int, int n, float acc) {
      float v = acc + __ldg(bias + n);
      if (hidden_drop) {
        const uint32_t idx = (row0 + (uint32_t)r) * (uint32_t)D + (uint32_t)n;
        v = xrt::keep(idx, seed, hidden_thr) ? v / hidden_keep : 0.f;
      }
      dst.put(r * ldx + n, v);
    };
  };
  const Cols dcols = share(D, rank, C);
  f32_product<false, false>(a1, ldx, D, p.out_w, D, dcols, S, wbuf, nullptr,
                            dropout_into(a2_all, p.out_b, seed[1]));
  cluster_sync();
  add_layer_norm<float, float>(sx, ldx, a2, ldx, p.ln1_s, p.ln1_b, S, D, p.eps, sx, ldx);
  __syncthreads();
  if (stop == kStopOutLn1) {
    store_rows<float>(sx, ldx, S, D, 0, D, rank, C, yg);
    return;
  }

  // g = gelu(x1 Win + b) into a1
  const float* ffn_in_b = p.ffn_in_b;
  f32_product<false, false>(sx, ldx, D, p.ffn_in_w, F, share(F, rank, C), S, wbuf, nullptr,
                            [=](int r, int, int n, float acc) {
                              const float u = acc + __ldg(ffn_in_b + n);
                              a1_all.put(r * ldf + n, 0.5f * u * (1.f + erf_eigen(u * kInvSqrt2)));
                            });
  cluster_sync();
  if (stop == kStopFfnGelu) {
    store_rows<float>(a1, ldf, S, D, 0, D, rank, C, yg);
    return;
  }

  // f = dropout(g Wffn_out + b) into a2, then y = LN2(x1 + f)
  f32_product<false, false>(a1, ldf, F, p.ffn_out_w, D, dcols, S, wbuf, nullptr,
                            dropout_into(a2_all, p.ffn_out_b, seed[2]));
  cluster_sync();
  add_layer_norm<float, float>(sx, ldx, a2, ldx, p.ln2_s, p.ln2_b, S, D, p.eps, yg, D, rank, C);
}

// Pass 1 of the f32 backward for one sequence, split across the p.cluster
// CTAs of a cluster as the forward is: CTA ``rank`` recomputes its heads'
// q, k, v and attention and its share of each other product's columns,
// walks the VJP back through the same split and runs the row-wise steps
// (the LayerNorms and their VJPs) on rows rank, rank + C, ...  The CTAs
// share what they write through the workspace in device memory, a fence
// and a cluster barrier (release, then acquire at cluster scope) between a
// step and the next that reads another CTA's part.  Every product stages its operand
// rows from the workspace.  The bias and LayerNorm gradients are summed
// over the sequence's rows, each CTA its columns, into one row of
// ``partial`` for pass 3.
__global__ void __launch_bounds__(kThreads, 1) fused_layer_bwd_rows_f32_kernel(BwdParams p,
                                                                               int stop) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = p.S, D = p.D, H = p.H, F = p.F, C = p.cluster, hg = p.hg;
  const uint32_t seed[3] = {p.seed[0], p.seed[1], p.seed[2]};  // read once, into registers
  const int rank = C > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int b = blockIdx.x / C, dh = D / H, hpc = H / C, ld3 = 3 * D;
  const int ldq = odd_ld(3 * hg * dh), ldg = hg * dh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const F32BwdLayout L(S, D, H, hg);
  float* wbuf = reinterpret_cast<float*>(smem);
  float* abuf = reinterpret_cast<float*>(smem + L.abuf);
  float* sqkv = reinterpret_cast<float*>(smem + L.qkv);
  float* sgw = reinterpret_cast<float*>(smem + L.gw);
  float* sds = reinterpret_cast<float*>(smem + L.sds);
  float* sdr = reinterpret_cast<float*>(smem + L.sdr);
  int* smask = reinterpret_cast<int*>(smem + L.mask);
  // the workspace is written by every CTA of the cluster: a fence, then the
  // barrier, before a step reads another CTA's part
  auto cluster_barrier = [&]() {
    __threadfence();
    if (C > 1) cg::this_cluster().sync();
    else __syncthreads();
  };
  // and the same within the CTA, before it reads its own writes back
  auto block_barrier = [&]() {
    __threadfence();
    __syncthreads();
  };
  const size_t row_base = (size_t)b * S;
  const uint32_t row0 = (uint32_t)row_base;
  const float* x = static_cast<const float*>(p.x) + row_base * D;
  const float* dy = static_cast<const float*>(p.dy) + row_base * D;
  float* qkv = static_cast<float*>(p.qkv) + row_base * ld3;
  float* ctx = static_cast<float*>(p.ctx) + row_base * D;
  float* x1 = static_cast<float*>(p.x1) + row_base * D;
  float* u = static_cast<float*>(p.u) + row_base * F;
  float* g = static_cast<float*>(p.g) + row_base * F;
  float* h1 = static_cast<float*>(p.h1) + row_base * D;
  float* h2 = static_cast<float*>(p.h2) + row_base * D;
  float* stats = p.stats + row_base * 4;
  float* dfm = static_cast<float*>(p.dfm) + row_base * D;
  float* dum = static_cast<float*>(p.dum) + row_base * F;
  float* dam = static_cast<float*>(p.dam) + row_base * D;
  float* dqm = static_cast<float*>(p.dqm) + row_base * ld3;
  float* dres = p.dres + row_base * D;
  float* dx = static_cast<float*>(p.dx) + row_base * D;
  const VecOffsets off(D, F);
  float* part = p.partial + (size_t)b * off.total;
  const Cols dcols = share(D, rank, C), fcols = share(F, rank, C);
  const int d0 = dcols.base, d1 = dcols.base + dcols.width;
  const int f0 = fcols.base, f1 = fcols.base + fcols.width;
  // the row-wise steps: a warp per row of rank, rank + C, ...
  auto each_row = [&](auto body) {
    for (int r = rank + C * warp; r < S; r += C * nwarps) body(r);
  };
  const F32Attn at{S, H, dh, b, p.causal, p.attn_drop, 1.f / sqrtf((float)dh), p.attn_keep,
                   seed[0], p.attn_thr};
  const float eps = p.eps;
  const int hidden_drop = p.hidden_drop;
  const uint32_t hidden_thr = p.hidden_thr;
  const float keep_fwd = p.hidden_keep_fwd, keep_bwd = p.hidden_keep_bwd;

  for (int i = tid; i < S; i += blockDim.x) smask[i] = p.mask[b * S + i] != 0;
  __syncthreads();

  // ---- recompute: this CTA's heads' q, k, v (into the workspace and, a
  // group at a time, sqkv) and their attention into ctx
  const float* qkv_b = p.qkv_b;
  for (int h0 = rank * hpc; h0 < (rank + 1) * hpc; h0 += hg) {
    f32_product<false, true>(x, D, D, p.qkv_w, ld3, Cols{h0 * dh, hg * dh, 3, D}, S, wbuf, abuf,
                             [=](int r, int c, int n, float acc) {
                               const float v = acc + __ldg(qkv_b + n);
                               qkv[(size_t)r * ld3 + n] = v;
                               sqkv[r * ldq + c] = v;
                             });
    __syncthreads();
    f32_attention(at, sqkv, ldq, h0, hg, smask,
                  [=](int sq, int col, float v) { ctx[(size_t)sq * D + col] = v; });
    __syncthreads();
  }
  cluster_barrier();

  // ---- recompute: a = dropout(ctx Wout + b) into h1, then (rows) h1 = x +
  // a, the LN1 statistics, x1 = LN1(h1)
  auto dense_dropout = [=](const float* bias, float* out, uint32_t seed) {
    return [=](int r, int, int n, float acc) {
      float v = acc + __ldg(bias + n);
      if (hidden_drop) {
        const uint32_t idx = (row0 + (uint32_t)r) * (uint32_t)D + (uint32_t)n;
        v = xrt::keep(idx, seed, hidden_thr) ? v / keep_fwd : 0.f;
      }
      out[(size_t)r * D + n] = v;
    };
  };
  f32_product<false, true>(ctx, D, D, p.out_w, D, dcols, S, wbuf, abuf,
                           dense_dropout(p.out_b, h1, seed[1]));
  cluster_barrier();
  each_row([&](int r) {
    float* hr = h1 + (size_t)r * D;
    float sum = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float h = hr[c] + __ldg(x + (size_t)r * D + c);
      hr[c] = h;
      sum += h;
    }
    const float mean = xrt::warp_sum(sum) / (float)D;
    float sq = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float h = hr[c];
      sq += (h - mean) * (h - mean);
    }
    const float rstd = 1.f / sqrtf(xrt::warp_sum(sq) / (float)D + eps);
    for (int c = lane; c < D; c += 32)
      x1[(size_t)r * D + c] =
          (hr[c] - mean) * rstd * __ldg(p.ln1_s + c) + __ldg(p.ln1_b + c);
    if (lane == 0) {
      stats[r * 4 + 0] = mean;
      stats[r * 4 + 1] = rstd;
    }
  });
  cluster_barrier();

  // ---- recompute: u = x1 Win + b, g = gelu(u) (Eigen's erf, as the f32
  // forward)
  const float* ffn_in_b = p.ffn_in_b;
  f32_product<false, true>(x1, D, D, p.ffn_in_w, F, fcols, S, wbuf, abuf,
                           [=](int r, int, int n, float acc) {
                             const float uv = acc + __ldg(ffn_in_b + n);
                             u[(size_t)r * F + n] = uv;
                             g[(size_t)r * F + n] = 0.5f * uv * (1.f + erf_eigen(uv * kInvSqrt2));
                           });
  cluster_barrier();

  // ---- recompute: f = dropout(g Wffn_out + b) into h2; then (rows) h2 =
  // f + x1 and the LN2 statistics, and the LN2 VJP: dh2 into dres (dx1 so
  // far), dfm = dropout'(dh2)
  f32_product<false, true>(g, F, F, p.ffn_out_w, D, dcols, S, wbuf, abuf,
                           dense_dropout(p.ffn_out_b, h2, seed[2]));
  cluster_barrier();
  each_row([&](int r) {
    float* hr = h2 + (size_t)r * D;
    float sum = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float h = hr[c] + x1[(size_t)r * D + c];
      hr[c] = h;
      sum += h;
    }
    const float mean = xrt::warp_sum(sum) / (float)D;
    float sq = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float h = hr[c];
      sq += (h - mean) * (h - mean);
    }
    const float rstd = 1.f / sqrtf(xrt::warp_sum(sq) / (float)D + eps);
    if (lane == 0) {
      stats[r * 4 + 2] = mean;
      stats[r * 4 + 3] = rstd;
    }
    if (stop == kStopRecompute) {  // the recomputed y = LN2(h2)
      for (int c = lane; c < D; c += 32)
        dx[(size_t)r * D + c] =
            (hr[c] - mean) * rstd * __ldg(p.ln2_s + c) + __ldg(p.ln2_b + c);
    } else {
      float sg = 0.f, sgn = 0.f;
      for (int c = lane; c < D; c += 32) {
        const float n = (hr[c] - mean) * rstd;
        const float gv = __ldg(dy + (size_t)r * D + c) * __ldg(p.ln2_s + c);
        sg += gv;
        sgn += gv * n;
      }
      const float gm = xrt::warp_sum(sg) / (float)D;
      const float gnm = xrt::warp_sum(sgn) / (float)D;
      for (int c = lane; c < D; c += 32) {
        const float n = (hr[c] - mean) * rstd;
        const float gv = __ldg(dy + (size_t)r * D + c) * __ldg(p.ln2_s + c);
        const float dh = rstd * (gv - gm - n * gnm);
        dres[(size_t)r * D + c] = dh;
        dfm[(size_t)r * D + c] = hidden_drop_bwd(dh, hidden_drop, row0 + r, c, D, seed[2],
                                                 hidden_thr, keep_bwd);
      }
    }
  });
  if (stop == kStopRecompute) return;
  cluster_barrier();
  if (stop == kBwdFull) {  // the LN2 and ffn_out bias gradients
    for (int c = d0 + tid; c < d1; c += blockDim.x) {
      float s_scale = 0.f, s_bias = 0.f, s_fb = 0.f;
#pragma unroll 8
      for (int r = 0; r < S; ++r) {
        const float dyv = __ldg(dy + (size_t)r * D + c);
        const float n = (h2[(size_t)r * D + c] - stats[r * 4 + 2]) *
                        stats[r * 4 + 3];
        s_scale += dyv * n;
        s_bias += dyv;
        s_fb += hidden_drop_bwd(dres[(size_t)r * D + c], hidden_drop, row0 + r, c, D,
                                seed[2], hidden_thr, keep_bwd);
      }
      part[off.ln2_s + c] = s_scale;
      part[off.ln2_b + c] = s_bias;
      part[off.ffn_out_b + c] = s_fb;
    }
  }

  // ---- FFN: du = (dfm Wffn_out^T) gelu'(u) into dum
  f32_product<true, true>(dfm, D, D, p.ffn_out_w, F, fcols, S, wbuf, abuf,
                          [=](int r, int, int n, float acc) {
                            const float uv = u[(size_t)r * F + n];
                            const float e = erf_eigen(uv * kInvSqrt2);
                            const float phi = expf(-0.5f * uv * uv) * kInvSqrt2Pi;
                            dum[(size_t)r * F + n] = acc * (0.5f * (1.f + e) + uv * phi);
                          });
  block_barrier();
  if (stop == kBwdFull) {  // the ffn_in bias gradient
    for (int c = f0 + tid; c < f1; c += blockDim.x) {
      float s = 0.f;
#pragma unroll 8
      for (int r = 0; r < S; ++r) s += dum[(size_t)r * F + c];
      part[off.ffn_in_b + c] = s;
    }
  }
  cluster_barrier();
  // dx1 = dh2 + dum Win^T into dres
  f32_product<true, true>(dum, F, F, p.ffn_in_w, D, dcols, S, wbuf, abuf,
                          [=](int r, int, int n, float acc) {
                            dres[(size_t)r * D + n] = dres[(size_t)r * D + n] + acc;
                          });
  block_barrier();
  if (stop == kBwdFull) {  // the LN1 gradients
    for (int c = d0 + tid; c < d1; c += blockDim.x) {
      float s_scale = 0.f, s_bias = 0.f;
#pragma unroll 8
      for (int r = 0; r < S; ++r) {
        const float d = dres[(size_t)r * D + c];
        const float n = (h1[(size_t)r * D + c] - stats[r * 4]) *
                        stats[r * 4 + 1];
        s_scale += d * n;
        s_bias += d;
      }
      part[off.ln1_s + c] = s_scale;
      part[off.ln1_b + c] = s_bias;
    }
  }
  cluster_barrier();

  // ---- (rows) the LN1 VJP: dh1 over dres, dam = dropout'(dh1)
  each_row([&](int r) {
    const float mean = stats[r * 4], rstd = stats[r * 4 + 1];
    const float* hr = h1 + (size_t)r * D;
    float* dr = dres + (size_t)r * D;
    float sg = 0.f, sgn = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float n = (hr[c] - mean) * rstd;
      const float gv = dr[c] * __ldg(p.ln1_s + c);
      sg += gv;
      sgn += gv * n;
    }
    const float gm = xrt::warp_sum(sg) / (float)D;
    const float gnm = xrt::warp_sum(sgn) / (float)D;
    for (int c = lane; c < D; c += 32) {
      const float n = (hr[c] - mean) * rstd;
      const float gv = dr[c] * __ldg(p.ln1_s + c);
      const float dh = rstd * (gv - gm - n * gnm);
      dr[c] = dh;
      dam[(size_t)r * D + c] = hidden_drop_bwd(dh, hidden_drop, row0 + r, c, D, seed[1],
                                               hidden_thr, keep_bwd);
    }
  });
  cluster_barrier();
  if (stop == kBwdFull) {  // the out bias gradient
    for (int c = d0 + tid; c < d1; c += blockDim.x) {
      float s = 0.f;
#pragma unroll 8
      for (int r = 0; r < S; ++r)
        s += hidden_drop_bwd(dres[(size_t)r * D + c], hidden_drop, row0 + r, c, D,
                             seed[1], hidden_thr, keep_bwd);
      part[off.out_b + c] = s;
    }
  }

  // ---- gw = dam Wout^T into h2 (no longer needed), this CTA's heads'
  // columns (dcols: D % (4 C) == 0), which its attention alone reads
  float* gw = h2;
  f32_product<true, true>(dam, D, D, p.out_w, D, dcols, S, wbuf, abuf,
                          [=](int r, int, int n, float acc) { gw[(size_t)r * D + n] = acc; });
  block_barrier();
  if (stop == kStopFfnBwd) {
    for (int i = tid; i < S * dcols.width; i += blockDim.x) {
      const int r = i / dcols.width, c = d0 + i % dcols.width;
      dx[(size_t)r * D + c] = gw[(size_t)r * D + c];
    }
    return;
  }

  // ---- the attention's VJP, a head group at a time, into dqm: the group's
  // q, k, v and gw staged into shared memory
  for (int h0 = rank * hpc; h0 < (rank + 1) * hpc; h0 += hg) {
    const int w4 = hg * dh / 4;
    for (int i = tid; i < S * 4 * w4; i += blockDim.x) {
      const int r = i / (4 * w4), part_ = (i % (4 * w4)) / w4, c = (i % w4) * 4;
      if (part_ < 3)
        xrt::cp_async16(sqkv + r * ldq + part_ * hg * dh + c,
                        qkv + (size_t)r * ld3 + part_ * D + h0 * dh + c, true);
      else
        xrt::cp_async16(sgw + r * ldg + c, gw + (size_t)r * D + h0 * dh + c, true);
    }
    xrt::cp_async_commit();
    xrt::cp_async_wait<0>();
    __syncthreads();
    f32_attention_bwd(at, sqkv, ldq, sgw, h0, hg, smask, sds, sdr, dqm, D);
    block_barrier();
  }
  if (stop == kBwdFull) {  // the qkv bias gradient: this CTA's columns
    const int w = hpc * dh;
    for (int i = tid; i < 3 * w; i += blockDim.x) {
      const int c = (i / w) * D + rank * w + i % w;
      float s = 0.f;
#pragma unroll 8
      for (int r = 0; r < S; ++r) s += dqm[(size_t)r * ld3 + c];
      part[off.qkv_b + c] = s;
    }
  }
  cluster_barrier();

  // ---- dx = dh1 + dqm Wqkv^T
  f32_product<true, true>(dqm, ld3, ld3, p.qkv_w, D, dcols, S, wbuf, abuf,
                          [=](int r, int, int n, float acc) {
                            dx[(size_t)r * D + n] = dres[(size_t)r * D + n] + acc;
                          });
}

// The four f32 weights rounded to bf16 once per call into wp at WOffsets,
// each (K, N) weight packed in mma.sync's B-fragment order: for column
// block nb = n / 8 and k-step ks = k / 16, 32 lanes x 2 words, lane
// 4 (n % 8) + t holding the pairs (k, k + 1) at k = 16 ks + 2 t and
// 16 ks + 2 t + 8, so dense_tc loads a warp's fragments of one k-step as
// 256 contiguous bytes.  One thread writes one lane's 8 bytes.  K % 16 ==
// 0 and N % 8 == 0.  With ``transposed``, the four transposes W^T follow
// at WOffsets::total + WOffsets, each packed as an (N, K) weight (the
// backward's products with W^T; N % 16 == 0, K % 8 == 0).
__global__ void pack_weights_kernel(const float* __restrict__ qkv_w,
                                    const float* __restrict__ out_w,
                                    const float* __restrict__ ffn_in_w,
                                    const float* __restrict__ ffn_out_w, int D, int F,
                                    int transposed, uint2* __restrict__ wp) {
  const WOffsets w(D, F);
  const size_t per = w.total / 4;  // uint2 items (4 bf16) of the four weights
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= per * (transposed ? 2 : 1)) return;
  const bool tr = i >= per;
  const size_t out = i;
  if (tr) i -= per;
  const float* W;
  size_t base;
  int K, N;
  if (i < w.out / 4) { W = qkv_w; base = w.qkv; K = D; N = 3 * D; }
  else if (i < w.ffn_in / 4) { W = out_w; base = w.out; K = D; N = D; }
  else if (i < w.ffn_out / 4) { W = ffn_in_w; base = w.ffn_in; K = D; N = F; }
  else { W = ffn_out_w; base = w.ffn_out; K = F; N = D; }
  const size_t j = i - base / 4;
  const int kp = tr ? N : K;  // the packed matrix's k extent
  const int nks = kp / 16, lane = (int)(j % 32), ks = (int)(j / 32 % nks), nb = (int)(j / 32 / nks);
  const int n = 8 * nb + lane / 4, k = 16 * ks + 2 * (lane % 4);
  // element (kk, n) of W, or of W^T: W[n][kk]
  auto at = [&](int kk) {
    return __float2bfloat16_rn(tr ? W[(size_t)n * N + kk] : W[(size_t)kk * N + n]);
  };
  wp[out] = make_uint2(xrt::pack_bf16(at(k), at(k + 1)), xrt::pack_bf16(at(k + 8), at(k + 9)));
}

// B sequences on clusters of ``cluster`` CTAs (no cluster attribute for
// 1), each CTA ``threads`` threads and ``smem`` bytes of dynamic shared
// memory; the launch's own error or the runtime's last
template <typename Kernel, typename... Args>
cudaError_t launch_clusters(Kernel kernel, int B, int cluster, int threads, size_t smem,
                            cudaStream_t stream, Args... args) {
  cudaError_t err = xrt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * cluster));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the bf16 forward: the weight pre-pass, then the layer on B clusters of
// p.cluster CTAs
template <int kStop>
cudaError_t launch_tc(const Params& p, int B, int smem_bytes, bf16* wp, cudaStream_t stream) {
  if (TcLayout(p.S, p.D, p.F).total > (size_t)smem_bytes) return cudaErrorInvalidValue;
  const WOffsets w(p.D, p.F);
  pack_weights_kernel<<<(unsigned)((w.total / 4 + 255) / 256), 256, 0, stream>>>(
      p.qkv_w, p.out_w, p.ffn_in_w, p.ffn_out_w, p.D, p.F, 0, reinterpret_cast<uint2*>(wp));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_clusters(fused_layer_fwd_tc_kernel<kStop>, B, p.cluster, kTcThreads,
                         (size_t)smem_bytes, stream, p, reinterpret_cast<const uint2*>(wp));
}

// the f32 forward on B clusters of p.cluster CTAs
// the f32 forward, or its section variant ``stop``, on B clusters of
// p.cluster CTAs
cudaError_t launch_f32(const Params& p, int B, int smem_bytes, int stop, cudaStream_t stream) {
  if (F32Layout(p.S, p.D, p.H, p.F, p.hg).total > (size_t)smem_bytes) return cudaErrorInvalidValue;
  return launch_clusters(fused_layer_fwd_f32_kernel, B, p.cluster, kThreads, (size_t)smem_bytes,
                         stream, p, stop);
}

// pass 2's grid, (tiles of the four weight gradients, row splits), its
// rows a split (whole chunks of ``chunk`` rows) and the splits that have
// rows set in p
dim3 weight_grad_grid(BwdParams& p, int chunk) {
  const int R = p.B * p.S;
  p.rows_per_split = ((R + p.splits - 1) / p.splits + chunk - 1) / chunk * chunk;
  p.splits = (R + p.rows_per_split - 1) / p.rows_per_split;
  const int tiles = wg_tiles(p.D, 3 * p.D) + wg_tiles(p.D, p.D) + wg_tiles(p.D, p.F) +
                    wg_tiles(p.F, p.D);
  return dim3((unsigned)tiles, (unsigned)p.splits);
}

// pass 3: the splits' partial tiles and the per-sequence column sums
cudaError_t launch_grad_reduce(const BwdParams& p, cudaStream_t stream) {
  const size_t n = WOffsets(p.D, p.F).total + VecOffsets(p.D, p.F).total;
  grad_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(p);
  return cudaGetLastError();
}

// the bf16 backward: pass 0 packs W and W^T, pass 1 on the tensor cores
// (p.seqs sequences a CTA, or a sequence on a cluster of p.cluster CTAs),
// pass 2 split-K on the tensor cores, pass 3 the reductions
template <int kStop>
cudaError_t launch_bwd_tc(BwdParams p, cudaStream_t stream) {
  cudaError_t err;
  const WOffsets w(p.D, p.F);
  pack_weights_kernel<<<(unsigned)((w.total / 2 + 255) / 256), 256, 0, stream>>>(
      p.qkv_w, p.out_w, p.ffn_in_w, p.ffn_out_w, p.D, p.F, 1, p.wp);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t smem = BwdTcLayout(p.S, p.D, p.H, p.F, p.seqs, p.cluster, p.hg).total;
  err = launch_clusters(fused_layer_bwd_rows_kernel<kStop>, (p.B + p.seqs - 1) / p.seqs,
                        p.cluster, kBwdTcThreads, smem, stream, p);
  if (err != cudaSuccess) return err;
  if constexpr (kStop != kBwdFull) return cudaSuccess;  // a section variant: pass 1 only
  const dim3 grid = weight_grad_grid(p, kWgChunk);
  weight_grad_mma_kernel<<<grid, 128, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_grad_reduce(p, stream);
}

// the f32 backward: pass 1 on B clusters of p.cluster CTAs, pass 2 split-K
// on the CUDA cores, pass 3 the reductions
cudaError_t launch_bwd_f32(const BwdParams& p, int stop, cudaStream_t stream) {
  cudaError_t err = launch_clusters(fused_layer_bwd_rows_f32_kernel, p.B, p.cluster, kThreads,
                                    F32BwdLayout(p.S, p.D, p.H, p.hg).total, stream, p, stop);
  if (err != cudaSuccess) return err;
  if (stop != kBwdFull) return cudaSuccess;  // a section variant: pass 1 only
  BwdParams q = p;
  const dim3 grid = weight_grad_grid(q, kWgRows);
  weight_grad_f32_kernel<<<grid, 256, 0, stream>>>(q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_grad_reduce(q, stream);
}

}  // namespace

// bytes of dynamic shared memory of one block of the forward: elem 2 the
// bf16 kernel's TcLayout (hg and H unused: its scores stay in registers),
// 4 the f32 kernel's F32Layout (hg heads a group)
extern "C" int fused_layer_smem_bytes(int S, int D, int F, int hg, int elem, int H) {
  if (elem == 2) return (int)TcLayout(S, D, F).total;
  return (int)F32Layout(S, D, H, F, hg).total;
}

// bytes of dynamic shared memory of one block of the f32 backward's pass 1
// (F32BwdLayout, hg heads a group)
extern "C" int fused_layer_bwd_smem_bytes(int S, int D, int H, int hg) {
  return (int)F32BwdLayout(S, D, H, hg).total;
}

// and of the bf16 backward's pass 1 (BwdTcLayout: seqs sequences a CTA, or
// a sequence on a cluster of ``cluster``; hg heads a stage)
extern "C" int fused_layer_bwd_tc_smem_bytes(int S, int D, int H, int F, int seqs, int cluster,
                                             int hg) {
  return (int)BwdTcLayout(S, D, H, F, seqs, cluster, hg).total;
}

// The clusters of ``cluster`` CTAs of one of the layer's kernels that the
// card holds at once (the occupancy API), or minus the CUDA error: kernel 0
// the f32 forward, 1 pass 1 of the f32 backward (hg heads a group), 2 the
// bf16 forward, 3 pass 1 of the bf16 backward (one sequence a cluster, hg
// heads a stage)
extern "C" int fused_layer_max_clusters(int kernel, int S, int D, int H, int F, int hg,
                                        int cluster) {
  size_t smem;
  const void* fn;
  int threads;
  switch (kernel) {
    case 0:
      smem = F32Layout(S, D, H, F, hg).total;
      fn = reinterpret_cast<const void*>(fused_layer_fwd_f32_kernel);
      threads = kThreads;
      break;
    case 1:
      smem = F32BwdLayout(S, D, H, hg).total;
      fn = reinterpret_cast<const void*>(fused_layer_bwd_rows_f32_kernel);
      threads = kThreads;
      break;
    case 2:
      smem = TcLayout(S, D, F).total;
      fn = reinterpret_cast<const void*>(fused_layer_fwd_tc_kernel<kFwdFull>);
      threads = kTcThreads;
      break;
    case 3:
      smem = BwdTcLayout(S, D, H, F, 1, cluster, hg).total;
      fn = reinterpret_cast<const void*>(fused_layer_bwd_rows_kernel<kBwdFull>);
      threads = kBwdTcThreads;
      break;
    default:
      return -(int)cudaErrorInvalidValue;
  }
  cudaError_t err = xrt::allow_smem(fn, smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, fn, &cfg);
  return err != cudaSuccess ? -(int)err : n;
}

// The layer, or with stage < kFwdFull a section variant (see the top of
// this file), for B sequences of S <= 64 rows, each on a cluster of
// ``cluster`` CTAs (bf16 1, 2 or 4; f32 1 to 4), heads_per_stage a divisor
// of H / cluster.  bf16: wp a workspace of WOffsets::total bf16; f32: wp
// unused.
extern "C" int fused_layer_fwd(
    const void* x, void* y, const int* mask, const float* qkv_w, const float* qkv_b,
    const float* out_w, const float* out_b, const float* ffn_in_w, const float* ffn_in_b,
    const float* ffn_out_w, const float* ffn_out_b, const float* ln1_s, const float* ln1_b,
    const float* ln2_s, const float* ln2_b, int B, int S, int D, int H, int F, int causal,
    int is_bf16, int heads_per_stage, int cluster, const long long* seeds,
    uint32_t attn_thr, uint32_t hidden_thr, float attn_keep, float hidden_keep,
    int attn_drop, int hidden_drop, float eps, int smem_bytes, int stage, void* wp,
    void* stream) {
  if (B <= 0) return cudaSuccess;
  if (S <= 0 || S > 64 || H <= 0 || D % H != 0 || heads_per_stage <= 0 || cluster < 1 ||
      cluster > kMaxCluster || H % cluster)
    return cudaErrorInvalidValue;
  if (stage == kStopFfnGelu && F < D) return cudaErrorInvalidValue;
  if (is_bf16) {
    // whole k-steps of the products and 8-column blocks of each CTA's
    // qkv columns; k-contiguous pairs in the attention
    if (cluster == 3 || D % 16 || D % (8 * cluster) || (D / H) % 2 || D / H > 64 || F % 16 ||
        wp == nullptr)
      return cudaErrorInvalidValue;
  } else if (D % (4 * cluster) || (D / H) % 4 || F % 4 || (H / cluster) % heads_per_stage) {
    // 16-byte rows and weight copies; each CTA's heads in groups
    return cudaErrorInvalidValue;
  }
  Params p{x, y, mask, qkv_w, qkv_b, out_w, out_b, ffn_in_w, ffn_in_b, ffn_out_w, ffn_out_b,
           ln1_s, ln1_b, ln2_s, ln2_b, S, D, H, F, causal, heads_per_stage,
           {seeds}, attn_thr, hidden_thr, attn_keep, hidden_keep,
           attn_drop, hidden_drop, eps, cluster};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* w = static_cast<bf16*>(wp);
  if (stage < kStopQkv || stage > kFwdFull) return cudaErrorInvalidValue;
  if (!is_bf16) return launch_f32(p, B, smem_bytes, stage, s);
  switch (stage) {
    case kStopQkv: return launch_tc<kStopQkv>(p, B, smem_bytes, w, s);
    case kStopAttn: return launch_tc<kStopAttn>(p, B, smem_bytes, w, s);
    case kStopOutLn1: return launch_tc<kStopOutLn1>(p, B, smem_bytes, w, s);
    case kStopFfnGelu: return launch_tc<kStopFfnGelu>(p, B, smem_bytes, w, s);
    default: return launch_tc<kFwdFull>(p, B, smem_bytes, w, s);
  }
}

// The backward of fused_layer_fwd: dx (T) and the 12 f32 parameter
// gradients, summed over the batch.  ws[17] is the workspace described in
// BwdParams, in its order, allocated by the caller, with ws_wpart (splits x
// WOffsets::total f32); bf16 also needs ws_duf and ws_wp (2 x
// WOffsets::total bf16: W and W^T packed), f32 neither.  cluster and
// heads_per_stage as the forward takes them (bf16: the planner's, with
// seqs); with stage < kBwdFull, pass 1's section variant alone,
// its stage's tensor in dx.
extern "C" int fused_layer_bwd(
    const void* x, const void* dy, const int* mask, const float* qkv_w, const float* qkv_b,
    const float* out_w, const float* out_b, const float* ffn_in_w, const float* ffn_in_b,
    const float* ffn_out_w, const float* ffn_out_b, const float* ln1_s, const float* ln1_b,
    const float* ln2_s, const float* ln2_b, void* dx, float* d_qkv_w, float* d_qkv_b,
    float* d_out_w, float* d_out_b, float* d_ffn_in_w, float* d_ffn_in_b, float* d_ffn_out_w,
    float* d_ffn_out_b, float* d_ln1_s, float* d_ln1_b, float* d_ln2_s, float* d_ln2_b,
    void* ws_qkv, void* ws_ctx, void* ws_x1, void* ws_u, void* ws_g, void* ws_h1, void* ws_h2,
    float* ws_stats, void* ws_dfm, void* ws_dum, void* ws_dam, void* ws_dqm, float* ws_dres,
    float* ws_duf, float* ws_partial, void* ws_wp, float* ws_wpart, int B, int S, int D,
    int H, int F, int causal, int is_bf16, int splits, int cluster, int heads_per_stage,
    int seqs, const long long* seeds, uint32_t attn_thr, uint32_t hidden_thr, float attn_keep,
    float hidden_keep_fwd, float hidden_keep_bwd, int attn_drop, int hidden_drop, float eps,
    int stage, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (S <= 0 || S > 64 || H <= 0 || D % H != 0) return cudaErrorInvalidValue;
  BwdParams p{x, dy, mask, qkv_w, qkv_b, out_w, out_b, ffn_in_w, ffn_in_b, ffn_out_w,
              ffn_out_b, ln1_s, ln1_b, ln2_s, ln2_b, dx, d_qkv_w, d_qkv_b, d_out_w, d_out_b,
              d_ffn_in_w, d_ffn_in_b, d_ffn_out_w, d_ffn_out_b, d_ln1_s, d_ln1_b, d_ln2_s,
              d_ln2_b, ws_qkv, ws_ctx, ws_x1, ws_u, ws_g, ws_h1, ws_h2, ws_stats, ws_dfm,
              ws_dum, ws_dam, ws_dqm, ws_dres, ws_duf, ws_partial, B, S, D, H, F, causal,
              {seeds}, attn_thr, hidden_thr, attn_keep, hidden_keep_fwd,
              hidden_keep_bwd, attn_drop, hidden_drop, eps};
  if (cluster < 1 || cluster > kMaxCluster || H % cluster || heads_per_stage <= 0 ||
      (H / cluster) % heads_per_stage || splits <= 0)
    return cudaErrorInvalidValue;
  p.cluster = cluster;
  p.hg = heads_per_stage;
  p.wpart = ws_wpart;
  p.splits = splits;
  if (is_bf16) {
    // whole k-steps of the products (W and W^T) and 8-column blocks of
    // each CTA's columns; a CTA's rows in four m-tiles at most; an even
    // head width (its pairs of columns; staged padded to 16)
    if (D % 16 || F % 16 || (D / H) % 2 || D % (8 * cluster) || seqs < 1 || seqs * S > 64 ||
        (seqs > 1 && cluster > 1) || ws_wp == nullptr || ws_duf == nullptr)
      return cudaErrorInvalidValue;
    p.wp = static_cast<uint2*>(ws_wp);
    p.seqs = seqs;
  } else if (D % (4 * cluster) || (D / H) % 4 || F % 4) {
    // 16-byte rows and copies; each CTA's D columns its heads' (D % (4 C))
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stage < kStopRecompute || stage > kBwdFull) return cudaErrorInvalidValue;
  if (!is_bf16) return launch_bwd_f32(p, stage, s);
  switch (stage) {
    case kStopRecompute: return launch_bwd_tc<kStopRecompute>(p, s);
    case kStopFfnBwd: return launch_bwd_tc<kStopFfnBwd>(p, s);
    case kStopAttnBwd: return launch_bwd_tc<kStopAttnBwd>(p, s);
    default: return launch_bwd_tc<kBwdFull>(p, s);
  }
}
