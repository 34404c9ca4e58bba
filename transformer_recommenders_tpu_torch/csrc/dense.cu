// The layer stack's dense on the tensor cores (#19): y = bf16(x w + b)
// with bf16 operands, f32 sums and an f32 bias, and its two gradients,
// dx = bf16(g w^T) and dW = bf16(x^T g) (held in f32) with db = sum_t g,
// as ``models/transformer.py`` ``_dense`` and its autograd compute them.
//
// No TPU kernel: the JAX package writes the dense as one ``jnp.dot`` with
// ``preferred_element_type=f32`` (models/transformer.py ``_dense``) that
// XLA runs on the MXU.  The port ran it as an f32 SIMT sgemm over widened
// copies of both operands, then an f32 bias add and a narrowing, four
// passes over memory and a 67 TFLOP/s pipe.  Here it is one product a
// pass on the bf16 tensor cores: at the scale shapes (T = 32,768-65,536
// rows, K and N 256-1024) it is bound by the products on tiles of 128 x
// 128, near the card's ridge, so the design keeps the bytes to one read of
// each operand and one write of the result.
//
// One kernel template, three operand layouts.  TMA stages 128 x 64 bf16
// tiles of both operands (128-byte swizzle) into a ring of kStages in
// shared memory, fed by one producer thread; two consumer warpgroups each
// run wgmma m64n128k16 over 64 rows of the tile, sums in f32 registers.
// The grid is persistent (one CTA an SM walks the tiles, columns fastest),
// so the producer loads the next tile while the consumers run this one's
// epilogue, and a bf16 result leaves through shared memory by TMA stores
// that run on while the next tile's products do (the forward at 65,536 x
// 256 x 768 on the H100: 0.063 ms, against 0.170 storing from registers).
//   forward: A = x (K-major), B = w (K, N) read N-major; the epilogue adds
//     the f32 bias and narrows to bf16 once, and writes y.
//   dgrad:   A = g (N-major, its reduction), B = w read K-major; writes dx.
//   wgrad:   A = x^T and B = g, both read along their rows (T, the
//     reduction, is their leading dimension); T is split for occupancy by
//     a count that follows from the shape and the card, each split writes
//     its f32 partial to a workspace, and a second pass sums the splits in
//     order, rounds dW to bf16 (the plain graph's rounding) and sums db's
//     partials, which the tiles of the first row of dW take from the g
//     tiles in shared memory.  No atomics: the bits do not change from run
//     to run.
// The forward and dgrad have no split: each output's K-loop runs in one
// order whatever M is, so a row's result does not depend on the batch.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kBK = 64;                          // reduction a stage: one 128-byte row
constexpr int kConsumers = 2;                    // consumer warpgroups, 64 output rows each
constexpr int kBM = 64 * kConsumers;             // output rows a tile
constexpr int kBN = 128;                         // output columns a tile
constexpr int kThreads = 128 * (kConsumers + 1);  // and one producer warpgroup
constexpr int kStages = 6;
constexpr int kTileA = kBM * kBK * 2;  // bytes
constexpr int kTileB = kBN * kBK * 2;
constexpr int kStageBytes = kTileA + kTileB;
constexpr int kBox = 64 * kBK * 2;  // one 64 x 64 box of a row-read operand
constexpr int kStaging = kBM * kBN * 2;  // the bf16 output tile, on its way to TMA stores
constexpr int kSmemBytes = kStages * kStageBytes + kStaging + 2 * kStages * 8 + 1024;
constexpr int kMinBlocksPerSplit = 4;  // k-blocks of a wgrad split, at least

enum Epilogue { kForward = 0, kDgrad = 1, kWgrad = 2 };

struct Plan {
  int m, n, k;  // the product's output rows and columns, and its reduction
  int tiles_m, tiles_n, splits, blocks_per_split;
};

struct Tile {
  int m0, n0, kb0, kb1, split;
  bool first_row;
};

__device__ __forceinline__ Tile tile_of(const Plan& p, int w) {
  const int per_split = p.tiles_m * p.tiles_n;
  const int split = w / per_split;
  const int rest = w - split * per_split;
  const int tm = rest / p.tiles_n;
  const int kblocks = (p.k + kBK - 1) / kBK;
  const int kb0 = split * p.blocks_per_split;
  return {tm * kBM, (rest - tm * p.tiles_n) * kBN, kb0,
          min(kb0 + p.blocks_per_split, kblocks), split, tm == 0};
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

// spins until the phase of ``parity`` completed; a wait that outlasts ~2^34
// cycles (~9 s) traps (a launch error, not a hung card)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// a 2-D box of ``map`` at (inner, outer) into shared memory, counted on bar
__device__ __forceinline__ void tma_load(const CUtensorMap* map, void* dst, uint64_t* bar,
                                         int inner, int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(inner), "r"(outer)
      : "memory");
}

// a 2-D box of shared memory to ``map`` at (inner, outer), in this thread's
// bulk group; rows and columns out of range are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int inner,
                                          int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(inner), "r"(outer)
      : "memory");
}

// the 128 threads of warpgroup ``wg`` meet (named barrier 1 + wg)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// a wgmma operand descriptor over 128-byte swizzled rows: start address,
// leading and stride byte offsets (16-byte units), layout 1 (128B swizzle)
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lead, uint32_t stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lead >> 4) << 16) |
         (static_cast<uint64_t>(stride >> 4) << 32) | (1ull << 62);
}

// The operand of k16 step ``step`` of a stage's tile at ``base``:
// a K-major tile is rows of 64 reduction elements (8-row groups 1024 bytes
// apart; a step is 32 bytes along the row); a row-read (MN-major) tile is
// 64 x 64 boxes, 64 reduction rows of 64 contiguous output elements each
// (boxes 8 KB apart; a step is 16 rows, 2048 bytes).
template <bool kMnMajor>
__device__ __forceinline__ uint64_t operand(uint32_t base, int step) {
  return kMnMajor ? descriptor(base + step * 2048, kBox, 1024)
                  : descriptor(base + step * 32, 16, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// the accumulators as the asm statements around them see them: no read or
// write of d moves across a fence
__device__ __forceinline__ void fence_operands(float (&d)[kBN / 2]) {
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128 f32, the warpgroup's) += A (64 x 16) B (16 x 128), bf16
template <bool kTransA, bool kTransB>
__device__ __forceinline__ void mma_64x128x16(float (&d)[kBN / 2], uint64_t desc_a,
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "n"(1), "n"(int(kTransA)), "n"(int(kTransB)));
}

// columns 2 c and 2 c + 1 of a row-read 128-wide g tile in shared memory,
// rows 16 q ... 16 q + 15 summed in order into s (the 128-byte swizzle:
// 16-byte chunk j of row r sits at chunk j ^ (r % 8))
__device__ __forceinline__ void column_pair_sum(const __nv_bfloat16* tile, int c, int q,
                                                float2& s) {
  const int col = 2 * c;
  const __nv_bfloat16* box = tile + (col / 64) * (kBox / 2);
  const int chunk = (col % 64) / 8, within = col % 8;
#pragma unroll
  for (int r = 16 * q; r < 16 * q + 16; ++r) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
        box + r * 64 + ((chunk ^ (r % 8)) * 8) + within));
    s.x += v.x;
    s.y += v.y;
  }
}

// kTransA/kTransB: the operand is read along its rows (MN-major), else
// along its reduction (K-major); see the file's head for the three uses.
// out: y or dx (bf16, m x n) or the split's f32 partial of dW (splits x m
// x n); db_part: the splits' f32 partials of db (wgrad only).
template <bool kTransA, bool kTransB, int kEpi>
__global__ void __launch_bounds__(kThreads, 1)
    dense_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b,
                      const __grid_constant__ CUtensorMap map_y, const Plan p,
                      const float* __restrict__ bias, void* __restrict__ out,
                      float* __restrict__ db_part) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* staging = smem + kStages * kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + kStaging);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int work = p.tiles_m * p.tiles_n * p.splits;
  const int wg = threadIdx.x / 128;

  if (wg == kConsumers) {  // the producer: one thread keeps the ring full
    if (threadIdx.x % 128 != 0) return;
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_a)));
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_b)));
    int stage = 0;
    uint32_t phase = 0;
    for (int w = blockIdx.x; w < work; w += gridDim.x) {
      const Tile t = tile_of(p, w);
      for (int kb = t.kb0; kb < t.kb1; ++kb) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], kStageBytes);
        uint8_t* a = smem + stage * kStageBytes;
        uint8_t* b = a + kTileA;
        if (kTransA) {
#pragma unroll
          for (int i = 0; i < kBM / 64; ++i)
            tma_load(&map_a, a + i * kBox, &full[stage], t.m0 + 64 * i, kb * kBK);
        } else {
          tma_load(&map_a, a, &full[stage], kb * kBK, t.m0);
        }
        if (kTransB) {
#pragma unroll
          for (int i = 0; i < kBN / 64; ++i)
            tma_load(&map_b, b + i * kBox, &full[stage], t.n0 + 64 * i, kb * kBK);
        } else {
          tma_load(&map_b, b, &full[stage], kb * kBK, t.n0);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns rows wg * 64 ... + 63 of each tile
  const int tid = threadIdx.x;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  int stage = 0;
  uint32_t phase = 0;
  for (int w = blockIdx.x; w < work; w += gridDim.x) {
    const Tile t = tile_of(p, w);
    // db: the first row of dW's tiles also sums their g tiles' columns, a
    // pair of columns and a quarter of the rows a consumer thread
    const bool sums = kEpi == kWgrad && t.first_row;
    float d[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) d[i] = 0.f;
    float2 colsum = make_float2(0.f, 0.f);
    int held = -1;  // the stage whose products may still be reading it
    for (int kb = t.kb0; kb < t.kb1; ++kb) {
      mbar_wait(&full[stage], phase);
      const uint8_t* a = smem + stage * kStageBytes;
      const uint32_t a_addr = smem_u32(a) + wg * (64 * kBK * 2);
      const uint32_t b_addr = smem_u32(a + kTileA);
      fence_operands(d);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j)
        mma_64x128x16<kTransA, kTransB>(d, operand<kTransA>(a_addr, j),
                                        operand<kTransB>(b_addr, j));
      wgmma_commit();
      fence_operands(d);
      if (sums)
        column_pair_sum(reinterpret_cast<const __nv_bfloat16*>(a + kTileA), tid % 64, tid / 64,
                        colsum);
      if (held >= 0) {
        wgmma_wait<1>();
        fence_operands(d);
        mbar_arrive(&empty[held]);
      }
      held = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_operands(d);
    if (held >= 0) mbar_arrive(&empty[held]);

    // the accumulator layout: warp w holds rows 16 w + lane / 4 (+ 8), and
    // of each 8 columns j the pair 8 j + 2 (lane % 4) (+ 1)
    const int r0 = warp * 16 + lane / 4;
    if constexpr (kEpi == kWgrad) {  // once a CTA: straight to the workspace
      const int row = t.m0 + wg * 64 + r0;
      const int col0 = t.n0 + 2 * (lane % 4);
      float* part = static_cast<float*>(out) + static_cast<size_t>(t.split) * p.m * p.n;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = col0 + 8 * j;
        if (col >= p.n) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row + 8 * h;
          if (r < p.m)
            *reinterpret_cast<float2*>(part + static_cast<size_t>(r) * p.n + col) =
                make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
        }
      }
      if (sums) {  // the quarters added in order through the (unused) staging
        float2* quarters = reinterpret_cast<float2*>(staging);
        quarters[(tid / 64) * 64 + tid % 64] = colsum;
        asm volatile("bar.sync 3, %0;\n" ::"n"(kConsumers * 128) : "memory");
        if (tid < 64 && t.n0 + 2 * tid < p.n) {
          float2 sum = quarters[tid];
#pragma unroll
          for (int q = 1; q < 4; ++q) {
            sum.x += quarters[q * 64 + tid].x;
            sum.y += quarters[q * 64 + tid].y;
          }
          *reinterpret_cast<float2*>(db_part + static_cast<size_t>(t.split) * p.n + t.n0 +
                                     2 * tid) = sum;
        }
        asm volatile("bar.sync 3, %0;\n" ::"n"(kConsumers * 128) : "memory");
      }
    } else {
      // the warpgroup's 64 x 128 bf16 rows go to shared memory as two 64 x
      // 64 boxes, 128-byte swizzled (a warp's 8 rows of one 16-byte chunk
      // fall on 32 banks), then out by TMA while the next tile runs
      const bool leader = tid % 128 == 0;
      uint8_t* mine = staging + wg * (kStaging / kConsumers);
      if (leader) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      warpgroup_sync(wg);  // the last tile's stores have read the staging
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int c = 8 * j + 2 * (lane % 4);
        float2 b = make_float2(0.f, 0.f);
        if constexpr (kEpi == kForward)
          if (t.n0 + c < p.n) b = __ldg(reinterpret_cast<const float2*>(bias + t.n0 + c));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          const int chunk = (j % 8) ^ (r % 8);
          *reinterpret_cast<__nv_bfloat162*>(mine + (j / 8) * kBox + r * 128 + chunk * 16 +
                                             (lane % 4) * 4) =
              __floats2bfloat162_rn(d[4 * j + 2 * h] + b.x, d[4 * j + 2 * h + 1] + b.y);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      warpgroup_sync(wg);
      if (leader) {
#pragma unroll
        for (int i = 0; i < kBN / 64; ++i)
          tma_store(&map_y, mine + i * kBox, t.n0 + 64 * i, t.m0 + wg * 64);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
  }
  if constexpr (kEpi != kWgrad)
    if (tid % 128 == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// dW = f32(bf16(the splits' partials summed in order)), 4 elements a
// thread; then db = its splits' partials summed in order
__global__ void __launch_bounds__(256)
    dense_wgrad_reduce_kernel(const float* __restrict__ part, const float* __restrict__ db_part,
                              float* __restrict__ dw, float* __restrict__ db, int splits,
                              int kn4, int n) {
  const int step = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < kn4 + n; i += step) {
    if (i < kn4) {
      const float4* p4 = reinterpret_cast<const float4*>(part);
      float4 s = __ldg(p4 + i);
      for (int k = 1; k < splits; ++k) {
        const float4 v = __ldg(p4 + static_cast<size_t>(k) * kn4 + i);
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      const auto round = [](float v) { return __bfloat162float(__float2bfloat16_rn(v)); };
      reinterpret_cast<float4*>(dw)[i] = make_float4(round(s.x), round(s.y), round(s.z), round(s.w));
    } else {
      const int c = i - kn4;
      float s = db_part[c];
      for (int k = 1; k < splits; ++k) s += db_part[static_cast<size_t>(k) * n + c];
      db[c] = s;
    }
  }
}

// the CUDA driver's functions the library calls, found once through the runtime
// (the library links no libcuda of its own)
struct Driver {
  CUresult (*encode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                     const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                     CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                     CUtensorMapFloatOOBfill);
  CUresult (*current)(CUcontext*);
  CUresult (*make_current)(CUcontext);
  CUresult (*stream_context)(CUstream, CUcontext*);
  bool ok;
};

template <typename F>
bool entry(const char* name, F* fn) {
  void* ptr = nullptr;
  cudaDriverEntryPointQueryResult found;
  const bool ok = cudaGetDriverEntryPoint(name, &ptr, cudaEnableDefault, &found) == cudaSuccess &&
                  found == cudaDriverEntryPointSuccess;
  *fn = reinterpret_cast<F>(ptr);
  return ok;
}

const Driver& driver() {
  static const Driver d = [] {
    Driver r{};
    r.ok = entry("cuTensorMapEncodeTiled", &r.encode) && entry("cuCtxGetCurrent", &r.current) &&
           entry("cuCtxSetCurrent", &r.make_current) &&
           entry("cuStreamGetCtx", &r.stream_context);
    return r;
  }();
  return d;
}

// A current context on this thread for the encoder, which needs one: a
// thread that has only launched kernels through the runtime (an autograd
// worker) may have none yet.  Then the stream's context is made current
// by the CUDA driver (no runtime call, so a stream capture is not disturbed),
// or for the legacy default stream the runtime's device.
bool bind(cudaStream_t stream) {
  const Driver& d = driver();
  if (!d.ok) return false;
  CUcontext ctx = nullptr;
  if (d.current(&ctx) == CUDA_SUCCESS && ctx != nullptr) return true;
  if (stream != nullptr) {
    return d.stream_context(reinterpret_cast<CUstream>(stream), &ctx) == CUDA_SUCCESS &&
           d.make_current(ctx) == CUDA_SUCCESS;
  }
  int dev = 0;
  return cudaGetDevice(&dev) == cudaSuccess && cudaSetDevice(dev) == cudaSuccess;
}

// a row-major bf16 (rows, cols) matrix, read in boxes of 64 columns by
// ``box_rows`` rows, 128-byte swizzled, out-of-range elements read as 0
bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const Driver& d = driver();
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return d.encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

int sm_count() {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

Plan plan(int m, int n, int k, int splits) {
  Plan p{m, n, k, (m + kBM - 1) / kBM, (n + kBN - 1) / kBN, 1, 0};
  const int kblocks = (k + kBK - 1) / kBK;
  p.blocks_per_split = (kblocks + splits - 1) / splits;
  p.splits = (kblocks + p.blocks_per_split - 1) / p.blocks_per_split;
  return p;
}

// the splits of T a wgrad takes: enough (tile, split) CTAs to fill the
// card once, each split at least kMinBlocksPerSplit blocks of 64 rows
int wgrad_splits(int t, int k, int n) {
  const int tiles = ((k + kBM - 1) / kBM) * ((n + kBN - 1) / kBN);
  const int kblocks = (t + kBK - 1) / kBK;
  const int want = std::max(1, sm_count() / tiles);
  const int per = std::max(kMinBlocksPerSplit, (kblocks + want - 1) / want);
  return (kblocks + per - 1) / per;
}

template <bool kTransA, bool kTransB, int kEpi>
cudaError_t launch(const CUtensorMap& map_a, const CUtensorMap& map_b, const CUtensorMap& map_y,
                   const Plan& p, const float* bias, void* out, float* db_part,
                   cudaStream_t stream) {
  auto kernel = dense_gemm_kernel<kTransA, kTransB, kEpi>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return attr;
  const int work = p.tiles_m * p.tiles_n * p.splits;
  kernel<<<std::min(work, sm_count()), kThreads, kSmemBytes, stream>>>(map_a, map_b, map_y, p,
                                                                     bias, out, db_part);
  return cudaGetLastError();
}

}  // namespace

// y (m, n) bf16 = bf16(x (m, k) bf16 . w (k, n) bf16 + bias (n) f32); k and
// n multiples of 8, every pointer 16-byte aligned
extern "C" int dense_fwd(const void* x, const void* w, const float* bias, void* y, int m, int k,
                         int n, void* stream) {
  if (m <= 0) return cudaSuccess;
  if (!bind(static_cast<cudaStream_t>(stream))) return cudaErrorInvalidDevice;
  CUtensorMap map_a, map_b, map_y;
  if (!make_map(&map_a, x, m, k, kBM) || !make_map(&map_b, w, k, n, 64) ||
      !make_map(&map_y, y, m, n, 64))
    return cudaErrorInvalidValue;
  return launch<false, true, kForward>(map_a, map_b, map_y, plan(m, n, k, 1), bias, y, nullptr,
                                       static_cast<cudaStream_t>(stream));
}

// dx (m, k) bf16 = bf16(g (m, n) bf16 . w (k, n)^T bf16)
extern "C" int dense_dgrad(const void* g, const void* w, void* dx, int m, int k, int n,
                           void* stream) {
  if (m <= 0) return cudaSuccess;
  if (!bind(static_cast<cudaStream_t>(stream))) return cudaErrorInvalidDevice;
  CUtensorMap map_a, map_b, map_y;
  if (!make_map(&map_a, g, m, n, kBM) || !make_map(&map_b, w, k, n, kBN) ||
      !make_map(&map_y, dx, m, k, 64))
    return cudaErrorInvalidValue;
  return launch<false, false, kDgrad>(map_a, map_b, map_y, plan(m, k, n, 1), nullptr, dx,
                                      nullptr, static_cast<cudaStream_t>(stream));
}

// the splits of T that dense_wgrad takes for x (t, k) and g (t, n): the
// workspace holds splits * k * n and splits * n floats
extern "C" int dense_wgrad_splits(int t, int k, int n) {
  return plan(k, n, t, wgrad_splits(t, k, n)).splits;
}

// dw (k, n) f32 = f32(bf16(x^T g)), db (n) f32 = sum over t of g, from x
// (t, k) and g (t, n) bf16; part and db_part: f32 workspaces of splits * k
// * n and splits * n (splits: dense_wgrad_splits)
extern "C" int dense_wgrad(const void* x, const void* g, float* part, float* db_part, float* dw,
                           float* db, int t, int k, int n, int splits, void* stream) {
  const Plan p = plan(k, n, t, wgrad_splits(t, k, n));
  if (t <= 0 || p.splits != splits) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bind(s)) return cudaErrorInvalidDevice;
  CUtensorMap map_a, map_b;
  if (!make_map(&map_a, x, t, k, 64) || !make_map(&map_b, g, t, n, 64))
    return cudaErrorInvalidValue;
  cudaError_t err = launch<true, true, kWgrad>(map_a, map_b, map_a, p, nullptr, part, db_part, s);
  if (err != cudaSuccess) return err;
  const int kn4 = k * n / 4;
  const int blocks = std::min((kn4 + n + 255) / 256, sm_count() * 8);
  dense_wgrad_reduce_kernel<<<blocks, 256, 0, s>>>(part, db_part, dw, db, splits, kn4, n);
  return cudaGetLastError();
}
