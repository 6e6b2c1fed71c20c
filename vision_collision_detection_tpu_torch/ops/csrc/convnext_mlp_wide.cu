// K3 for bf16 or float32 activations at the widths of ConvNeXt base's and
// large's last stage (C = 1024, 1536; the entry also takes 768): the
// ConvNeXt block after the depthwise conv,
//   out = x + gamma * (GELU(LN(y) @ W1 + b1) @ W2 + b2),
// eval and train variants of one entry.
//
// Replaces the same TPU kernels as convnext_mlp_wgmma.cu
// (vision_collision_detection_tpu/ops/convnext_mlp_pallas.py `_call` with
// `_eval_kernel` or `_train_kernel`, math `_ln_mlp`), with its roundings:
// LN with eps 1e-6 and two-pass float32 statistics, t = LN(y) rounded to
// bf16; products on bf16 with float32 accumulation; h_pre = t @ W1 + b1
// rounded to bf16; GELU (tanh or erf) in float32, rounded to bf16 (the erf
// form by a branch-free approximation, `gelu_erf`); the residual added in
// float32 and stored in x's dtype. The train variant also writes t, h_pre
// and m = h @ W2 + b2 in bf16; out uses the float32 m. float32 activations
// change only what is read and written at the ends: y is read as float32
// by the LayerNorm row kernel (t is bf16 in both dtypes), and GEMM 2 reads
// x and writes out as float32.
//
// Bound on the H100: operations (16*C^2 flops a row: 164 GFLOP at
// [9800, 1024], 0.166 ms; 370 GFLOP at [9800, 1536], 0.374 ms).
//
// Why not the fused design of convnext_mlp_wgmma.cu. It keeps a row
// block's [64, C] t in shared memory and its [64, C] float32 output in
// registers for the whole hidden dimension. At C = 1536 t alone is 192 KB
// of the block's 227 KB, and at C = 1024 the accumulator alone is 256 KB,
// the whole register file; walking the hidden dimension in several passes
// would recompute the first product each pass. The mma.sync kernel of
// convnext_mlp.cu fits by taking 16 rows a block, and then streams all of
// W1 and W2 from L2 for every 16 rows: bound by L2, at 6% of the card's
// rate.
//
// Design. The chain is split where the arithmetic is: both products are
// large GEMMs ([M, C] x [C, 4C] and [M, 4C] x [4C, C]), so three launches
// on one stream:
//   1. a row kernel writes t = LN(y) [M, C] in bf16 (a warp a row; the
//      eval variant writes it to scratch, the train variant keeps it);
//   2. GEMM 1, h_pre = t @ W1^T + b1, epilogue: bf16, GELU in float32, bf16;
//      it writes h [M, 4C] (scratch) and, in the train variant, h_pre;
//   3. GEMM 2, m = h @ W2^T + b2, epilogue: out = x + gamma * m (and m in
//      bf16 in the train variant).
// t and h pass through device memory: 20*M*C bytes, about 60 us at
// C = 1024 and 90 us at 1536 against the 0.166 and 0.374 ms of flops, and
// no product is recomputed. Both GEMMs read their operands K-major, W1 and
// W2 in nn.Linear's own storage ([4C, C] and [C, 4C]), as wgmma's
// shared-memory operands in 128-byte-swizzled tiles that TMA writes.
//
// A GEMM block is persistent (one per SM, output tiles taken in turn,
// columns fastest so that the blocks of one round share their rows of A in
// L2): one producer warp keeps a 192 KB ring of [128 + BN] x 64 stages in
// flight through mbarriers; two consumer warpgroups each multiply 64 rows
// of the 128-row tile by all BN columns (m64nBNk16, the float32 tile in
// registers) and keep one stage's products in flight behind the newest.
// - L2. A 128 x 256 tile does 85 flops a byte it reads from L2, which at
//   the card's rate would take about 11 TB/s of L2 reads, more than L2
//   gives; so the blocks run in clusters of two that take neighbouring row
//   tiles of one column tile, and each loads half of the B tile by a TMA
//   multicast into both: a third less L2 traffic (the products alone ran
//   at 580-730 TFLOP/s without it and 730-950 with it).
// - The epilogue. Written from registers to device memory, 4 bytes a
//   thread and eight rows a warp instruction, the results took longer than
//   the products. So the epilogue stages 128 x 128 of a result at a time
//   in two swizzled tiles in shared memory (each warp's 32 words on 32
//   banks) that one thread stores by TMA, and GEMM 2 has TMA load the
//   residual x into the same tiles (its first half while the products
//   run) and computes out in place. The stores run behind the next pass
//   and the next tile; rows past M are neither loaded nor stored.
// - GELU's erf form is a branch-free approximation (`gelu_erf`): erff
//   took 0.07 ms of GEMM 1 at [9800, 1024].
// - float32 x and out. A 128-byte swizzled row holds 32 float32 columns,
//   not 64, so the same two staging tiles hold 64 columns of out, not 128:
//   GEMM 2's float32 epilogue stages F32_ROUND = 64 columns a round, twice
//   the rounds at the same bytes, and the ring keeps all its stages. (The
//   other choice, 128 columns a round in four tiles with one ring stage
//   less, is F32_ROUND = 128; scripts/ab_convnext_mlp_wide_variants.py
//   times the two.) The saved m stays bf16, 128 columns a round.
// BN is 256 or 128, chosen per GEMM by how evenly the tiles fill the
// resident clusters' rounds (`pick_tile_n`). No split of the depth and no
// atomics: two calls are bit-equal, and eval and train run the same code
// (the train variant's extra passes are a runtime choice), so their out is
// bit-equal.
#include <type_traits>

#include "convnext_mlp_common.cuh"
#include "hopper.cuh"

namespace {

using namespace vcd;

constexpr int BM = 128;  // rows of an output tile: two warpgroups of 64
constexpr int BK = 64;   // depth of a stage: one 128-byte swizzled row
constexpr int CONSUMERS = 2;
constexpr int CLUSTER = 2;  // blocks that share each B tile
// Columns of float32 out (and of x) that one round of GEMM 2's float32
// epilogue stages: 64 fill the two tiles that bf16 fills with 128.
constexpr int F32_ROUND = 64;

// GELU's form in GEMM 1's epilogue (UP_*); GEMM 2's epilogue writing bf16
// out (DOWN) or float32 out (DOWN_F32).
enum Mode { UP_TANH, UP_ERF, DOWN, DOWN_F32 };

// What an epilogue round stages: ROUND columns of a result of type T (out
// in GEMM 2, h in GEMM 1) in TILES swizzled tiles of BM rows of 128 bytes.
// STAGING: the tiles' bytes, which also hold 128 columns of a bf16 result
// (the saved h_pre or m).
template <int MODE>
struct Out {
  using T = std::conditional_t<MODE == DOWN_F32, float, bf16>;
  static constexpr int ROUND = MODE == DOWN_F32 ? F32_ROUND : 128;
  static constexpr int TILE_COLS = 128 / (int)sizeof(T);
  static constexpr int TILES = ROUND / TILE_COLS;
  static constexpr int STAGING =
      (TILES > 2 ? TILES : 2) * BM * 128;
};

// The ring takes 192 KB, or what the staging tiles leave of 227 KB: four
// stages of [128 + 256] x 64 or six of [128 + 128] x 64 beside 32 KB of
// staging tiles. The epilogue stages a result in those tiles that TMA
// stores, and that TMA first fills with the residual x in GEMM 2.
template <int BN, int STAGING>
struct Gemm {
  static constexpr int A_BYTES = BM * 128;
  static constexpr int STAGE = A_BYTES + BN * 128;
  static constexpr int RING_MAX = 232448 - 1024 - 256 - STAGING;
  static constexpr int STAGES =
      (RING_MAX < 196608 ? RING_MAX : 196608) / STAGE;
  static constexpr int OUT = STAGES * STAGE;  // the staging tiles
  static constexpr int FULL = OUT + STAGING, EMPTY = FULL + 8 * STAGES;
  static constexpr int X_FULL = EMPTY + 8 * STAGES;  // x's load
  static constexpr int DYNAMIC = X_FULL + 8 + 1024;
  static_assert(DYNAMIC <= 232448, "shared memory of one block");
};
constexpr int THREADS = (CONSUMERS + 1) * 128;

// ---- wgmma m64nBNk16, both operands K-major swizzled tiles -----------------

#define VCD_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define VCD_F16(d, i) \
  VCD_F4(d, i), VCD_F4(d, i + 4), VCD_F4(d, i + 8), VCD_F4(d, i + 12)
#define VCD_F64(d, i) \
  VCD_F16(d, i), VCD_F16(d, i + 16), VCD_F16(d, i + 32), VCD_F16(d, i + 48)
#define VCD_LIST64                                                      \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define VCD_LIST128_HI                                                   \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, "    \
  "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "    \
  "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, " \
  "%103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, "   \
  "%114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "   \
  "%125, %126, %127"

// d[64 x BN] (+)= A[64 x 16] · B[16 x BN], float32 += bf16 · bf16. A warp
// holds its 16 rows as BN/8 groups of four: d[4j], d[4j + 1] at row
// lane / 4, columns 8j + 2 (lane % 4) and the next; d[4j + 2], d[4j + 3]
// eight rows further down. With `accumulate` 0 the product replaces d.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" VCD_LIST64 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : VCD_F64(d, 0)
      : "l"(a), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{" VCD_LIST64 ", " VCD_LIST128_HI "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : VCD_F64(d, 0), VCD_F64(d, 64)
      : "l"(a), "l"(b), "r"(accumulate));
}

// Pins the accumulator here (see acc_fence in hopper.cuh).
__device__ __forceinline__ void fence(float (&d)[64]) {
  asm volatile("" : VCD_F64(d, 0)::"memory");
}
__device__ __forceinline__ void fence(float (&d)[128]) {
  asm volatile("" : VCD_F64(d, 0), VCD_F64(d, 64)::"memory");
}

// ---- the epilogues -------------------------------------------------------

// GELU's erf form without erff: 1 + erf(x) by Abramowitz and Stegun 7.1.26,
// erfc(|x|) = poly(t) exp(-x^2) with t = 1 / (1 + p |x|) (absolute error
// under 1.5e-7, far under h's bf16 rounding), branch-free. erff's branches
// and longer polynomial made GELU 0.07 ms of GEMM 1 at [9800, 1024], more
// than the stores of h; this is a dozen instructions, as the tanh form.
__device__ __forceinline__ float gelu_erf(float v) {
  const float ax = fabsf(v) * 0.7071067811865476f;
  const float t = __fdividef(1.0f, fmaf(0.3275911f, ax, 1.0f));
  float poly = fmaf(1.061405429f, t, -1.453152027f);
  poly = fmaf(poly, t, 1.421413741f);
  poly = fmaf(poly, t, -0.284496736f);
  poly = fmaf(poly, t, 0.254829592f) * t;
  const float erfc = poly * __expf(-ax * ax);
  return 0.5f * v * (v >= 0.0f ? 2.0f - erfc : erfc);
}
template <bool APPROX>
__device__ __forceinline__ float gelu_fast(float v) {
  if constexpr (APPROX)
    return gelu<true>(v);
  else
    return gelu_erf(v);
}

// GEMM 1 (UP): h_pre = acc + b1 rounded to bf16 (stored too where `saved`),
// h = GELU(h_pre) rounded to bf16 (the output). GEMM 2 (DOWN, DOWN_F32):
// m = acc + b2 (stored in bf16 where `saved`), out = x + gamma * m in x's
// dtype.

struct Epilogue {
  const float* bias;   // b1 [N] or b2 [N]
  const float* gamma;  // DOWN: [N]
  int saved;           // the train variant: h_pre (UP) or m (DOWN) too
};

// Byte offset in the staging tiles of a thread's two columns cr = 8j + 2tg
// of staging row r, for values of type T: tile cr / (128 / sizeof(T)), its
// 16-byte chunk of row r swizzled as TMA reads it. bf16: the eight rows of
// a warp's store fall on eight chunks, so its 32 words hit 32 banks;
// float32: its 256 bytes take two wavefronts, each bank hit twice.
template <typename T>
__device__ __forceinline__ int staged(int r, int cr) {
  constexpr int TC = 128 / (int)sizeof(T), E = 16 / (int)sizeof(T);
  return (cr / TC) * (BM * 128) + sw128_chunk(r, (cr % TC) / E) +
         (int)sizeof(T) * (cr % E);
}

// What the two consumer warpgroups share in the epilogue: the staging
// tiles, the residual's barrier and its uses so far, and the thread that
// issues the TMA transfers.
struct Staging {
  unsigned char* tiles;
  unsigned addr, x_full;
  int x_uses;
  bool leader;

  // The stores of the last pass have read the tiles: they may be written.
  __device__ __forceinline__ void wait_free() {
    if (leader) tma_store_wait_read();
    named_barrier(1, CONSUMERS * 128);
  }
  // Every thread has written its part: store the TILES tiles of TC
  // columns each at (col, row).
  template <int TILES, int TC>
  __device__ __forceinline__ void store(const CUtensorMap* map, int col,
                                        int row) {
    fence_proxy_async();
    named_barrier(1, CONSUMERS * 128);
    if (leader) {
#pragma unroll
      for (int i = 0; i < TILES; ++i)
        tma_store_2d(map, addr + i * BM * 128, col + i * TC, row);
    }
  }
  // The leader's load of a round of x (O::ROUND columns at (col, row)) into
  // the tiles, once they are free.
  template <typename O>
  __device__ __forceinline__ void load_x(const CUtensorMap* map, int col,
                                         int row) {
    mbar_arrive_expect(x_full, O::TILES * BM * 128);
#pragma unroll
    for (int i = 0; i < O::TILES; ++i)
      tma_load_2d(addr + i * BM * 128, map, x_full, col + i * O::TILE_COLS,
                  row);
  }
};

// The tile's epilogue, 128 columns at a time: this thread's rows r and
// r + 8 of the tile (r = its warpgroup's 64 rows, its warp's 16, lane / 4),
// its columns 2 tg and the next of every group of eight. In GEMM 2 the
// leader has already asked for x's first round (at the tile's start); out
// is computed in place over x in the tiles, a round (Out<MODE>::ROUND
// columns) at a time.
template <int MODE, int BN>
__device__ __forceinline__ void epilogue(
    const float (&acc)[BN / 2], const Epilogue& ep, Staging& st,
    const CUtensorMap* map_out, const CUtensorMap* map_saved,
    const CUtensorMap* map_x, int r, int tg, int row0, int col0) {
  using O = Out<MODE>;
#pragma unroll
  for (int hc = 0; hc < BN / 128; ++hc) {
    const int c0 = col0 + 128 * hc;
    // the bf16 result of acc + bias over these 128 columns into the tiles,
    // after `f` of it
    auto write = [&](auto f) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int jj = 16 * hc + j, c = c0 + 8 * j + 2 * tg;
        const float2 bias = __ldg(reinterpret_cast<const float2*>(ep.bias + c));
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<__nv_bfloat162*>(
              st.tiles + staged<bf16>(r + 8 * half, 8 * j + 2 * tg)) =
              f(acc[4 * jj + 2 * half] + bias.x,
                acc[4 * jj + 2 * half + 1] + bias.y);
      }
    };
    auto to_bf16 = [](float v0, float v1) {
      return __floats2bfloat162_rn(v0, v1);
    };
    if constexpr (MODE == DOWN || MODE == DOWN_F32) {
      using T = typename O::T;
#pragma unroll
      for (int rd = 0; rd < 128 / O::ROUND; ++rd) {
        const int cr0 = rd * O::ROUND;  // the round's first column
        if (hc > 0 || rd > 0) {
          st.wait_free();
          if (st.leader) st.load_x<O>(map_x, c0 + cr0, row0);
        }
        mbar_wait(st.x_full, st.x_uses++ & 1);
#pragma unroll
        for (int j = 0; j < O::ROUND / 8; ++j) {
          const int jj = 16 * hc + cr0 / 8 + j, cr = 8 * j + 2 * tg;
          const int c = c0 + cr0 + cr;
          const float2 bias =
              __ldg(reinterpret_cast<const float2*>(ep.bias + c));
          const float2 g = __ldg(reinterpret_cast<const float2*>(ep.gamma + c));
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float m0 = acc[4 * jj + 2 * half] + bias.x;
            const float m1 = acc[4 * jj + 2 * half + 1] + bias.y;
            unsigned char* at = st.tiles + staged<T>(r + 8 * half, cr);
            if constexpr (MODE == DOWN_F32) {
              float2* o = reinterpret_cast<float2*>(at);
              const float2 x = *o;
              *o = make_float2(x.x + g.x * m0, x.y + g.y * m1);
            } else {
              __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(at);
              const float2 x = __bfloat1622float2(*o);
              *o = __floats2bfloat162_rn(x.x + g.x * m0, x.y + g.y * m1);
            }
          }
        }
        st.store<O::TILES, O::TILE_COLS>(map_out, c0 + cr0, row0);
      }
      if (ep.saved) {
        st.wait_free();
        write(to_bf16);
        st.store<2, 64>(map_saved, c0, row0);
      }
    } else {
      if (ep.saved) {
        st.wait_free();
        write(to_bf16);
        st.store<2, 64>(map_saved, c0, row0);
      }
      st.wait_free();
      write([](float v0, float v1) {
        const float2 hf =
            __bfloat1622float2(__floats2bfloat162_rn(v0, v1));
        constexpr bool APPROX = MODE == UP_TANH;
        return __floats2bfloat162_rn(gelu_fast<APPROX>(hf.x),
                                     gelu_fast<APPROX>(hf.y));
      });
      st.store<2, 64>(map_out, c0, row0);
    }
  }
}

// ---- clusters -------------------------------------------------------------

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// Every thread of every block of the cluster: the writes before it (the
// barriers' initialisation) are seen by all blocks after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
// An arrival on the mbarrier at this block's shared address `bar`, in the
// block of rank `rank` of the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(unsigned bar,
                                                    unsigned rank) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}
// tma_load_2d into the same shared address of every block in `mask`, its
// bytes completing on the mbarrier at the same address in each.
__device__ __forceinline__ void tma_load_2d_multicast(unsigned dst,
                                                      const void* map,
                                                      unsigned bar, int c0,
                                                      int c1,
                                                      unsigned short mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(
          dst),
      "l"(map), "r"(bar), "r"(c0), "r"(c1), "h"(mask)
      : "memory");
}

// ---- the GEMM: [M, K] x [N, K]^T, both K-major ---------------------------

// The CLUSTER blocks of a cluster take CLUSTER neighbouring row tiles of
// one column tile together: each loads its own rows of A and 1/CLUSTER of
// the shared B tile, which TMA writes into every block of the cluster, so
// each byte of B leaves L2 once for CLUSTER tiles. A stage is free again
// once the consumers of every block have handed it back.
template <int BN, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
wide_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 const __grid_constant__ CUtensorMap map_out,
                 const __grid_constant__ CUtensorMap map_saved,
                 const __grid_constant__ CUtensorMap map_x, Epilogue ep,
                 int M, int N, int K) {
  using G = Gemm<BN, Out<MODE>::STAGING>;
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = smem_u32(smem_raw);
  const unsigned base = (raw + 1023u) & ~1023u;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col_tiles = N / BN;
  // tiles of CLUSTER x BM rows, taken by the clusters in turn
  const int tiles =
      (M + CLUSTER * BM - 1) / (CLUSTER * BM) * col_tiles;
  const int k_tiles = K / BK;
  const unsigned rank = CLUSTER > 1 ? cluster_rank() : 0;
  const int cluster = blockIdx.x / CLUSTER, clusters = gridDim.x / CLUSTER;

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(base + G::FULL + 8 * s, 1);
      // a lane of each consumer warp of each block
      mbar_init(base + G::EMPTY + 8 * s, 4 * CONSUMERS * CLUSTER);
    }
    mbar_init(base + G::X_FULL, 1);
    mbar_init_fence();
  }
  cluster_sync();

  if (warp >= 4 * CONSUMERS) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 4 * CONSUMERS * 32) {
      // the producer: every stage of every tile of this block, in order
      constexpr int B_PART = BN / CLUSTER;  // rows of B this block loads
      int g = 0;
      for (int tile = cluster; tile < tiles; tile += clusters) {
        const int row0 = (tile / col_tiles * CLUSTER + rank) * BM;
        const int col0 = tile % col_tiles * BN;
        for (int kt = 0; kt < k_tiles; ++kt, ++g) {
          const int s = g % G::STAGES;
          mbar_wait(base + G::EMPTY + 8 * s, ((g / G::STAGES) & 1) ^ 1);
          const unsigned full = base + G::FULL + 8 * s;
          const unsigned a = base + s * G::STAGE;
          mbar_arrive_expect(full, G::STAGE);
          tma_load_2d(a, &map_a, full, kt * BK, row0);
          const unsigned b = a + G::A_BYTES + rank * B_PART * 128;
          if constexpr (CLUSTER > 1)
            tma_load_2d_multicast(b, &map_b, full, kt * BK,
                                  col0 + rank * B_PART,
                                  (1 << CLUSTER) - 1);
          else
            tma_load_2d(b, &map_b, full, kt * BK, col0);
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int wg = warp / 4;
    auto release = [&](int g) {
      __syncwarp();
      const unsigned bar = base + G::EMPTY + 8 * (g % G::STAGES);
      if (lane == 0) {
        if constexpr (CLUSTER > 1)
          for (int r = 0; r < CLUSTER; ++r) mbar_arrive_cluster(bar, r);
        else
          mbar_arrive(bar);
      }
    };
    Staging st{smem_raw + (base - raw) + G::OUT, base + G::OUT,
               base + G::X_FULL, 0, threadIdx.x == 0};
    float acc[BN / 2];
    int g = 0;
    for (int tile = cluster; tile < tiles; tile += clusters) {
      const int row0 = (tile / col_tiles * CLUSTER + rank) * BM;
      const int col0 = tile % col_tiles * BN;
      // GEMM 2: x's first 128 columns load while the products run, once
      // the last tile's stores have read the staging tiles
      if ((MODE == DOWN || MODE == DOWN_F32) && st.leader) {
        tma_store_wait_read();
        st.load_x<Out<MODE>>(&map_x, col0, row0);
      }
      fence(acc);
      for (int kt = 0; kt < k_tiles; ++kt, ++g) {
        const int s = g % G::STAGES;
        mbar_wait(base + G::FULL + 8 * s, (g / G::STAGES) & 1);
        const unsigned a = base + s * G::STAGE;
        // this warpgroup's 64 rows of A; a k-step of 16 is 32 bytes, two
        // descriptor units
        const uint64_t da = sw128_desc(a + wg * 64 * 128);
        const uint64_t db = sw128_desc(a + G::A_BYTES);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks)
          wgmma_ss(acc, da + 2 * ks, db + 2 * ks, kt > 0 || ks > 0);
        wgmma_commit();
        // the stage before this one is read: hand it back
        wgmma_wait<1>();
        fence(acc);
        if (kt > 0) release(g - 1);
      }
      wgmma_wait<0>();
      fence(acc);
      release(g - 1);
      epilogue<MODE, BN>(acc, ep, st, &map_out, &map_saved, &map_x,
                         wg * 64 + (warp % 4) * 16 + lane / 4, lane % 4,
                         row0, col0);
    }
    // the staging tiles stay until the last stores are done
    if (st.leader) tma_store_wait();
  }
  // no block leaves while another may still arrive on its barriers
  __syncwarp();
  cluster_sync();
}

// ---- LayerNorm: a warp a row ---------------------------------------------

// Eight values of y from 16 (bf16) or 32 (float32) bytes, as float32.
__device__ __forceinline__ void load8(const bf16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 v = __bfloat1622float2(b[k]);
    f[2 * k] = v.x;
    f[2 * k + 1] = v.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

// t = LN(y) rounded to bf16, rows of C = 256 * PER_LANE of y in bf16 or
// float32: lane l holds the 8-column vectors l, l + 32, ... of its row.
template <typename T, int PER_LANE>
__global__ void __launch_bounds__(256)
wide_ln_kernel(const T* __restrict__ y, const float* __restrict__ ln_w,
               const float* __restrict__ ln_b, bf16* __restrict__ t, int M) {
  constexpr int C = 256 * PER_LANE;
  const int lane = threadIdx.x % 32;
  const int64_t row = (int64_t)blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= M) return;
  uint4* tr = reinterpret_cast<uint4*>(t + row * C);
  float v[PER_LANE][8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    load8(y + row * C + (lane + 32 * i) * 8, v[i]);
#pragma unroll
    for (int k = 0; k < 4; ++k) s += v[i][2 * k] + v[i][2 * k + 1];
  }
  const float mu = warp_sum(s) / C;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) q += (v[i][e] - mu) * (v[i][e] - mu);
  const float rstd = rsqrtf(warp_sum(q) / C + LN_EPS);
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const int c = (lane + 32 * i) * 8;
    const float4 w0 = *reinterpret_cast<const float4*>(ln_w + c);
    const float4 w1 = *reinterpret_cast<const float4*>(ln_w + c + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(ln_b + c);
    const float4 b1 = *reinterpret_cast<const float4*>(ln_b + c + 4);
    const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    float o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = (v[i][e] - mu) * rstd * w[e] + b[e];
    tr[lane + 32 * i] =
        make_uint4(pack_bf16(o[0], o[1]), pack_bf16(o[2], o[3]),
                   pack_bf16(o[4], o[5]), pack_bf16(o[6], o[7]));
  }
}

// ---- host ------------------------------------------------------------------

// The GEMM kernel's launch: a grid of as many clusters as can be resident
// at once (found once per kernel), at most one per tile.
template <int BN, int MODE>
struct Launch {
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute attr[1];
  int clusters = 0;
  cudaError_t err;

  explicit Launch(cudaStream_t stream) {
    auto kernel = wide_gemm_kernel<BN, MODE>;
    using G = Gemm<BN, Out<MODE>::STAGING>;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               G::DYNAMIC);
    // all of the SM's 228 KB as shared memory
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.blockDim = dim3(THREADS);
    config.dynamicSmemBytes = G::DYNAMIC;
    config.stream = stream;
    config.attrs = attr;
    config.numAttrs = 1;
    static int resident = 0;  // clusters resident at once, per kernel
    if (err == cudaSuccess && resident == 0) {
      config.gridDim = dim3(CLUSTER);
      err = cudaOccupancyMaxActiveClusters(&resident, kernel, &config);
      if (err == cudaSuccess && resident < 1) err = cudaErrorInvalidValue;
    }
    clusters = resident;
  }
};

// The tile width whose rounds over the resident clusters take the least
// time, a round counted as BN (a round of 128-wide tiles does half the
// work of one of 256); a tie takes 256.
int pick_tile_n(int M, int N, int clusters) {
  const int row_tiles = (M + CLUSTER * BM - 1) / (CLUSTER * BM);
  const long wide =
      (long)((row_tiles * (N / 256) + clusters - 1) / clusters) * 256;
  const long narrow =
      (long)((row_tiles * (N / 128) + clusters - 1) / clusters) * 128;
  return narrow < wide ? 128 : 256;
}

// One GEMM launch: A [M, K] and B [N, K] bf16, row-major; the epilogue's
// output and x (GEMM 2) [M, N] in bf16, or float32 in DOWN_F32; `saved`
// (or null) bf16 [M, N].
template <int BN, int MODE>
cudaError_t gemm(const void* a, const void* b, void* out, void* saved,
                 const void* x, const Epilogue& ep, int M, int N, int K,
                 cudaStream_t stream) {
  Launch<BN, MODE> launch(stream);
  if (launch.err != cudaSuccess) return launch.err;
  CUtensorMap ma, mb, mo, ms, mx;
  const cuuint64_t da[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t db[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t dout[2] = {(cuuint64_t)N, (cuuint64_t)M};
  using O = Out<MODE>;
  const CUtensorMapDataType out_type = MODE == DOWN_F32
                                           ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t stride[1] = {(cuuint64_t)K * 2};
  const cuuint64_t out_stride[1] = {(cuuint64_t)N * sizeof(typename O::T)};
  const cuuint64_t saved_stride[1] = {(cuuint64_t)N * 2};
  const cuuint32_t box_a[2] = {BK, BM}, box_b[2] = {BK, BN / CLUSTER};
  const cuuint32_t box_out[2] = {(cuuint32_t)O::TILE_COLS, BM};
  const cuuint32_t box_saved[2] = {64, BM};
  cudaError_t err;
  if ((err = make_bf16_map(&ma, a, 2, da, stride, box_a)) != cudaSuccess ||
      (err = make_bf16_map(&mb, b, 2, db, stride, box_b)) != cudaSuccess ||
      (err = make_map(&mo, out_type, out, 2, dout, out_stride, box_out)) !=
          cudaSuccess ||
      (err = make_bf16_map(&ms, saved ? saved : out, 2, dout, saved_stride,
                           box_saved)) != cudaSuccess ||
      (err = make_map(&mx, out_type, x ? x : out, 2, dout, out_stride,
                      box_out)) != cudaSuccess)
    return err;
  const int tiles =
      (M + CLUSTER * BM - 1) / (CLUSTER * BM) * (N / BN);
  launch.config.gridDim =
      dim3(CLUSTER * (tiles < launch.clusters ? tiles : launch.clusters));
  err = cudaLaunchKernelEx(&launch.config, wide_gemm_kernel<BN, MODE>, ma,
                           mb, mo, ms, mx, ep, M, N, K);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int MODE>
cudaError_t gemm_any(const void* a, const void* b, void* out, void* saved,
                     const void* x, const Epilogue& ep, int M, int N, int K,
                     cudaStream_t stream) {
  Launch<256, MODE> launch(stream);
  if (launch.err != cudaSuccess) return launch.err;
  return pick_tile_n(M, N, launch.clusters) == 128
             ? gemm<128, MODE>(a, b, out, saved, x, ep, M, N, K, stream)
             : gemm<256, MODE>(a, b, out, saved, x, ep, M, N, K, stream);
}

template <typename T>
cudaError_t layer_norm(const void* y, const void* ln_w, const void* ln_b,
                       void* t, int M, int C, cudaStream_t stream) {
  const int blocks = (M + 7) / 8;
  const T* yt = (const T*)y;
  const float *w = (const float*)ln_w, *b = (const float*)ln_b;
  switch (C) {
    case 768:
      wide_ln_kernel<T, 3><<<blocks, 256, 0, stream>>>(yt, w, b, (bf16*)t, M);
      break;
    case 1024:
      wide_ln_kernel<T, 4><<<blocks, 256, 0, stream>>>(yt, w, b, (bf16*)t, M);
      break;
    default:
      wide_ln_kernel<T, 6><<<blocks, 256, 0, stream>>>(yt, w, b, (bf16*)t, M);
  }
  return cudaGetLastError();
}

}  // namespace

// The stages of one call, as bits of `stages`: LN, GEMM 1, GEMM 2 (7: the
// whole block). A stage reads what the stages before it write.
//
// dtype: 0 = bfloat16, 1 = float32, the dtype of x, y and out [M, C]; t:
// bf16 [M, C]; h, h_pre: bf16 [M, 4C]; m: bf16 [M, C]; all contiguous and
// 16-byte aligned. ln_w, ln_b, b2, gamma: float32 [C]; b1: float32 [4C];
// w1: bf16 [4C, C] and w2: bf16 [C, 4C], nn.Linear's layout. t and h are
// the caller's scratch (t is the train variant's saved t); h_pre and m are
// null in the eval variant, and given in the train variant. C is 768, 1024
// or 1536.
extern "C" int vcd_convnext_mlp_wide(
    const void* x, const void* y, const void* ln_w, const void* ln_b,
    const void* w1, const void* b1, const void* w2, const void* b2,
    const void* gamma, void* out, void* t, void* h, void* h_pre, void* m,
    int M, int C, int approximate, int dtype, int stages, void* stream_) {
  if (M < 0 || (C != 768 && C != 1024 && C != 1536) || stages < 1 ||
      stages > 7 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  const cudaStream_t stream = (cudaStream_t)stream_;
  cudaError_t err;
  if ((stages & 1) &&
      (err = dtype ? layer_norm<float>(y, ln_w, ln_b, t, M, C, stream)
                   : layer_norm<bf16>(y, ln_w, ln_b, t, M, C, stream)) !=
          cudaSuccess)
    return (int)err;
  if (stages & 2) {
    const Epilogue up{(const float*)b1, nullptr, h_pre != nullptr};
    err = approximate ? gemm_any<UP_TANH>(t, w1, h, h_pre, nullptr, up, M,
                                          4 * C, C, stream)
                      : gemm_any<UP_ERF>(t, w1, h, h_pre, nullptr, up, M,
                                         4 * C, C, stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (stages & 4) {
    const Epilogue down{(const float*)b2, (const float*)gamma, m != nullptr};
    err = dtype ? gemm_any<DOWN_F32>(h, w2, out, m, x, down, M, C, 4 * C,
                                     stream)
                : gemm_any<DOWN>(h, w2, out, m, x, down, M, C, 4 * C, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
