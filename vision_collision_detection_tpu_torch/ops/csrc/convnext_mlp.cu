// K3: the ConvNeXt block after the depthwise conv, fused:
//   out = x + gamma * (GELU(LN(y) @ W1 + b1) @ W2 + b2)
// LN: eps 1e-6, float32 statistics (two passes), t = LN(y) rounded to bf16.
// Products on bf16 with float32 accumulation; h_pre = t @ W1 + b1 rounded
// to bf16, GELU (tanh or erf) in float32, rounded to bf16; the residual is
// added in float32 and cast to x's dtype.
//
// Two variants of one template body. The eval variant replaces the TPU
// kernel vision_collision_detection_tpu/ops/convnext_mlp_pallas.py
// `convnext_mlp_block` -> `_call` (`_eval_kernel`, math `_ln_mlp`). The
// train variant replaces `_fwd` -> `_call` (`_train_kernel`): the same out,
// and it also writes the tensors the backward needs, all bf16:
// t = LN(y) [M, C], h_pre = t @ W1 + b1 [M, 4C] and m = h @ W2 + b2 [M, C].
// out uses the float32 m; only the saved copy is rounded.
//
// Bound on the H100. Eval: operations. 16*C^2 flops per row against 6*C
// bytes (bf16 x, y in, out) is 2.7*C flops/byte: 256 at C=96, about the
// card's ~295 ridge, and above it at every later stage. Train: the same
// flops against 18*C bytes per row (x, y, out, t and m at 2*C each, h_pre
// at 8*C), 0.9*C flops/byte: bytes at C <= 192, operations above; over the
// flagship's 18 blocks the bytes dominate.
//
// For bf16 activations at the widths of convnext_mlp_wgmma.cu (the Python
// wrapper's `route`) the Hopper kernel there takes the call; this one
// serves float32 activations and the widths 1024 and 1536.
//
// Design. One block of 8 to 16 warps takes BM rows (64 up to C=384, 48 at
// C=768, 32 or 16 above), so the float32 [BM, C] product of the second
// matmul stays in registers (mma.sync m16n8k16 accumulators, at most 60% of
// a thread's registers). The block normalises its rows into a bf16 tile
// t in shared memory, then walks the hidden dimension 4C in chunks of NC
// columns:
//   1. h_pre chunk = t @ W1[:, chunk], each warp a fixed tile, K split over
//      warps where the chunk has fewer 16x16 tiles than there are warps;
//   2. + b1, bf16 rounding, GELU, bf16 rounding into the bf16 chunk h in
//      shared memory, straight from the accumulators where K is not split;
//   3. acc += h @ W2[chunk, :], each warp a fixed tile of rows x columns so
//      that every fragment it loads (ldmatrix) feeds several mmas.
// The [BM, 4C] hidden activation never reaches device memory. The weight
// chunks are staged in shared memory with cp.async, one buffer for W1 and
// one for W2: W1's next chunk loads while the second product runs, W2's
// next chunk while the first product runs. Each block reads all of W1 and
// W2 once (from L2); BM rows share them. The block's bf16 rows of y arrive
// the same way, into t, and are normalised there; at the end the float32
// product goes through shared memory so that x is read and out written 16
// bytes at a time. Row strides carry 16 bytes of skew, so the eight rows an
// ldmatrix reads fall in distinct banks. The train variant writes t from
// shared memory once it is normalised, stages each rounded h_pre chunk in
// shared memory (before GELU) and writes it with 16-byte stores while the
// second product runs, and writes m beside out in the epilogue.
#include <type_traits>

#include "convnext_mlp_common.cuh"
#include "mma.cuh"

namespace {

using namespace vcd;

// Tiling per channel count. BM rows per block, NC hidden columns per chunk,
// WARPS warps; the second product's warps form a WR2 x (WARPS/WR2) grid
// over the [BM, C] output, the first product's a WR1 x WC1 grid over
// [BM, NC] times KS1 slices of the C reduction. Blocks of 8 warps where two
// fit an SM; 12 or 16 where one does, so that an SM still has warps to
// switch between. Chosen by timing candidates at each convnext_tiny stage
// shape on the H100; base and large widths follow the same rules.
template <int C>
struct Cfg;
#define VCD_K3_CFG(C_, BM_, NC_, WARPS_, WR2_, WR1_, KS1_)            \
  template <>                                                         \
  struct Cfg<C_> {                                                    \
    static constexpr int BM = BM_, NC = NC_, WARPS = WARPS_, WR2 = WR2_, \
                         WR1 = WR1_, KS1 = KS1_;                      \
  };
VCD_K3_CFG(96, 64, 64, 8, 4, 4, 1)
VCD_K3_CFG(128, 64, 64, 8, 2, 4, 1)
VCD_K3_CFG(192, 64, 64, 8, 2, 4, 1)
VCD_K3_CFG(256, 64, 64, 16, 4, 4, 1)
VCD_K3_CFG(384, 64, 64, 16, 2, 4, 1)
VCD_K3_CFG(512, 32, 32, 16, 1, 2, 4)
VCD_K3_CFG(768, 48, 32, 12, 3, 3, 2)
VCD_K3_CFG(1024, 16, 32, 16, 1, 1, 8)
VCD_K3_CFG(1536, 16, 16, 16, 1, 1, 16)
#undef VCD_K3_CFG

__host__ __device__ constexpr int align128(int n) { return (n + 127) / 128 * 128; }

template <int C>
struct Plan {
  using P = Cfg<C>;
  static constexpr int BM = P::BM, NC = P::NC, HID = 4 * C;
  static constexpr int WARPS = P::WARPS, THREADS = WARPS * 32;
  static constexpr int RF = BM / 16;       // row fragments
  static constexpr int CF = C / 16;        // output column fragments
  static constexpr int NF = NC / 16;       // chunk column fragments
  static constexpr int WR2 = P::WR2, WC2 = WARPS / WR2;
  static constexpr int R2 = RF / WR2, Q2 = CF / WC2;
  static constexpr int WR1 = P::WR1, KS1 = P::KS1, WC1 = WARPS / (WR1 * KS1);
  static constexpr int R1 = RF / WR1, Q1 = NF / WC1;
  static constexpr int KSTEP1 = CF / KS1;  // 16-wide K steps per slice
  static constexpr int LDT = C + 8;        // bf16 strides (16-byte skew)
  static constexpr int LDW1 = NC + 8;
  static constexpr int LDW2 = C + 8;
  static constexpr int LDHB = NC + 8;
  static constexpr int LDH = NC + 4;       // float32 stride
  static constexpr int T_OFF = 0;
  static constexpr int W1_OFF = T_OFF + align128(BM * LDT * 2);
  static constexpr int W2_OFF = W1_OFF + align128(C * LDW1 * 2);
  static constexpr int HS_OFF = W2_OFF + align128(NC * LDW2 * 2);
  // float32 partial sums of the first product, only where K is split
  static constexpr int H_OFF =
      HS_OFF + (KS1 > 1 ? align128(KS1 * BM * LDH * 4) : 0);
  static constexpr int SMEM = H_OFF + align128(BM * LDHB * 2);
  // the train variant's staged h_pre chunk, [BM][LDHB] bf16, after h
  static constexpr int HP_OFF = SMEM;
  static constexpr int SMEM_TRAIN = HP_OFF + align128(BM * LDHB * 2);
  static constexpr int LDO = C + 4;        // float32 output tile stride
  // Two blocks of 8 warps share an SM where their shared memory (and 1 KB
  // reserved for each) fits in its 228 KB; registers are then capped at 128.
  static constexpr int min_blocks(int smem) {
    return WARPS == 8 && 2 * (smem + 1024) <= 233472 ? 2 : 1;
  }
  static constexpr int MIN_BLOCKS = min_blocks(SMEM);
  static constexpr int MIN_BLOCKS_TRAIN = min_blocks(SMEM_TRAIN);

  static_assert(BM % 16 == 0 && C % 16 == 0 && NC % 16 == 0, "tiles");
  static_assert(HID % NC == 0, "chunks");
  static_assert(RF % WR2 == 0 && CF % WC2 == 0, "second product grid");
  static_assert(WARPS % (WR1 * KS1) == 0, "first product grid");
  static_assert(RF % WR1 == 0 && NF % WC1 == 0 && CF % KS1 == 0,
                "first product grid");
  // the accumulators take at most 60% of a thread's share of registers
  static_assert(R2 * Q2 * 8 * 5 <= 3 * (65536 / THREADS),
                "accumulator registers per thread");
  static_assert(SMEM_TRAIN <= 232448, "shared memory");
  static_assert(BM * LDO * 4 <= HS_OFF, "output tile over t, W1s, W2s");
  static_assert(C % 32 == 0 && CF % (2 * KS1) == 0, "LN lanes, K pairs");
};

// W1[:, j0:j0+NC] -> w1s [C][LDW1], 16 bytes per copy.
template <int C>
__device__ __forceinline__ void load_w1(bf16* w1s, const bf16* w1, int j0) {
  using L = Plan<C>;
  constexpr int VR = L::NC / 8;
  for (int i = threadIdx.x; i < C * VR; i += L::THREADS) {
    const int k = i / VR, v = i % VR;
    cp_async16(w1s + k * L::LDW1 + v * 8,
               w1 + (size_t)k * L::HID + j0 + v * 8);
  }
  cp_async_commit();
}

// W2[j0:j0+NC, :] -> w2s [NC][LDW2].
template <int C>
__device__ __forceinline__ void load_w2(bf16* w2s, const bf16* w2, int j0) {
  using L = Plan<C>;
  constexpr int VR = C / 8;
  for (int i = threadIdx.x; i < L::NC * VR; i += L::THREADS) {
    const int k = i / VR, v = i % VR;
    cp_async16(w2s + k * L::LDW2 + v * 8, w2 + (size_t)(j0 + k) * C + v * 8);
  }
  cp_async_commit();
}

// Eight consecutive values of x or out as float32, 16 or 32 bytes at once.
template <typename TX>
struct Vec8;
template <>
struct Vec8<bf16> {
  static __device__ __forceinline__ void load(const bf16* p, float (&f)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 v = __bfloat1622float2(b[k]);
      f[2 * k] = v.x;
      f[2 * k + 1] = v.y;
    }
  }
  static __device__ __forceinline__ void store(bf16* p, const float (&f)[8]) {
    uint4 u;
    __nv_bfloat162* b = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) b[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};
template <>
struct Vec8<float> {
  static __device__ __forceinline__ void load(const float* p, float (&f)[8]) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
    f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&f)[8]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
};

// The saved tensors of the train variant (null in the eval variant).
struct Saved {
  bf16* t;      // [M, C]
  bf16* h_pre;  // [M, 4C]
  bf16* m;      // [M, C]
};

template <int C, typename TX, bool TRAIN>
__global__ void __launch_bounds__(Plan<C>::THREADS,
                                  TRAIN ? Plan<C>::MIN_BLOCKS_TRAIN
                                        : Plan<C>::MIN_BLOCKS)
convnext_mlp_kernel(const TX* __restrict__ x, const TX* __restrict__ y,
                    const float* __restrict__ ln_w,
                    const float* __restrict__ ln_b,
                    const bf16* __restrict__ w1, const float* __restrict__ b1,
                    const bf16* __restrict__ w2, const float* __restrict__ b2,
                    const float* __restrict__ gamma, TX* __restrict__ out,
                    Saved saved, int M, int approximate) {
  using L = Plan<C>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* t = reinterpret_cast<bf16*>(smem + L::T_OFF);
  bf16* w1s = reinterpret_cast<bf16*>(smem + L::W1_OFF);
  bf16* w2s = reinterpret_cast<bf16*>(smem + L::W2_OFF);
  float* hs = reinterpret_cast<float*>(smem + L::HS_OFF);
  bf16* h = reinterpret_cast<bf16*>(smem + L::H_OFF);
  bf16* hp = reinterpret_cast<bf16*>(smem + L::HP_OFF);  // train only

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t row0 = (int64_t)blockIdx.x * L::BM;

  // bf16 rows of y are copied into t, where they are normalised in place;
  // the first weight chunks load meanwhile.
  constexpr bool Y_IN_SMEM = std::is_same<TX, bf16>::value;
  if constexpr (Y_IN_SMEM) {
    constexpr int VR = C / 8;
    for (int i = threadIdx.x; i < L::BM * VR; i += L::THREADS) {
      const int r = i / VR, v = i % VR;
      if (row0 + r < M)
        cp_async16(t + r * L::LDT + v * 8, y + (row0 + r) * C + v * 8);
    }
    cp_async_commit();
  }
  load_w1<C>(w1s, w1, 0);
  load_w2<C>(w2s, w2, 0);
  if constexpr (Y_IN_SMEM) {
    cp_async_wait<2>();
    __syncthreads();
  }

  // LayerNorm of the block's rows into t (bf16), one warp per row, each
  // lane holding C/32 of its values.
  for (int r = warp; r < L::BM; r += L::WARPS) {
    const int64_t gr = row0 + r;
    bf16* trow = t + r * L::LDT;
    if (gr >= M) {
      for (int c = lane; c < C; c += 32) trow[c] = __float2bfloat16_rn(0.f);
      continue;
    }
    float v[C / 32];
#pragma unroll
    for (int i = 0; i < C / 32; ++i) {
      if constexpr (Y_IN_SMEM) {
        v[i] = __bfloat162float(trow[lane + 32 * i]);
      } else {
        v[i] = y[gr * C + lane + 32 * i];  // float32 activations
      }
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < C / 32; ++i) s += v[i];
    const float mu = warp_sum(s) / C;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < C / 32; ++i) q += (v[i] - mu) * (v[i] - mu);
    const float rstd = rsqrtf(warp_sum(q) / C + LN_EPS);
#pragma unroll
    for (int i = 0; i < C / 32; ++i) {
      const int c = lane + 32 * i;
      trow[c] = __float2bfloat16_rn((v[i] - mu) * rstd * ln_w[c] + ln_b[c]);
    }
  }
  if constexpr (TRAIN) {
    // t is complete: write the block's rows of it, 16 bytes at a time
    __syncthreads();
    constexpr int VR = C / 8;
    for (int i = threadIdx.x; i < L::BM * VR; i += L::THREADS) {
      const int r = i / VR, v = i % VR;
      if (row0 + r < M)
        *reinterpret_cast<uint4*>(saved.t + (row0 + r) * C + v * 8) =
            *reinterpret_cast<const uint4*>(t + r * L::LDT + v * 8);
    }
  }

  // Warp coordinates in the two products' grids; g and tg locate a lane's
  // values in an m16n8 accumulator: rows g and g + 8, columns 2*tg, 2*tg+1.
  const int k1 = warp / (L::WR1 * L::WC1);
  const int wr1 = (warp % (L::WR1 * L::WC1)) / L::WC1;
  const int wc1 = warp % L::WC1;
  const int wr2 = warp / L::WC2;
  const int wc2 = warp % L::WC2;
  const int g = lane / 4, tg = lane % 4;
  // ldmatrix row addresses: lanes 0-15 rows 0-15 at column 0, lanes 16-31
  // the same rows at column 8.
  const int lrow = lane % 16, lcol = (lane / 16) * 8;

  float acc[L::R2][2 * L::Q2][4];
#pragma unroll
  for (int a = 0; a < L::R2; ++a)
#pragma unroll
    for (int n = 0; n < 2 * L::Q2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][n][e] = 0.f;

  constexpr int CHUNKS = L::HID / L::NC;
  for (int ci = 0; ci < CHUNKS; ++ci) {
    const int j0 = ci * L::NC;
    // W1's chunk has landed (W2's may still be in flight); t is complete.
    cp_async_wait<1>();
    __syncthreads();

    // 1. h_pre = t[:, slice] @ W1s[slice, :]; even and odd K steps go to
    // separate accumulators, two independent mma chains.
    float hacc[2][L::R1][2 * L::Q1][4];
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int a = 0; a < L::R1; ++a)
#pragma unroll
        for (int n = 0; n < 2 * L::Q1; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) hacc[e][a][n][i] = 0.f;
#pragma unroll 2
    for (int ks0 = k1 * L::KSTEP1; ks0 < (k1 + 1) * L::KSTEP1; ks0 += 2) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kc = (ks0 + e) * 16;
        unsigned fa[L::R1][4];
#pragma unroll
        for (int a = 0; a < L::R1; ++a)
          ldsm_x4(fa[a], t + ((wr1 * L::R1 + a) * 16 + lrow) * L::LDT + kc + lcol);
#pragma unroll
        for (int q = 0; q < L::Q1; ++q) {
          unsigned fb[4];
          ldsm_x4_trans(fb, w1s + (kc + lrow) * L::LDW1 +
                                (wc1 * L::Q1 + q) * 16 + lcol);
#pragma unroll
          for (int a = 0; a < L::R1; ++a) {
            mma_bf16(hacc[e][a][2 * q], fa[a], fb[0], fb[1]);
            mma_bf16(hacc[e][a][2 * q + 1], fa[a], fb[2], fb[3]);
          }
        }
      }
    }
    if constexpr (L::KS1 == 1) {
      // 2. Straight from the accumulators: + b1, round to bf16, GELU in
      // float32, round to bf16, into h.
#pragma unroll
      for (int a = 0; a < L::R1; ++a)
#pragma unroll
        for (int n = 0; n < 2 * L::Q1; ++n) {
          const int r = (wr1 * L::R1 + a) * 16 + g;
          const int c = (wc1 * L::Q1) * 16 + n * 8 + 2 * tg;
          const float bias0 = b1[j0 + c], bias1 = b1[j0 + c + 1];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float p0 = hacc[0][a][n][2 * half] + hacc[1][a][n][2 * half];
            const float p1 =
                hacc[0][a][n][2 * half + 1] + hacc[1][a][n][2 * half + 1];
            const float h0 = __bfloat162float(__float2bfloat16_rn(p0 + bias0));
            const float h1 = __bfloat162float(__float2bfloat16_rn(p1 + bias1));
            if constexpr (TRAIN)
              *reinterpret_cast<__nv_bfloat162*>(hp + (r + 8 * half) * L::LDHB +
                                                 c) = __floats2bfloat162_rn(h0, h1);
            *reinterpret_cast<__nv_bfloat162*>(h + (r + 8 * half) * L::LDHB + c) =
                __floats2bfloat162_rn(gelu(h0, approximate),
                                      gelu(h1, approximate));
          }
        }
    } else {
      // 2. Partial sums over the K slices meet in hs; then + b1, round to
      // bf16, GELU in float32, round to bf16, into h.
      float* part = hs + k1 * L::BM * L::LDH;
#pragma unroll
      for (int a = 0; a < L::R1; ++a)
#pragma unroll
        for (int n = 0; n < 2 * L::Q1; ++n) {
          const int r = (wr1 * L::R1 + a) * 16 + g;
          const int c = (wc1 * L::Q1) * 16 + n * 8 + 2 * tg;
#pragma unroll
          for (int half = 0; half < 2; ++half)
            *reinterpret_cast<float2*>(part + (r + 8 * half) * L::LDH + c) =
                make_float2(
                    hacc[0][a][n][2 * half] + hacc[1][a][n][2 * half],
                    hacc[0][a][n][2 * half + 1] + hacc[1][a][n][2 * half + 1]);
        }
      __syncthreads();
      for (int i = threadIdx.x; i < L::BM * L::NC; i += L::THREADS) {
        const int r = i / L::NC;
        const int j = i % L::NC;
        float sum = hs[r * L::LDH + j];
#pragma unroll
        for (int p = 1; p < L::KS1; ++p)
          sum += hs[p * L::BM * L::LDH + r * L::LDH + j];
        const float pre =
            __bfloat162float(__float2bfloat16_rn(sum + b1[j0 + j]));
        if constexpr (TRAIN) hp[r * L::LDHB + j] = __float2bfloat16_rn(pre);
        h[r * L::LDHB + j] = __float2bfloat16_rn(gelu(pre, approximate));
      }
    }
    // W2's chunk has landed and h is complete; every warp is past W1s.
    cp_async_wait<0>();
    __syncthreads();
    if (ci + 1 < CHUNKS) load_w1<C>(w1s, w1, j0 + L::NC);
    if constexpr (TRAIN) {
      // the rounded h_pre chunk, 16 bytes at a time; hp is next written
      // after the barrier that ends this chunk
      constexpr int VN = L::NC / 8;
      for (int i = threadIdx.x; i < L::BM * VN; i += L::THREADS) {
        const int r = i / VN, v = i % VN;
        if (row0 + r < M)
          *reinterpret_cast<uint4*>(saved.h_pre + (row0 + r) * L::HID + j0 +
                                    v * 8) =
              *reinterpret_cast<const uint4*>(hp + r * L::LDHB + v * 8);
      }
    }

    // 3. acc += h @ W2s.
#pragma unroll
    for (int ks = 0; ks < L::NF; ++ks) {
      unsigned fa[L::R2][4];
#pragma unroll
      for (int a = 0; a < L::R2; ++a)
        ldsm_x4(fa[a], h + ((wr2 * L::R2 + a) * 16 + lrow) * L::LDHB +
                           ks * 16 + lcol);
#pragma unroll
      for (int q = 0; q < L::Q2; ++q) {
        unsigned fb[4];
        ldsm_x4_trans(fb, w2s + (ks * 16 + lrow) * L::LDW2 +
                              (wc2 * L::Q2 + q) * 16 + lcol);
#pragma unroll
        for (int a = 0; a < L::R2; ++a) {
          mma_bf16(acc[a][2 * q], fa[a], fb[0], fb[1]);
          mma_bf16(acc[a][2 * q + 1], fa[a], fb[2], fb[3]);
        }
      }
    }
    __syncthreads();  // W2s and h are free
    if (ci + 1 < CHUNKS) load_w2<C>(w2s, w2, j0 + L::NC);
  }

  // out = x + gamma * m, m = h @ W2 + b2: the [BM, C] product goes to
  // shared memory (over t, W1s and W2s, all free now), then each thread
  // finishes eight consecutive values of a row with 16-byte loads and
  // stores; the train variant also writes m rounded to bf16.
  float* ot = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int a = 0; a < L::R2; ++a)
#pragma unroll
    for (int n = 0; n < 2 * L::Q2; ++n) {
      const int r = (wr2 * L::R2 + a) * 16 + g;
      const int c = (wc2 * L::Q2) * 16 + n * 8 + 2 * tg;
      *reinterpret_cast<float2*>(ot + r * L::LDO + c) =
          make_float2(acc[a][n][0], acc[a][n][1]);
      *reinterpret_cast<float2*>(ot + (r + 8) * L::LDO + c) =
          make_float2(acc[a][n][2], acc[a][n][3]);
    }
  __syncthreads();
  constexpr int VR = C / 8;
  for (int i = threadIdx.x; i < L::BM * VR; i += L::THREADS) {
    const int r = i / VR, c = (i % VR) * 8;
    const int64_t gr = row0 + r;
    if (gr >= M) continue;
    float f[8], mv[8];
    Vec8<TX>::load(x + gr * C + c, f);
#pragma unroll
    for (int k = 0; k < 8; ++k) mv[k] = ot[r * L::LDO + c + k] + b2[c + k];
    if constexpr (TRAIN) Vec8<bf16>::store(saved.m + gr * C + c, mv);
#pragma unroll
    for (int k = 0; k < 8; ++k) f[k] += gamma[c + k] * mv[k];
    Vec8<TX>::store(out + gr * C + c, f);
  }
}

template <int C, typename TX, bool TRAIN>
int launch(const void* x, const void* y, const void* ln_w, const void* ln_b,
           const void* w1, const void* b1, const void* w2, const void* b2,
           const void* gamma, void* out, Saved saved, int M, int approximate,
           void* stream) {
  using L = Plan<C>;
  constexpr int smem = TRAIN ? L::SMEM_TRAIN : L::SMEM;
  auto kernel = convnext_mlp_kernel<C, TX, TRAIN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((M + L::BM - 1) / L::BM);
  if (blocks > 0) {
    kernel<<<blocks, L::THREADS, smem, (cudaStream_t)stream>>>(
        (const TX*)x, (const TX*)y, (const float*)ln_w, (const float*)ln_b,
        (const bf16*)w1, (const float*)b1, (const bf16*)w2, (const float*)b2,
        (const float*)gamma, (TX*)out, saved, M, approximate);
  }
  return (int)cudaGetLastError();
}

template <typename TX, bool TRAIN>
int dispatch(const void* x, const void* y, const void* ln_w, const void* ln_b,
             const void* w1, const void* b1, const void* w2, const void* b2,
             const void* gamma, void* out, Saved saved, int M, int C,
             int approximate, void* stream) {
#define VCD_K3_CASE(C_)                                                     \
  case C_:                                                                  \
    return launch<C_, TX, TRAIN>(x, y, ln_w, ln_b, w1, b1, w2, b2, gamma,  \
                                 out, saved, M, approximate, stream);
  switch (C) {
    VCD_K3_CASE(96)
    VCD_K3_CASE(128)
    VCD_K3_CASE(192)
    VCD_K3_CASE(256)
    VCD_K3_CASE(384)
    VCD_K3_CASE(512)
    VCD_K3_CASE(768)
    VCD_K3_CASE(1024)
    VCD_K3_CASE(1536)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef VCD_K3_CASE
}

}  // namespace

// x, y, out: [M, C] of `dtype` (0 = bfloat16, 1 = float32), contiguous.
// ln_w, ln_b, b2, gamma: float32 [C]; w1: bf16 [C, 4C]; b1: float32 [4C];
// w2: bf16 [4C, C]. C is one of the ConvNeXt widths 96, 128, 192, 256, 384,
// 512, 768, 1024, 1536.
extern "C" int vcd_convnext_mlp(const void* x, const void* y, const void* ln_w,
                                const void* ln_b, const void* w1,
                                const void* b1, const void* w2, const void* b2,
                                const void* gamma, void* out, int M, int C,
                                int approximate, int dtype, void* stream) {
  const Saved none{nullptr, nullptr, nullptr};
  if (dtype == 0)
    return dispatch<bf16, false>(x, y, ln_w, ln_b, w1, b1, w2, b2, gamma, out,
                                 none, M, C, approximate, stream);
  if (dtype == 1)
    return dispatch<float, false>(x, y, ln_w, ln_b, w1, b1, w2, b2, gamma, out,
                                  none, M, C, approximate, stream);
  return (int)cudaErrorInvalidValue;
}

// The train variant: as above, and t, m: bf16 [M, C], h_pre: bf16 [M, 4C],
// contiguous and 16-byte aligned.
extern "C" int vcd_convnext_mlp_train(
    const void* x, const void* y, const void* ln_w, const void* ln_b,
    const void* w1, const void* b1, const void* w2, const void* b2,
    const void* gamma, void* out, void* t, void* h_pre, void* m, int M, int C,
    int approximate, int dtype, void* stream) {
  const Saved saved{(bf16*)t, (bf16*)h_pre, (bf16*)m};
  if (dtype == 0)
    return dispatch<bf16, true>(x, y, ln_w, ln_b, w1, b1, w2, b2, gamma, out,
                                saved, M, C, approximate, stream);
  if (dtype == 1)
    return dispatch<float, true>(x, y, ln_w, ln_b, w1, b1, w2, b2, gamma, out,
                                 saved, M, C, approximate, stream);
  return (int)cudaErrorInvalidValue;
}
