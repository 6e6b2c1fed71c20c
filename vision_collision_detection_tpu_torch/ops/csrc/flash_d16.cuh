// K4 at head_dim 16 (vivit_tiny: 256 tokens, 4 heads of 16) on Hopper's
// warpgroup products (wgmma) fed by the Tensor Memory Accelerator: the
// forward, dK/dV and dQ bodies that flash_attention_fwd_wgmma.cu,
// flash_attention_bwd_wgmma.cu (bf16) and flash_attention_fwd_f32.cu,
// flash_attention_bwd_f32.cu (float32, on the split copies of
// flash_f32.cuh) instantiate.
//
// Replace the same TPU kernels as the head_dim-64 designs (the JAX
// library's `_flash_attention_impl`, `_flash_attention_bwd_dkv` and
// `_flash_attention_bwd_dq` behind vision_collision_detection_tpu/ops/
// flash_attention.py `flash_mha`), with the same function and roundings:
// logits, softmax and sums in float32, p and ds rounded to bf16 before
// their products (float32: split into hi and lo bf16 parts, not rounded),
// the float32 log-sum-exp, no float atomics (two runs agree bit for bit).
//
// Bound. At head_dim 16 the products are small (4·S²·D flops a forward,
// about 4 µs at vivit_tiny's [256, 256, 4, 16] on the tensor cores) and the
// bytes smaller still (bf16: 8·S·D bytes a (batch, head)); what binds is
// the softmax's exponentials, S² a (batch, head) in each kernel (the
// backward kernels recompute p), on the special-function unit: 16 ex2 a
// clock per SM, 67 M of them a launch at vivit_tiny's shape, about 17 µs
// at 1.98 GHz. The design keeps ex2 issuing: up to four consumer
// warpgroups a block, so that some run their exponentials while the
// others wait on their products or their tiles, one exponential per logit
// after one FMA (scale·log2(e) folded in), the row maximum as a tree.
//
// Layout. A row of 16 bf16 is 32 bytes: tiles use the 32-byte swizzle
// (hopper.cuh: sw32_desc, load_a_sw32; TMA writes them from make_map16's
// maps, built from each tensor's own strides, zeros past S). A product
// over head_dim (the logits, do·vᵀ) is one k-step, B the streamed tile read
// K-major; a product into head_dim (p·v and the gradients) is N = 16, B the
// streamed tile read MN-major, 512 bytes a k-step of 16 rows. Every A
// operand comes from registers: the item's own 64 rows a warpgroup of q,
// k, v or do are one mma fragment a warp (per part), p and ds go from the
// accumulators straight into fragments.
//
// Work. The grid is persistent, one block per SM; a work item is 64·NWG
// rows of one (batch, head), 64 a consumer warpgroup (FWD_NWG, BWD_NWG
// say how many: 256 = 4 · 64 = 2 · 128, so no item is part empty at
// vivit_tiny's length). One producer warp loads the items' own rows into
// one of two buffers and streams the other operands through a ring of
// mbarrier-guarded stages, running ahead across items.
//   Forward: keys in tiles of 64, one a step: s = Q·Kᵀ (m64n64k16; float32
//   three products), the online softmax, o += P·V (bf16 4 k-steps of
//   m64n16k16; float32 five products, p in two parts).
//   dK/dV (transposed, so that nothing leaves registers: sᵀ = K·Qᵀ,
//   dpᵀ = V·dOᵀ, dv += Pᵀ·dO, dk += dSᵀ·Q) and dQ (s = Q·Kᵀ, dp = dO·Vᵀ,
//   dq += dS·K): the other side's rows in tiles of 64, both logits
//   products as one group, then p and ds, then the gradient products.
// A warpgroup overlaps nothing of its own: the block's other warpgroups
// fill the special-function unit and the tensor cores meanwhile. No wgmma
// group stays in flight across a loop's back edge (ptxas would serialise
// every product of the loop).
#pragma once

#include "flash_f32.cuh"

namespace vcd {
namespace d16 {

constexpr float LOG2E = 1.4426950408889634f;

// The designs' sizes: consumer warpgroups a block (64 rows each; an item
// is 64·NWG rows) and keys a forward ring tile, per kernel; rows a
// backward ring tile. Four warpgroups (items of 256 rows: vivit_tiny's
// whole length) keep four warps of each SM quadrant at their
// exponentials, where two left the quadrant idle waiting on their
// products and barriers (on an H100 SXM at 700 W,
// scripts/ab_flash_d16_variants.py: bf16 forward 0.0429 ms a launch at
// [256, 256, 4, 16] against 0.0946 with two warpgroups and tiles of 128;
// bf16 dQ 0.0446 against 0.0600). Four leave a consumer thread 112 registers:
// enough for the forward's one key tile of 64 and bf16 dQ, not for the
// others' two logits tiles, their fragments and accumulators, which keep
// two warpgroups and 232 registers (with four they spilled, and a spilled
// wgmma operand is not a risk the design takes).
constexpr int FWD_NWG = 4, FWD_KT = 64;
template <bool DKV, bool F32>
constexpr int BWD_NWG = DKV || F32 ? 2 : 4;
constexpr int ST = 64;

// A block of NWG consumer warpgroups and the producer's warpgroup (of
// which one warp works): its threads, and what setmaxnreg moves. The
// block is launched with 65,536 / THREADS registers a thread (rounded
// down to 8: 168 or 96); the producer's warpgroup keeps PRODUCER_REGS,
// each consumer thread takes CONSUMER_REGS of what it gives up.
template <int NWG>
struct Block {
  static constexpr int THREADS = (NWG + 1) * 128, ITEM_ROWS = 64 * NWG;
  static constexpr int CONSUMER_REGS = NWG == 2 ? 232 : 112;
  static constexpr int PRODUCER_REGS = NWG == 2 ? 40 : 24;
  static_assert(NWG == 2 || NWG == 4, "two or four consumer warpgroups");
};

// Bytes of a tile of `rows` rows of 16 bf16.
constexpr int tile_bytes(int rows) { return rows * 32; }

// Parts of each operand: bf16 one; float32 split copies, q and k in two
// (hi, lo), v and do in three (hi, lo, lo2).
template <bool F32>
struct Parts {
  static constexpr int QK = F32 ? 2 : 1, VD = F32 ? 3 : 1;
};

// The tensor maps of one call: each part of q, k, v (and do).
template <bool F32>
struct Maps {
  CUtensorMap q[Parts<F32>::QK], k[Parts<F32>::QK], v[Parts<F32>::VD],
      dout[Parts<F32>::VD];
};

// d[64 x 16] += A[64 x 16·J] · B, A as J fragments, B a tile of 16·J rows
// (the product's k index) read MN-major: J k-steps 512 bytes apart.
template <int J>
__device__ __forceinline__ void ab16(float (&d)[2][4],
                                     const unsigned (&a)[J][4], uint64_t b) {
#pragma unroll
  for (int j = 0; j < J; ++j) wgmma_rs16<1>(d, a[j], b + 32 * j, 1);
}

// The same on split operands: d += A · B as lo·hi + hi·lo + hi·hi.
template <int J>
__device__ __forceinline__ void ab16_split(float (&d)[2][4],
                                           const unsigned (&a_hi)[J][4],
                                           const unsigned (&a_lo)[J][4],
                                           uint64_t b_hi, uint64_t b_lo) {
  ab16(d, a_lo, b_hi);
  ab16(d, a_hi, b_lo);
  ab16(d, a_hi, b_hi);
}

// d = A · Bᵀ over head_dim 16 (one k-step), A[P][4] the parts of this
// warp's rows, B the descriptors of the streamed tile's parts read K-major,
// d overwritten. One part: one product. Two parts a side (q, k): lo·hi,
// hi·lo, hi·hi. Three (v, do): the six products whose terms reach 2^-18
// (flash_f32.cuh's split6_abt_ss).
template <int P, typename Acc, typename Mma>
__device__ __forceinline__ void abt_parts(Acc& d, const unsigned (&a)[P][4],
                                          const uint64_t (&b)[P], Mma mma) {
  if constexpr (P == 1) {
    mma(d, a[0], b[0], 0);
  } else if constexpr (P == 2) {
    mma(d, a[1], b[0], 0);
    mma(d, a[0], b[1], 1);
    mma(d, a[0], b[0], 1);
  } else {
    mma(d, a[2], b[0], 0);
    mma(d, a[0], b[2], 1);
    mma(d, a[1], b[1], 1);
    mma(d, a[1], b[0], 1);
    mma(d, a[0], b[1], 1);
    mma(d, a[0], b[0], 1);
  }
}

// One logits product, d[64 x N] = A · Bᵀ, B read K-major.
template <int N>
struct MmaN;
template <>
struct MmaN<64> {
  __device__ __forceinline__ void operator()(float (&d)[8][4],
                                             const unsigned (&a)[4],
                                             uint64_t b, int acc) const {
    wgmma_rs<0>(d, a, b, acc);
  }
};
template <>
struct MmaN<128> {
  __device__ __forceinline__ void operator()(float (&d)[16][4],
                                             const unsigned (&a)[4],
                                             uint64_t b, int acc) const {
    wgmma_rs128<0>(d, a, b, acc);
  }
};

// The ring of a block: FULL and EMPTY mbarriers per stage; g counts the
// block's tiles over all of its items.
template <int STAGES>
struct Ring {
  unsigned full, empty;
  __device__ __forceinline__ void wait_full(int g) const {
    mbar_wait(full + 8 * (g % STAGES), (g / STAGES) & 1);
    __syncwarp();
  }
  // this warp has read everything of tile g
  __device__ __forceinline__ void release(int g) const {
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(empty + 8 * (g % STAGES));
  }
};

// ---- forward ---------------------------------------------------------------

template <bool F32, int NWG, int KT>
struct FwdLayout {
  using P = Parts<F32>;
  static constexpr int STAGES = 4;
  static constexpr int QT = tile_bytes(64);       // a warpgroup's Q part
  static constexpr int Q = 0;                     // [2][QK parts][NWG]
  static constexpr int Q_BYTES = P::QK * NWG * QT;  // one buffer
  static constexpr int KV = tile_bytes(KT);       // a K or V part's tile
  static constexpr int RING = 2 * Q_BYTES;        // [STAGES][K parts, V parts]
  static constexpr int STAGE_BYTES = (P::QK + P::VD) * KV;
  static constexpr int BARS = RING + STAGES * STAGE_BYTES;
  static constexpr int FULL = BARS, EMPTY = FULL + 8 * STAGES,
                       LOADED = EMPTY + 8 * STAGES, FREE = LOADED + 16;
  static constexpr int DYNAMIC = FREE + 16 + 1024;  // room to align the base
  static_assert(DYNAMIC <= 232448, "shared memory of one block");
};

// The producer warp's lane 0: per item the Q parts of its 64·NWG queries
// (one box a part) into the buffer the consumers have freed, then every K,
// V tile of the (batch, head) through the ring.
template <bool F32, int NWG, int KT>
__device__ __forceinline__ void produce_fwd(const Maps<F32>& m, unsigned base,
                                            int items, int row_blocks, int S,
                                            int H) {
  using L = FwdLayout<F32, NWG, KT>;
  using P = Parts<F32>;
  const int tiles = (S + KT - 1) / KT;
  int g = 0;
  for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n) {
    const Item it = item_at(w, row_blocks, Block<NWG>::ITEM_ROWS, H);
    const int buf = n & 1;
    mbar_wait(base + L::FREE + 8 * buf, ((n >> 1) & 1) ^ 1);
    const unsigned loaded = base + L::LOADED + 8 * buf;
    mbar_arrive_expect(loaded, L::Q_BYTES);
#pragma unroll
    for (int p = 0; p < P::QK; ++p)
      tma_load_4d(base + L::Q + buf * L::Q_BYTES + p * NWG * L::QT, &m.q[p],
                  loaded, 0, it.r0, it.h, it.b);
    for (int t = 0; t < tiles; ++t, ++g) {
      const int stage = g % L::STAGES;
      mbar_wait(base + L::EMPTY + 8 * stage, ((g / L::STAGES) & 1) ^ 1);
      const unsigned full = base + L::FULL + 8 * stage;
      const unsigned dst = base + L::RING + stage * L::STAGE_BYTES;
      mbar_arrive_expect(full, L::STAGE_BYTES);
#pragma unroll
      for (int p = 0; p < P::QK; ++p)
        tma_load_4d(dst + p * L::KV, &m.k[p], full, 0, t * KT, it.h, it.b);
#pragma unroll
      for (int p = 0; p < P::VD; ++p)
        tma_load_4d(dst + (P::QK + p) * L::KV, &m.v[p], full, 0, t * KT,
                    it.h, it.b);
    }
  }
}

// The running statistics of this lane's rows g and g + 8: the largest
// unscaled logit so far and this lane's part of the row sum.
struct RowStats {
  float m[2], l[2];
};

// One key tile's online softmax on its logits s (this warp's 16 rows x
// 8·NT keys), in place: s becomes the weights exp(s·scale - m) (as ex2 of
// one FMA), the running max and sum move on, alpha is the factor that
// rescales what o has summed so far. key0: the key of this lane's first
// column. EDGE: the tile ends past S.
template <bool EDGE, int NT>
__device__ __forceinline__ void softmax_tile(float (&s)[NT][4], RowStats& st,
                                             float (&alpha)[2], int key0,
                                             int S, float scale2) {
  if (EDGE) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (key0 + nt * 8 + (e & 1) >= S) s[nt][e] = -CUDART_INF_F;
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    // the row's largest logit as a tree, not a chain of dependent steps
    float m2[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      m2[nt] = fmaxf(s[nt][2 * half], s[nt][2 * half + 1]);
#pragma unroll
    for (int w = NT / 2; w > 0; w /= 2)
#pragma unroll
      for (int nt = 0; nt < w; ++nt) m2[nt] = fmaxf(m2[nt], m2[nt + w]);
    float mx = m2[0];
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // every tile holds a key below S, so m_new is finite; the first tile's
    // alpha is ex2(-inf) = 0
    const float m_new = fmaxf(st.m[half], mx);
    alpha[half] = ex2((st.m[half] - m_new) * scale2);
    st.m[half] = m_new;
    const float mb = m_new * scale2;
    // two sums, so that the additions after the exponentials are two
    // chains and not one
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 2 * half; e < 2 * half + 2; ++e) {
        s[nt][e] = ex2(fmaf(s[nt][e], scale2, -mb));
        sum[e & 1] += s[nt][e];
      }
    st.l[half] = st.l[half] * alpha[half] + (sum[0] + sum[1]);
  }
}

__device__ __forceinline__ void rescale16(float (&o)[2][4],
                                          const float (&alpha)[2]) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    o[nt][0] *= alpha[0];
    o[nt][1] *= alpha[0];
    o[nt][2] *= alpha[1];
    o[nt][3] *= alpha[1];
  }
}

// What a consumer warp reads of a forward ring stage: its K parts and V
// parts' descriptors.
template <bool F32, int NWG, int KT>
struct FwdStage {
  uint64_t k[Parts<F32>::QK], v[Parts<F32>::VD];
  __device__ __forceinline__ FwdStage(unsigned base, int g) {
    using L = FwdLayout<F32, NWG, KT>;
    const uint64_t d0 =
        sw32_desc(base + L::RING + (g % L::STAGES) * L::STAGE_BYTES);
#pragma unroll
    for (int p = 0; p < Parts<F32>::QK; ++p) k[p] = d0 + p * (L::KV >> 4);
#pragma unroll
    for (int p = 0; p < Parts<F32>::VD; ++p)
      v[p] = d0 + (Parts<F32>::QK + p) * (L::KV >> 4);
  }
};

// Key tile t (ring tile g): s = Q · Kᵀ, the softmax, o += P · V (bf16:
// one product each; float32: three and five, p split in two). EDGE: it
// ends past S.
template <bool F32, int NWG, int KT, bool EDGE>
__device__ __forceinline__ void key_tile(
    float (&o)[2][4], RowStats& st,
    const Ring<FwdLayout<F32, NWG, KT>::STAGES>& ring, unsigned base, int g,
    int t, const unsigned (&q)[Parts<F32>::QK][4], int S, float scale2,
    int tg) {
  float s[KT / 8][4], a[2];
  ring.wait_full(g);
  const FwdStage<F32, NWG, KT> stg(base, g);
  wgmma_fence();
  abt_parts(s, q, stg.k, MmaN<KT>{});
  wgmma_commit();
  wgmma_wait<0>();
  acc_fence(s);
  softmax_tile<EDGE>(s, st, a, t * KT + 2 * tg, S, scale2);
  rescale16(o, a);
  if constexpr (F32) {
    unsigned p_hi[KT / 16][4], p_lo[KT / 16][4];
    acc_to_a_split(s, p_hi, p_lo);
    wgmma_fence();
    // the five products of p·v whose terms reach 2^-18 (split_ab5)
    ab16(o, p_hi, stg.v[2]);
    ab16(o, p_lo, stg.v[1]);
    ab16_split(o, p_hi, p_lo, stg.v[0], stg.v[1]);
    wgmma_commit();
  } else {
    unsigned p[KT / 16][4];
    acc_to_a(s, p);
    wgmma_fence();
    ab16(o, p, stg.v[0]);
    wgmma_commit();
  }
  wgmma_wait<0>();
  acc_fence(o);
  ring.release(g);
}

// One persistent block of the forward: o (T: bf16 or float) and, where the
// caller wants it, the float32 log-sum-exp [B, H, S].
template <bool F32, int NWG, int KT, typename T>
__device__ __forceinline__ void fwd_block(const Maps<F32>& maps,
                                          T* __restrict__ o_out,
                                          float* __restrict__ lse, int items,
                                          int row_blocks, int S, int H,
                                          float scale) {
  using L = FwdLayout<F32, NWG, KT>;
  using BL = Block<NWG>;
  using P = Parts<F32>;
  extern __shared__ unsigned char smem_raw[];
  const unsigned base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(base + L::FULL + 8 * s, 1);         // the producer's arrive
      mbar_init(base + L::EMPTY + 8 * s, NWG * 4);  // one lane per consumer warp
    }
    for (int buf = 0; buf < 2; ++buf) {
      mbar_init(base + L::LOADED + 8 * buf, 1);
      mbar_init(base + L::FREE + 8 * buf, NWG * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= NWG * 4) {
    setmaxnreg_dec<BL::PRODUCER_REGS>();
    if (threadIdx.x == NWG * 128)
      produce_fwd<F32, NWG, KT>(maps, base, items, row_blocks, S, H);
    return;
  }
  setmaxnreg_inc<BL::CONSUMER_REGS>();
  const int wg = warp / 4;
  const Lanes ln;
  const int tiles = (S + KT - 1) / KT;
  const bool ragged = S % KT != 0;
  const float scale2 = scale * LOG2E;
  const Ring<L::STAGES> ring{base + L::FULL, base + L::EMPTY};
  int g = 0;  // tiles taken so far, over all items
  for (int w = blockIdx.x, n = 0; w < items;
       w += gridDim.x, ++n, g += tiles) {
    const Item it = item_at(w, row_blocks, Block<NWG>::ITEM_ROWS, H);
    const int buf = n & 1;
    const int row0 = it.r0 + wg * 64 + (warp % 4) * 16;
    if (it.r0 + wg * 64 >= S) {
      // no row of this warpgroup exists: it only hands the tiles back
      for (int t = 0; t < tiles; ++t) {
        ring.wait_full(g + t);
        ring.release(g + t);
      }
      if (threadIdx.x % 32 == 0) mbar_arrive(base + L::FREE + 8 * buf);
      continue;
    }
    mbar_wait(base + L::LOADED + 8 * buf, (n >> 1) & 1);
    __syncwarp();
    unsigned q[P::QK][4];
#pragma unroll
    for (int p = 0; p < P::QK; ++p)
      load_a_sw32(q[p], base + L::Q + buf * L::Q_BYTES + p * NWG * L::QT +
                            wg * L::QT,
                  warp % 4);
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(base + L::FREE + 8 * buf);

    float o[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
    RowStats st{{-CUDART_INF_F, -CUDART_INF_F}, {0.f, 0.f}};
    int t = 0;
    for (; t + 1 < tiles; ++t)
      key_tile<F32, NWG, KT, false>(o, st, ring, base, g + t, t, q, S,
                                       scale2, ln.tg);
    if (t < tiles) {
      if (ragged)
        key_tile<F32, NWG, KT, true>(o, st, ring, base, g + t, t, q, S,
                                        scale2, ln.tg);
      else
        key_tile<F32, NWG, KT, false>(o, st, ring, base, g + t, t, q, S,
                                         scale2, ln.tg);
    }

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float l = st.l[half];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / l;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        o[nt][2 * half] *= inv;
        o[nt][2 * half + 1] *= inv;
      }
      const int row = row0 + ln.g + 8 * half;
      if (lse != nullptr && ln.tg == 0 && row < S)
        lse[((int64_t)it.b * H + it.h) * S + row] =
            st.m[half] * scale + logf(l);
    }
    store_rows<16>(o_out, o, it.b, it.h, row0, S, H, ln);
  }
}

// ---- backward --------------------------------------------------------------

// Each side is two operands, a (q or k) and b (v or do): dK/dV owns K and
// V and streams Q and dO with their row statistics; dQ owns Q and dO and
// streams K and V.
template <bool F32, int NWG>
struct BwdLayout {
  using P = Parts<F32>;
  static constexpr int STAGES = 4;
  static constexpr int T64 = tile_bytes(64);
  static constexpr int OWN_PARTS = P::QK + P::VD;
  static constexpr int OWN = 0;  // [2][OWN_PARTS][NWG] tiles of 64 rows
  static constexpr int OWN_BYTES = OWN_PARTS * NWG * T64;  // one buffer
  static constexpr int RING = 2 * OWN_BYTES;  // [STAGES][a parts, b parts]
  static constexpr int STAGE_BYTES = OWN_PARTS * T64;
  static constexpr int STATS = RING + STAGES * STAGE_BYTES;  // [STAGES][2][64]
  static constexpr int BARS = STATS + STAGES * 2 * ST * 4;
  static constexpr int FULL = BARS, EMPTY = FULL + 8 * STAGES,
                       LOADED = EMPTY + 8 * STAGES, FREE = LOADED + 16;
  static constexpr int DYNAMIC = FREE + 16 + 1024;
  static_assert(DYNAMIC <= 232448, "shared memory of one block");
};

// The producer warp: per item the own rows' parts (a box of 64 rows a
// warpgroup and part) into the buffer the consumers have freed, then the
// streamed tiles, with their rows' lse·log2(e) and di·scale for dK/dV.
template <bool DKV, bool F32, int NWG>
__device__ __forceinline__ void produce_bwd(
    const Maps<F32>& m, const float* __restrict__ lse,
    const float* __restrict__ di, unsigned base, float* stats, int items,
    int row_blocks, int S, int H, float scale) {
  using L = BwdLayout<F32, NWG>;
  using P = Parts<F32>;
  const CUtensorMap* own_a = DKV ? m.k : m.q;
  const CUtensorMap* own_b = DKV ? m.v : m.dout;
  const CUtensorMap* str_a = DKV ? m.q : m.k;
  const CUtensorMap* str_b = DKV ? m.dout : m.v;
  const int lane = threadIdx.x % 32;
  const int tiles = (S + ST - 1) / ST;
  int g = 0;
  for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n) {
    const Item it = item_at(w, row_blocks, Block<NWG>::ITEM_ROWS, H);
    const int buf = n & 1;
    mbar_wait(base + L::FREE + 8 * buf, ((n >> 1) & 1) ^ 1);
    if (lane == 0) {
      const unsigned loaded = base + L::LOADED + 8 * buf;
      const unsigned dst = base + L::OWN + buf * L::OWN_BYTES;
      mbar_arrive_expect(loaded, L::OWN_BYTES);
#pragma unroll
      for (int i = 0; i < NWG; ++i) {
#pragma unroll
        for (int p = 0; p < P::QK; ++p)
          tma_load_4d(dst + (p * NWG + i) * L::T64, &own_a[p], loaded, 0,
                      it.r0 + 64 * i, it.h, it.b);
#pragma unroll
        for (int p = 0; p < P::VD; ++p)
          tma_load_4d(dst + ((P::QK + p) * NWG + i) * L::T64, &own_b[p],
                      loaded, 0, it.r0 + 64 * i, it.h, it.b);
      }
    }
    const float* lse_b = lse + ((int64_t)it.b * H + it.h) * S;
    const float* di_b = di + ((int64_t)it.b * H + it.h) * S;
    for (int t = 0; t < tiles; ++t, ++g) {
      const int stage = g % L::STAGES;
      mbar_wait(base + L::EMPTY + 8 * stage, ((g / L::STAGES) & 1) ^ 1);
      if (DKV) {
        float* st = stats + stage * 2 * ST;
#pragma unroll
        for (int i = lane; i < ST; i += 32) {
          const int row = t * ST + i;
          st[i] = row < S ? lse_b[row] * LOG2E : 0.f;
          st[ST + i] = row < S ? di_b[row] * scale : 0.f;
        }
        __syncwarp();
      }
      if (lane == 0) {
        const unsigned full = base + L::FULL + 8 * stage;
        const unsigned dst = base + L::RING + stage * L::STAGE_BYTES;
        mbar_arrive_expect(full, L::STAGE_BYTES);
#pragma unroll
        for (int p = 0; p < P::QK; ++p)
          tma_load_4d(dst + p * L::T64, &str_a[p], full, 0, t * ST, it.h,
                      it.b);
#pragma unroll
        for (int p = 0; p < P::VD; ++p)
          tma_load_4d(dst + (P::QK + p) * L::T64, &str_b[p], full, 0, t * ST,
                      it.h, it.b);
      }
    }
  }
}

// What a consumer warp reads of a backward ring stage: the streamed a
// parts' and b parts' descriptors.
template <bool F32, int NWG>
struct BwdStage {
  uint64_t a[Parts<F32>::QK], b[Parts<F32>::VD];
  __device__ __forceinline__ BwdStage(unsigned base, int g) {
    using L = BwdLayout<F32, NWG>;
    const uint64_t d0 =
        sw32_desc(base + L::RING + (g % L::STAGES) * L::STAGE_BYTES);
#pragma unroll
    for (int p = 0; p < Parts<F32>::QK; ++p) a[p] = d0 + p * (L::T64 >> 4);
#pragma unroll
    for (int p = 0; p < Parts<F32>::VD; ++p)
      b[p] = d0 + (Parts<F32>::QK + p) * (L::T64 >> 4);
  }
};

// d += X · B over the 64 streamed rows (the gradient products), X (p or
// ds) from float32 accumulators: bf16 rounded, float32 split in two, B
// the streamed operand's parts read MN-major (float32: hi and lo).
template <bool F32, int NB>
__device__ __forceinline__ void grad_product(float (&d)[2][4],
                                             const unsigned (&x_hi)[4][4],
                                             const unsigned (&x_lo)[4][4],
                                             const uint64_t (&b)[NB]) {
  if constexpr (F32)
    ab16_split(d, x_hi, x_lo, b[0], b[1]);
  else
    ab16(d, x_hi, b[0]);
}

// p and ds of one logits pair into A fragments (bf16: rounded, in *_hi;
// float32: split). lse2 and dis: per element pair of fragment (j, i), the
// two columns' or this row's lse·log2(e) and di·scale, as `stat` gives
// them; EDGE masks the columns past S.
template <bool F32, bool EDGE, bool WANT_P, typename Stat>
__device__ __forceinline__ void p_ds(const float (&s)[8][4],
                                     const float (&dp)[8][4],
                                     unsigned (&p_hi)[4][4],
                                     unsigned (&p_lo)[4][4],
                                     unsigned (&ds_hi)[4][4],
                                     unsigned (&ds_lo)[4][4], int col0, int S,
                                     float scale, Stat stat) {
  const float scale2 = scale * LOG2E;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int nt = 2 * j + i / 2, e = 2 * (i % 2);
      float2 lse2, dis;
      stat(nt, e, lse2, dis);
      float p0 = ex2(fmaf(s[nt][e], scale2, -lse2.x));
      float p1 = ex2(fmaf(s[nt][e + 1], scale2, -lse2.y));
      if (EDGE) {
        const int col = col0 + nt * 8;
        if (col >= S) p0 = 0.f;
        if (col + 1 >= S) p1 = 0.f;
      }
      const float d0 = p0 * fmaf(dp[nt][e], scale, -dis.x);
      const float d1 = p1 * fmaf(dp[nt][e + 1], scale, -dis.y);
      if constexpr (F32) {
        if (WANT_P) split_pack(p0, p1, p_hi[j][i], p_lo[j][i]);
        split_pack(d0, d1, ds_hi[j][i], ds_lo[j][i]);
      } else {
        if (WANT_P) p_hi[j][i] = pack_bf16(p0, p1);
        ds_hi[j][i] = pack_bf16(d0, d1);
      }
    }
}

// One persistent block of either backward kernel. DKV: out_a = dk,
// out_b = dv for the keys of each item; else out_a = dq for its queries.
template <bool DKV, bool F32, int NWG, typename T>
__device__ __forceinline__ void bwd_block(const Maps<F32>& maps,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ di,
                                          T* __restrict__ out_a,
                                          T* __restrict__ out_b, int items,
                                          int row_blocks, int S, int H,
                                          float scale) {
  using L = BwdLayout<F32, NWG>;
  using BL = Block<NWG>;
  using P = Parts<F32>;
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = smem_u32(smem_raw);
  const unsigned base = (raw + 1023u) & ~1023u;
  float* stats = reinterpret_cast<float*>(smem_raw + (base - raw) + L::STATS);
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(base + L::FULL + 8 * s, 1);
      mbar_init(base + L::EMPTY + 8 * s, NWG * 4);
    }
    for (int buf = 0; buf < 2; ++buf) {
      mbar_init(base + L::LOADED + 8 * buf, 1);
      mbar_init(base + L::FREE + 8 * buf, NWG * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= NWG * 4) {
    setmaxnreg_dec<BL::PRODUCER_REGS>();
    if (warp > NWG * 4) return;  // one warp of the producer's group works
    produce_bwd<DKV, F32, NWG>(maps, lse, di, base, stats, items, row_blocks,
                               S, H, scale);
    return;
  }
  setmaxnreg_inc<BL::CONSUMER_REGS>();
  const int wg = warp / 4;
  const Lanes ln;
  const int tiles = (S + ST - 1) / ST;
  const Ring<L::STAGES> ring{base + L::FULL, base + L::EMPTY};
  int g = 0;
  for (int w = blockIdx.x, n = 0; w < items;
       w += gridDim.x, ++n, g += tiles) {
    const Item it = item_at(w, row_blocks, Block<NWG>::ITEM_ROWS, H);
    const int buf = n & 1;
    const int row0 = it.r0 + wg * 64 + (warp % 4) * 16;
    if (it.r0 + wg * 64 >= S) {
      for (int t = 0; t < tiles; ++t) {
        ring.wait_full(g + t);
        ring.release(g + t);
      }
      if (threadIdx.x % 32 == 0) mbar_arrive(base + L::FREE + 8 * buf);
      continue;
    }
    mbar_wait(base + L::LOADED + 8 * buf, (n >> 1) & 1);
    __syncwarp();
    // this warp's 16 rows of the own operands' parts as A fragments for
    // the whole walk
    const unsigned own = base + L::OWN + buf * L::OWN_BYTES + wg * L::T64;
    unsigned own_a[P::QK][4], own_b[P::VD][4];
#pragma unroll
    for (int p = 0; p < P::QK; ++p)
      load_a_sw32(own_a[p], own + p * NWG * L::T64, warp % 4);
#pragma unroll
    for (int p = 0; p < P::VD; ++p)
      load_a_sw32(own_b[p], own + (P::QK + p) * NWG * L::T64, warp % 4);
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(base + L::FREE + 8 * buf);

    float acc_a[2][4], acc_b[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_a[nt][e] = acc_b[nt][e] = 0.f;
    // dQ: lse·log2(e) and di·scale of this lane's rows g and g + 8 (0 past
    // S: those rows are not written)
    float row_lse2[2] = {0.f, 0.f}, row_dis[2] = {0.f, 0.f};
    if (!DKV) {
      const int64_t stat0 = ((int64_t)it.b * H + it.h) * S;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + ln.g + 8 * half;
        if (row < S) {
          row_lse2[half] = lse[stat0 + row] * LOG2E;
          row_dis[half] = di[stat0 + row] * scale;
        }
      }
    }
    for (int t = 0; t < tiles; ++t) {
      const int gt = g + t;
      const bool edge = (t + 1) * ST > S;
      ring.wait_full(gt);
      const BwdStage<F32, NWG> stg(base, gt);
      float s[8][4], dp[8][4];
      wgmma_fence();
      abt_parts(s, own_a, stg.a, MmaN<64>{});
      abt_parts(dp, own_b, stg.b, MmaN<64>{});
      wgmma_commit();
      wgmma_wait<0>();
      acc_fence(s);
      acc_fence(dp);
      unsigned p_hi[4][4], p_lo[4][4], ds_hi[4][4], ds_lo[4][4];
      const int col0 = t * ST + 2 * ln.tg;
      if constexpr (DKV) {
        // the columns are queries: their statistics from the stage
        const float* sp = stats + (gt % L::STAGES) * 2 * ST + 2 * ln.tg;
        auto stat = [&](int nt, int, float2& l2, float2& d2) {
          l2 = *reinterpret_cast<const float2*>(sp + nt * 8);
          d2 = *reinterpret_cast<const float2*>(sp + ST + nt * 8);
        };
        if (edge)
          p_ds<F32, true, true>(s, dp, p_hi, p_lo, ds_hi, ds_lo, col0, S,
                                scale, stat);
        else
          p_ds<F32, false, true>(s, dp, p_hi, p_lo, ds_hi, ds_lo, col0, S,
                                 scale, stat);
        wgmma_fence();
        grad_product<F32>(acc_b, p_hi, p_lo, stg.b);  // dv += Pᵀ·dO
        grad_product<F32>(acc_a, ds_hi, ds_lo, stg.a);  // dk += dSᵀ·Q
        wgmma_commit();
      } else {
        auto stat = [&](int, int e, float2& l2, float2& d2) {
          l2 = make_float2(row_lse2[e / 2], row_lse2[e / 2]);
          d2 = make_float2(row_dis[e / 2], row_dis[e / 2]);
        };
        if (edge)
          p_ds<F32, true, false>(s, dp, p_hi, p_lo, ds_hi, ds_lo, col0, S,
                                 scale, stat);
        else
          p_ds<F32, false, false>(s, dp, p_hi, p_lo, ds_hi, ds_lo, col0, S,
                                  scale, stat);
        wgmma_fence();
        grad_product<F32>(acc_a, ds_hi, ds_lo, stg.a);  // dq += dS·K
        wgmma_commit();
      }
      wgmma_wait<0>();
      acc_fence(acc_a);
      acc_fence(acc_b);
      ring.release(gt);
    }
    store_rows<16>(out_a, acc_a, it.b, it.h, row0, S, H, ln);
    if (DKV) store_rows<16>(out_b, acc_b, it.b, it.h, row0, S, H, ln);
  }
}

// Encodes the maps (`encode(maps)`) and launches `kernel`, a block of NWG
// consumer warpgroups, as one persistent block per SM (fewer where there
// is less work) over the items of 64·NWG rows; `args` follow the maps.
template <typename M, int NWG, typename Kernel, typename Encode,
          typename... Args>
int launch(Kernel kernel, int dynamic, int B, int S, int H,
           cudaStream_t stream, Encode encode, Args... args) {
  using BL = Block<NWG>;
  if (B < 1 || S < 1 || H < 1) return (int)cudaErrorInvalidValue;
  M maps;
  cudaError_t err = encode(maps);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic);
  if (err != cudaSuccess) return (int)err;
  int device, sms;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return (int)err;
  const int row_blocks = (S + BL::ITEM_ROWS - 1) / BL::ITEM_ROWS;
  const int64_t items = (int64_t)row_blocks * H * B;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int grid = (int)(items < sms ? items : sms);
  kernel<<<grid, BL::THREADS, dynamic, stream>>>(maps, args..., (int)items,
                                             row_blocks, S, H);
  return (int)cudaGetLastError();
}

// The maps of the float32 kernels' split copies (contiguous bf16
// [parts, B, S, H, 16] in the split pass's order: q and k hi, lo; v and
// do hi, lo, lo2), `operands` of them (3: no do), q's parts a box of
// `q_rows` rows, the others' of `box_rows`.
inline cudaError_t split_maps(Maps<true>& m, const void* split, int operands,
                              int B, int S, int H, int q_rows,
                              int box_rows) {
  const int64_t n = (int64_t)B * S * H * 16;
  const bf16* at = (const bf16*)split;
  const Strides cs{(int64_t)S * H * 16, (int64_t)H * 16, 16};
  CUtensorMap* maps[10] = {&m.q[0], &m.q[1], &m.k[0], &m.k[1],
                           &m.v[0], &m.v[1], &m.v[2], &m.dout[0],
                           &m.dout[1], &m.dout[2]};
  const int parts = operands == 4 ? 10 : 7;
  for (int i = 0; i < parts; ++i) {
    const cudaError_t err = make_map16(maps[i], at + i * n, cs, B, S, H,
                                       i < 2 ? q_rows : box_rows);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace d16
}  // namespace vcd
