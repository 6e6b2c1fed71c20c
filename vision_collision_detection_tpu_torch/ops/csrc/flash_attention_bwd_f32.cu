// K4 backward for float32 and head_dim 64 (a float32 ViViT with
// attention_impl="flash" in training): dK/dV and dQ on Hopper's warpgroup
// products (wgmma) fed by the Tensor Memory Accelerator, with float32
// accuracy from split bf16 products (flash_f32.cuh); and, at the end,
// float32 with head_dim 16 (vivit_tiny), the design of flash_d16.cuh on
// the split copies.
//
// Replace the same TPU kernels as flash_attention_bwd.cu (the JAX library's
// `_flash_attention_bwd_dkv` and `_flash_attention_bwd_dq`, which run a
// float32 model's operands with float32 accumulation), with the function of
// the plain versions flash_mha_bwd_dkv_plain and flash_mha_bwd_dq_plain on
// float32 inputs: p = exp(q k^T * scale - lse) recomputed and
// ds = p * (do v^T - di) * scale, both float32 and not rounded, float32
// accumulation, no float atomics (each block is the only writer of its
// rows and sums in a fixed order, so two runs agree bit for bit). The
// CUDA-core kernels of flash_attention_bwd.cu (one thread a key or a query,
// every product a scalar float32 FMA) stay compiled for head_dim 16 and as
// the card's yardstick.
//
// Bound on the H100, per (batch, head): operations. The function's
// products, 2*S^2*D flops each (dK/dV four: s^T, dp^T, dv, dk; dQ three:
// s, dp, dq), taken to float32 accuracy as three bf16 products apiece at
// 989 TFLOP/s: dK/dV 24*S^2*D flops, dQ 18*S^2*D, against 24*S*D and
// 20*S*D bytes (q, k, v, do read, the gradients written, float32). This
// design issues dK/dV 15 bf16 products (three for s^T, six for dp^T,
// three each for dv and dk) and dQ 12 (three, six, three). Both kernels
// read one set of split copies of q, k, v and do, which the wrapper has
// the split pass (vcd_flash_split_f32) write once a backward.
//
// Design: the bf16 backward's (flash_attention_bwd_wgmma.cu) with every
// tile doubled, and V's and dO's tripled (flash_f32.cuh says why). A
// persistent
// block per SM; a work item is 64*NWG rows of one (batch, head): keys for
// dK/dV (two consumer warpgroups), queries for dQ (three). The item's own
// rows of two operands (K and V, or Q and dO), in their parts, stay in
// shared memory for the whole walk and are read there as the A operands of
// the logits products: as register fragments they would add 64 registers
// a thread to what the doubled products already need. The other two
// operands (Q and dO with their lse and di, or K and V) stream through a
// ring of STAGES stages of their parts' tiles. One buffer holds the own
// tiles, so the producer loads an item's own tiles once the consumers have
// finished the item before; the ring runs on.
//
// Per streamed tile a consumer warpgroup starts the two logits products,
// s as three split products and dp as six (dQ: s = Q K^T, dp = dO V^T;
// dK/dV, transposed so that nothing leaves registers: s^T = K Q^T,
// dp^T = V dO^T), waits,
// computes p and ds in float32 in the accumulators' registers (exp as one
// fused multiply-add and one ex2, with lse * log2(e) and di * scale
// prepared per row), splits them into hi and lo A fragments, and starts
// the gradient products with B the streamed tiles read MN-major (dQ:
// dq += dS K; dK/dV: dv += P^T dO, dk += dS^T Q), three split products
// each, then waits again. No group stays in flight across the loop's back
// edge.
#include "flash_d16.cuh"

namespace {

using namespace vcd;

constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of one block, as byte offsets from its 1024-aligned base.
// Each side is two operands, a in two parts and b in three: DKV own K
// (hi, lo) and V (hi, lo, lo2), streamed Q and dO; dQ own Q and dO,
// streamed K and V.
template <bool DKV, int NWG, int STAGES>
struct Layout {
  static constexpr int OWN_PARTS = 5, STREAM_PARTS = 5;
  // [OWN_PARTS][NWG] tiles
  static constexpr int OWN = 0;
  static constexpr int OWN_BYTES = OWN_PARTS * NWG * TILE_BYTES;
  // [STAGES][STREAM_PARTS] tiles
  static constexpr int RING = OWN_BYTES;
  static constexpr int STAGE_BYTES = STREAM_PARTS * TILE_BYTES;
  static constexpr int STATS = RING + STAGES * STAGE_BYTES;  // [STAGES][2][64] float
  static constexpr int BARS = STATS + STAGES * 2 * TILE_ROWS * 4;
  // ring: FULL and EMPTY per stage; own tiles: LOADED and FREE
  static constexpr int FULL = BARS, EMPTY = FULL + 8 * STAGES,
                       LOADED = EMPTY + 8 * STAGES, FREE = LOADED + 8;
  static constexpr int BYTES = FREE + 8;
  static constexpr int DYNAMIC = BYTES + 1024;  // room to align the base
  static constexpr int THREADS = (NWG + 1) * 128;
  // registers a thread, as in the bf16 backward: the block is launched with
  // 65,536 / THREADS, the producer's warpgroup keeps PRODUCER_REGS
  static constexpr int CONSUMER_REGS = NWG == 2 ? 232 : 160;
  static constexpr int PRODUCER_REGS = NWG == 2 ? 40 : 32;
  static_assert(NWG == 2 || NWG == 3, "two or three consumer warpgroups");
};

// The tensor maps of the split copies, in the scratch's order: q and k
// hi and lo, v and do hi, lo and lo2.
struct Maps {
  CUtensorMap q_hi, q_lo, k_hi, k_lo, v_hi, v_lo, v_lo2, do_hi, do_lo,
      do_lo2;
};

constexpr uint64_t TILE_DESC = TILE_BYTES >> 4;  // one tile, in descriptor units

// The producer warp: per item the block's own tiles once the consumers
// have finished the item before, then the streamed tiles of queries with
// their row statistics (DKV) or of keys through the ring, which runs ahead
// of the consumers by STAGES tiles.
template <bool DKV, int NWG, int STAGES>
__device__ __forceinline__ void produce(const Maps* m,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ di,
                                        unsigned base, float* stats,
                                        int items, int row_blocks, int S,
                                        int H, float scale) {
  using L = Layout<DKV, NWG, STAGES>;
  const CUtensorMap* kv[5] = {&m->k_hi, &m->k_lo, &m->v_hi, &m->v_lo,
                              &m->v_lo2};
  const CUtensorMap* qdo[5] = {&m->q_hi, &m->q_lo, &m->do_hi, &m->do_lo,
                               &m->do_lo2};
  const CUtensorMap* const* own = DKV ? kv : qdo;
  const CUtensorMap* const* str = DKV ? qdo : kv;
  const int lane = threadIdx.x % 32;
  const int tiles = (S + TILE_ROWS - 1) / TILE_ROWS;
  int g = 0;  // tiles started so far, over all items
  for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n) {
    const Item it = item_at(w, row_blocks, 64 * NWG, H);
    mbar_wait(base + L::FREE, (n & 1) ^ 1);
    if (lane == 0) {
      const unsigned loaded = base + L::LOADED;
      mbar_arrive_expect(loaded, L::OWN_BYTES);
#pragma unroll
      for (int part = 0; part < L::OWN_PARTS; ++part)
#pragma unroll
        for (int i = 0; i < NWG; ++i)
          tma_load_4d(base + L::OWN + (part * NWG + i) * TILE_BYTES,
                      own[part], loaded, 0, it.r0 + 64 * i, it.h, it.b);
    }
    const float* lse_b = lse + ((int64_t)it.b * H + it.h) * S;
    const float* di_b = di + ((int64_t)it.b * H + it.h) * S;
    for (int t = 0; t < tiles; ++t, ++g) {
      const int stage = g % STAGES;
      mbar_wait(base + L::EMPTY + 8 * stage, ((g / STAGES) & 1) ^ 1);
      if (DKV) {
        float* st = stats + stage * 2 * TILE_ROWS;
#pragma unroll
        for (int i = lane; i < TILE_ROWS; i += 32) {
          const int row = t * TILE_ROWS + i;
          st[i] = row < S ? lse_b[row] * LOG2E : 0.f;
          st[TILE_ROWS + i] = row < S ? di_b[row] * scale : 0.f;
        }
        __syncwarp();
      }
      if (lane == 0) {
        const unsigned full = base + L::FULL + 8 * stage;
        const unsigned dst = base + L::RING + stage * L::STAGE_BYTES;
        mbar_arrive_expect(full, L::STAGE_BYTES);
#pragma unroll
        for (int part = 0; part < L::STREAM_PARTS; ++part)
          tma_load_4d(dst + part * TILE_BYTES, str[part], full, 0,
                      t * TILE_ROWS, it.h, it.b);
      }
    }
  }
}

// What a consumer warp needs of the ring.
template <bool DKV, int NWG, int STAGES>
struct Ring {
  using L = Layout<DKV, NWG, STAGES>;
  unsigned base;
  // descriptor of the first tile (operand a's hi) of tile g's stage; a lo,
  // b hi, b lo, b lo2 follow a tile apart
  __device__ __forceinline__ uint64_t tile(int g) const {
    return sw128_desc(base + L::RING) + (g % STAGES) * (L::STAGE_BYTES >> 4);
  }
  // g counts the block's tiles over all of its items
  __device__ __forceinline__ void wait_full(int g) const {
    mbar_wait(base + L::FULL + 8 * (g % STAGES), (g / STAGES) & 1);
    __syncwarp();
  }
  // this warp has read everything of tile g
  __device__ __forceinline__ void release(int g) const {
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(base + L::EMPTY + 8 * (g % STAGES));
  }
};

// Descriptors of this warpgroup's own tiles: operand a hi, a lo, b hi,
// b lo, b lo2.
struct Own {
  uint64_t a_hi, a_lo, b_hi, b_lo, b_lo2;
};

// The two logits products of one streamed tile (str: its first part's
// descriptor), as one wgmma group: s = own a · (str a)^T as three split
// products, dp = own b · (str b)^T as six (dO and V in three parts).
__device__ __forceinline__ void start_logits(float (&s)[8][4],
                                             float (&dp)[8][4],
                                             const Own& own, uint64_t str) {
  wgmma_fence();
  split_abt_ss(s, own.a_hi, own.a_lo, str, str + TILE_DESC);
  split6_abt_ss(dp, own.b_hi, own.b_lo, own.b_lo2, str + 2 * TILE_DESC,
                str + 3 * TILE_DESC, str + 4 * TILE_DESC);
  wgmma_commit();
}

// dQ, one tile of 64 keys for a warpgroup's 64 queries (own: their Q and
// dO): s = Q K^T, dp = dO V^T, dq += dS K. lse2 = lse * log2(e) and
// dis = di * scale of this lane's rows g and g + 8. EDGE: the tile ends
// past S.
template <int NWG, int STAGES, bool EDGE>
__device__ __forceinline__ void dq_tile(float (&dq)[8][4],
                                        const Ring<false, NWG, STAGES>& ring,
                                        int g,
                                        int t, const Own& own, int S,
                                        float scale, const float (&lse2)[2],
                                        const float (&dis)[2], int tg) {
  const float scale2 = scale * LOG2E;
  const uint64_t k = ring.tile(g);
  float s[8][4], dp[8][4];
  ring.wait_full(g);
  start_logits(s, dp, own, k);
  wgmma_wait<0>();
  acc_fence(s);
  acc_fence(dp);
  unsigned ds_hi[4][4], ds_lo[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int nt = 2 * j + i / 2, e = 2 * (i % 2);
      float p0 = ex2(fmaf(s[nt][e], scale2, -lse2[e / 2]));
      float p1 = ex2(fmaf(s[nt][e + 1], scale2, -lse2[e / 2]));
      if (EDGE) {
        const int col = t * TILE_ROWS + 2 * tg + nt * 8;
        if (col >= S) p0 = 0.f;
        if (col + 1 >= S) p1 = 0.f;
      }
      split_pack(p0 * fmaf(dp[nt][e], scale, -dis[e / 2]),
                 p1 * fmaf(dp[nt][e + 1], scale, -dis[e / 2]), ds_hi[j][i],
                 ds_lo[j][i]);
    }
  wgmma_fence();
  split_ab(dq, ds_hi, ds_lo, k, k + TILE_DESC);
  wgmma_commit();
  wgmma_wait<0>();
  acc_fence(dq);
  ring.release(g);
}

// dK and dV, one tile of 64 queries for a warpgroup's 64 keys (own: their
// K and V), on transposed tiles so that nothing leaves registers:
// p^T = exp(K Q^T * scale - lse), dp^T = V dO^T, dv += P^T dO,
// dk += dS^T Q. `stats`: per stage the tile's lse * log2(e) [64], then
// di * scale [64].
template <int NWG, int STAGES, bool EDGE>
__device__ __forceinline__ void dkv_tile(float (&dk)[8][4], float (&dv)[8][4],
                                         const Ring<true, NWG, STAGES>& ring,
                                         int g, int t, const Own& own,
                                         const float* stats, int S,
                                         float scale, int tg) {
  const float scale2 = scale * LOG2E;
  const uint64_t q = ring.tile(g), d = q + 2 * TILE_DESC;
  const float* st = stats + (g % STAGES) * 2 * TILE_ROWS + 2 * tg;
  float pt[8][4], dpt[8][4];
  ring.wait_full(g);
  start_logits(pt, dpt, own, q);
  wgmma_wait<0>();
  acc_fence(pt);
  acc_fence(dpt);
  unsigned p_hi[4][4], p_lo[4][4], ds_hi[4][4], ds_lo[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int nt = 2 * j + i / 2, e = 2 * (i % 2);
      const float2 lse2 = *reinterpret_cast<const float2*>(st + nt * 8);
      const float2 dis =
          *reinterpret_cast<const float2*>(st + TILE_ROWS + nt * 8);
      float p0 = ex2(fmaf(pt[nt][e], scale2, -lse2.x));
      float p1 = ex2(fmaf(pt[nt][e + 1], scale2, -lse2.y));
      if (EDGE) {
        const int col = t * TILE_ROWS + 2 * tg + nt * 8;
        if (col >= S) p0 = 0.f;
        if (col + 1 >= S) p1 = 0.f;
      }
      split_pack(p0, p1, p_hi[j][i], p_lo[j][i]);
      split_pack(p0 * fmaf(dpt[nt][e], scale, -dis.x),
                 p1 * fmaf(dpt[nt][e + 1], scale, -dis.y), ds_hi[j][i],
                 ds_lo[j][i]);
    }
  wgmma_fence();
  split_ab(dv, p_hi, p_lo, d, d + TILE_DESC);
  split_ab(dk, ds_hi, ds_lo, q, q + TILE_DESC);
  wgmma_commit();
  wgmma_wait<0>();
  acc_fence(dv);
  acc_fence(dk);
  ring.release(g);
}

// Calls tile(g, t, edge) for every tile t of a walk over S rows, g counting
// on from g0.
template <typename Tile>
__device__ __forceinline__ void walk(int S, int g0, Tile tile) {
  const int whole = S / TILE_ROWS;
  for (int t = 0; t < whole; ++t) tile(g0 + t, t, false);
  if (S % TILE_ROWS) tile(g0 + whole, whole, true);
}

// One persistent block of either kernel. DKV: out_a = dk, out_b = dv for
// the keys of each of its items. Else out_a = dq for the queries (out_b
// unused).
template <bool DKV, int NWG, int STAGES>
__device__ __forceinline__ void bwd_block(const Maps& maps,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ di,
                                          float* __restrict__ out_a,
                                          float* __restrict__ out_b,
                                          int items, int row_blocks, int S,
                                          int H, float scale) {
  using L = Layout<DKV, NWG, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = smem_u32(smem_raw);
  const unsigned base = (raw + 1023u) & ~1023u;
  float* stats =
      reinterpret_cast<float*>(smem_raw + (base - raw) + L::STATS);
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(base + L::FULL + 8 * s, 1);         // the producer's arrive
      mbar_init(base + L::EMPTY + 8 * s, NWG * 4);  // one lane per consumer warp
    }
    mbar_init(base + L::LOADED, 1);
    mbar_init(base + L::FREE, NWG * 4);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= NWG * 4) {
    setmaxnreg_dec<L::PRODUCER_REGS>();
    if (warp > NWG * 4) return;  // one warp of the producer's group works
    produce<DKV, NWG, STAGES>(&maps, lse, di, base, stats, items, row_blocks,
                              S, H, scale);
    return;
  }
  setmaxnreg_inc<L::CONSUMER_REGS>();
  const int wg = warp / 4;
  const Lanes ln;
  const int tiles = (S + TILE_ROWS - 1) / TILE_ROWS;
  const Ring<DKV, NWG, STAGES> ring{base};
  const uint64_t own0 = sw128_desc(base + L::OWN + wg * TILE_BYTES);
  const Own own{own0, own0 + NWG * TILE_DESC, own0 + 2 * NWG * TILE_DESC,
                own0 + 3 * NWG * TILE_DESC, own0 + 4 * NWG * TILE_DESC};
  int g = 0;  // tiles taken so far, over all items
  for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n, g += tiles) {
    const Item it = item_at(w, row_blocks, 64 * NWG, H);
    const int row0 = it.r0 + wg * 64 + (warp % 4) * 16;
    if (it.r0 + wg * 64 >= S) {
      // no row of this warpgroup exists: it only hands the tiles back
      for (int t = 0; t < tiles; ++t) {
        ring.wait_full(g + t);
        ring.release(g + t);
      }
      if (threadIdx.x % 32 == 0) mbar_arrive(base + L::FREE);
      continue;
    }
    mbar_wait(base + L::LOADED, n & 1);
    __syncwarp();
    float acc_a[8][4], acc_b[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_a[nt][e] = acc_b[nt][e] = 0.f;
    if constexpr (DKV) {
      walk(S, g, [&](int gt, int t, bool edge) {
        if (edge)
          dkv_tile<NWG, STAGES, true>(acc_a, acc_b, ring, gt, t, own, stats,
                                      S, scale, ln.tg);
        else
          dkv_tile<NWG, STAGES, false>(acc_a, acc_b, ring, gt, t, own,
                                       stats, S, scale, ln.tg);
      });
    } else {
      // lse * log2(e) and di * scale of rows g and g + 8 (0 past S: those
      // rows are not written)
      const int64_t stat0 = ((int64_t)it.b * H + it.h) * S;
      float lse2[2] = {0.f, 0.f}, dis[2] = {0.f, 0.f};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + ln.g + 8 * half;
        if (row < S) {
          lse2[half] = lse[stat0 + row] * LOG2E;
          dis[half] = di[stat0 + row] * scale;
        }
      }
      walk(S, g, [&](int gt, int t, bool edge) {
        if (edge)
          dq_tile<NWG, STAGES, true>(acc_a, ring, gt, t, own, S, scale, lse2,
                                     dis, ln.tg);
        else
          dq_tile<NWG, STAGES, false>(acc_a, ring, gt, t, own, S, scale,
                                      lse2, dis, ln.tg);
      });
    }
    // every product of the item has been waited for: the own tiles are
    // free for the next item's
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(base + L::FREE);
    store_rows<64>(out_a, acc_a, it.b, it.h, row0, S, H, ln);
    if (DKV) store_rows<64>(out_b, acc_b, it.b, it.h, row0, S, H, ln);
  }
}

// Warpgroups and ring stages a block: dK/dV two warpgroups (its two
// accumulators and two logits tiles need about 170 registers a thread with
// p's and ds's split fragments, more than three warpgroups can give) and
// 3 stages (80 KB of own tiles, 120 KB of ring); dQ three (192 queries;
// 576 = 3 * 192) and 2 stages (120 KB of own tiles, 80 KB of ring).
constexpr int DKV_NWG = 2, DKV_STAGES = 3, DQ_NWG = 3, DQ_STAGES = 2;

__global__ void __launch_bounds__(Layout<true, DKV_NWG, DKV_STAGES>::THREADS,
                                  1)
flash_bwd_dkv_f32_wgmma_kernel(const __grid_constant__ Maps maps,
                         const float* __restrict__ lse,
                         const float* __restrict__ di, float* __restrict__ dk,
                         float* __restrict__ dv, int items, int row_blocks,
                         int S, int H, float scale) {
  bwd_block<true, DKV_NWG, DKV_STAGES>(maps, lse, di, dk, dv, items,
                                       row_blocks, S, H, scale);
}

__global__ void __launch_bounds__(Layout<false, DQ_NWG, DQ_STAGES>::THREADS,
                                  1)
flash_bwd_dq_f32_wgmma_kernel(const __grid_constant__ Maps maps,
                        const float* __restrict__ lse,
                        const float* __restrict__ di, float* __restrict__ dq,
                        int items, int row_blocks, int S, int H,
                        float scale) {
  bwd_block<false, DQ_NWG, DQ_STAGES>(maps, lse, di, dq, nullptr, items,
                                      row_blocks, S, H, scale);
}

// Encodes the ten maps of the split copies and launches `kernel` as one
// persistent block per SM (fewer where there is less work) over the items
// of 64 * NWG rows.
template <bool DKV, int NWG, int STAGES, typename Kernel, typename... Outs>
int launch(Kernel kernel, const void* split, const void* lse, const void* di,
           int B, int S, int H, float scale, cudaStream_t stream,
           Outs... outs) {
  using L = Layout<DKV, NWG, STAGES>;
  static_assert(L::DYNAMIC <= 232448, "shared memory of one block");
  if (B < 1 || S < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const int64_t n = split_elems(B, S, H);
  const bf16* parts = (const bf16*)split;
  const Strides cs = contiguous_strides(S, H);
  Maps maps;
  CUtensorMap* m[10] = {&maps.q_hi,  &maps.q_lo,  &maps.k_hi,  &maps.k_lo,
                        &maps.v_hi,  &maps.v_lo,  &maps.v_lo2, &maps.do_hi,
                        &maps.do_lo, &maps.do_lo2};
  cudaError_t err;
  for (int i = 0; i < 10; ++i)
    if ((err = make_map(m[i], parts + i * n, cs, B, S, H)) != cudaSuccess)
      return (int)err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::DYNAMIC);
  if (err != cudaSuccess) return (int)err;
  int device, sms;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return (int)err;
  const int row_blocks = (S + 64 * NWG - 1) / (64 * NWG);
  const int64_t items = (int64_t)row_blocks * H * B;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int grid = (int)(items < sms ? items : sms);
  kernel<<<grid, L::THREADS, L::DYNAMIC, stream>>>(
      maps, (const float*)lse, (const float*)di, outs..., (int)items,
      row_blocks, S, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// split: contiguous bf16 [10, B, S, H, 64], vcd_flash_split_f32's copies
// of q, k, v, dout (q and k hi, lo; v and dout hi, lo, lo2). lse, di:
// float32 [B, H, S]. dk, dv (and dq below): contiguous float32
// [B, S, H, 64].
extern "C" int vcd_flash_bwd_dkv_f32(const void* split, const void* lse,
                                     const void* di, void* dk, void* dv,
                                     int B, int S, int H, float scale,
                                     void* stream) {
  return launch<true, DKV_NWG, DKV_STAGES>(
      flash_bwd_dkv_f32_wgmma_kernel, split, lse, di, B, S, H, scale,
      (cudaStream_t)stream, (float*)dk, (float*)dv);
}

extern "C" int vcd_flash_bwd_dq_f32(const void* split, const void* lse,
                                    const void* di, void* dq, int B, int S,
                                    int H, float scale, void* stream) {
  return launch<false, DQ_NWG, DQ_STAGES>(
      flash_bwd_dq_f32_wgmma_kernel, split, lse, di, B, S, H, scale,
      (cudaStream_t)stream, (float*)dq);
}

namespace {

constexpr int D16_DKV_NWG = d16::BWD_NWG<true, true>;
constexpr int D16_DQ_NWG = d16::BWD_NWG<false, true>;

__global__ void __launch_bounds__(d16::Block<D16_DKV_NWG>::THREADS, 1)
flash_bwd_dkv_f32_d16_kernel(const __grid_constant__ d16::Maps<true> maps,
                             const float* __restrict__ lse,
                             const float* __restrict__ di,
                             float* __restrict__ dk, float* __restrict__ dv,
                             float scale, int items, int row_blocks, int S,
                             int H) {
  d16::bwd_block<true, true, D16_DKV_NWG>(maps, lse, di, dk, dv, items,
                                          row_blocks, S, H, scale);
}

__global__ void __launch_bounds__(d16::Block<D16_DQ_NWG>::THREADS, 1)
flash_bwd_dq_f32_d16_kernel(const __grid_constant__ d16::Maps<true> maps,
                            const float* __restrict__ lse,
                            const float* __restrict__ di,
                            float* __restrict__ dq, float scale, int items,
                            int row_blocks, int S, int H) {
  d16::bwd_block<false, true, D16_DQ_NWG>(maps, lse, di, dq, (float*)nullptr,
                                          items, row_blocks, S, H, scale);
}

auto bwd16_split_maps(const void* split, int B, int S, int H) {
  return [=](d16::Maps<true>& m) {
    return d16::split_maps(m, split, 4, B, S, H, d16::ST, d16::ST);
  };
}

}  // namespace

// The same two for head_dim 16: split, contiguous bf16 [10, B, S, H, 16];
// dk, dv (and dq) contiguous float32 [B, S, H, 16].
extern "C" int vcd_flash_bwd_dkv_f32_d16(const void* split, const void* lse,
                                         const void* di, void* dk, void* dv,
                                         int B, int S, int H, float scale,
                                         void* stream) {
  return d16::launch<d16::Maps<true>, D16_DKV_NWG>(
      flash_bwd_dkv_f32_d16_kernel, d16::BwdLayout<true, D16_DKV_NWG>::DYNAMIC,
      B, S, H, (cudaStream_t)stream, bwd16_split_maps(split, B, S, H),
      (const float*)lse, (const float*)di, (float*)dk, (float*)dv, scale);
}

extern "C" int vcd_flash_bwd_dq_f32_d16(const void* split, const void* lse,
                                        const void* di, void* dq, int B,
                                        int S, int H, float scale,
                                        void* stream) {
  return d16::launch<d16::Maps<true>, D16_DQ_NWG>(
      flash_bwd_dq_f32_d16_kernel, d16::BwdLayout<true, D16_DQ_NWG>::DYNAMIC,
      B, S, H, (cudaStream_t)stream, bwd16_split_maps(split, B, S, H),
      (const float*)lse, (const float*)di, (float*)dq, scale);
}
