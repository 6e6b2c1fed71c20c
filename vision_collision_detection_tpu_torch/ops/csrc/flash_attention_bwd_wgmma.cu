// K4 backward for bf16 and head_dim 64, the scaled ViViT configuration's
// case: dK/dV and dQ on Hopper's warpgroup products (wgmma) fed by the
// Tensor Memory Accelerator; and, at the end, bf16 with head_dim 16
// (vivit_tiny), the design of flash_d16.cuh.
//
// Replace the same TPU kernels as flash_attention_bwd.cu (the JAX library's
// `_flash_attention_dkv_kernel` and `_flash_attention_dq_kernel` behind
// vision_collision_detection_tpu/ops/flash_attention.py `flash_mha`), with
// the same function and roundings: p = exp(q k^T * scale - lse) recomputed
// in float32, p and ds rounded to bf16 before their products, float32
// accumulation, no float atomics (each block is the only writer of its rows
// and sums in a fixed order, so two runs agree bit for bit).
//
// Bound on the H100: operations, 8*S^2*D flops per (batch, head) for dK/dV
// and 6*S^2*D for dQ against 12*S*D and 10*S*D bytes. The mma.sync kernels
// these replace read every 64 x 64 tile from shared memory once per warp
// (128 KB a block and tile for 2.1 MFLOP), which alone held them under half
// of the tensor cores' rate, and spent registers and instructions of every
// thread on addresses, zero-filling and two block-wide barriers a tile.
//
// Design. One block body serves both kernels. The grid is persistent, one
// block per SM. A work item is 64*NWG rows of one (batch, head): keys for
// dK/dV, queries for dQ. The item's own rows of two operands (K and V, or Q
// and dO) are loaded once, one 64-row tile per consumer warpgroup, and each
// warp takes its 16 rows of them into registers as A fragments; the other
// two operands (Q and dO with their lse and di, or K and V) stream through
// a ring of STAGES tile pairs. All tiles have one layout (hopper.cuh),
// written by TMA from one 4-D tensor map per operand, built from that
// tensor's own strides: no copy of a strided view, rows past S zero-filled
// by the hardware. One producer warp starts the loads and waits on "empty"
// mbarriers; each consumer warpgroup waits on the "full" ones, so the
// warpgroups drift apart and one's softmax arithmetic overlaps the others'
// products. The producer runs ahead across items (the next item's own tiles
// go into a second buffer), so a block never waits for its first loads.
//
// Per streamed tile a consumer warpgroup starts the two logits products as
// wgmma m64n64k16 (dQ: s = Q K^T, dp = dO V^T; dK/dV, transposed so that
// nothing leaves registers: s^T = K Q^T, dp^T = V dO^T), A from registers,
// B the streamed tile as it lies. It computes p and ds in the accumulators'
// registers (exp as one fused multiply-add and one ex2, with lse * log2(e)
// and di * scale prepared per row), rounds them to bf16 straight into A
// fragments, and starts the gradient products with B the same streamed tile
// read MN-major (dQ: dq += dS K; dK/dV: dv += P^T dO, dk += dS^T Q). A
// operands from registers halve the shared-memory reads of a product: at 64
// columns a wgmma that reads both operands from shared memory needs all of
// the SM's 128 bytes a clock. The producer's warps form a warpgroup of
// their own, of which one warp works, so that setmaxnreg can hand its
// registers to the consumers (232 a thread with two consumer warpgroups,
// 160 with three).
#include "flash_bwd_args.cuh"
#include "flash_d16.cuh"

namespace {

using namespace vcd;

constexpr int STAGES = 4;
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of one block, as byte offsets from its 1024-aligned base.
template <int NWG>
struct Layout {
  static constexpr int RESIDENT = 0;  // [2 buffers][2 operands][NWG] tiles
  static constexpr int RESIDENT_BYTES = 2 * NWG * TILE_BYTES;  // one buffer
  static constexpr int RING = 2 * RESIDENT_BYTES;  // [STAGES][2] tiles
  static constexpr int STATS = RING + STAGES * 2 * TILE_BYTES;  // [STAGES][2][64] float
  static constexpr int BARS = STATS + STAGES * 2 * TILE_ROWS * 4;
  // ring: FULL and EMPTY per stage; resident buffers: LOADED and FREE each
  static constexpr int FULL = BARS, EMPTY = FULL + 8 * STAGES,
                       LOADED = EMPTY + 8 * STAGES, FREE = LOADED + 16;
  static constexpr int BYTES = FREE + 16;
  static constexpr int DYNAMIC = BYTES + 1024;  // room to align the base
  // NWG consumer warpgroups and the producer's: with one warp more than a
  // multiple of four, one of the SM's four register files would hold an
  // extra warp and cap every thread's registers
  static constexpr int THREADS = (NWG + 1) * 128;
  // what setmaxnreg moves: the block is launched with 65,536 / THREADS
  // registers a thread (168 or 128), the producer's warpgroup keeps
  // PRODUCER_REGS and each consumer thread takes CONSUMER_REGS
  static constexpr int CONSUMER_REGS = NWG == 2 ? 232 : 160;
  static constexpr int PRODUCER_REGS = NWG == 2 ? 40 : 32;
  static_assert(NWG == 2 || NWG == 3, "two or three consumer warpgroups");
};

// The producer warp: per item the block's resident tiles into the buffer
// the consumers have freed, then the streamed tiles of queries with their
// row statistics (DKV) or of keys through the ring. It runs ahead of the
// consumers by one resident buffer and STAGES tiles, across items, so a
// block's first tiles are in shared memory before its consumers ask.
template <bool DKV, int NWG>
__device__ __forceinline__ void produce(
    const CUtensorMap* res_a, const CUtensorMap* res_b,
    const CUtensorMap* str_a, const CUtensorMap* str_b,
    const float* __restrict__ lse, const float* __restrict__ di,
    unsigned base, float* stats, int items, int row_blocks, int S, int H,
    float scale) {
  using L = Layout<NWG>;
  const int lane = threadIdx.x % 32;
  const int tiles = (S + TILE_ROWS - 1) / TILE_ROWS;
  int g = 0;  // tiles started so far, over all items
  for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n) {
    const Item it = item_at(w, row_blocks, 64 * NWG, H);
    const int buf = n & 1;
    mbar_wait(base + L::FREE + 8 * buf, ((n >> 1) & 1) ^ 1);
    if (lane == 0) {
      const unsigned loaded = base + L::LOADED + 8 * buf;
      const unsigned dst = base + L::RESIDENT + buf * L::RESIDENT_BYTES;
      mbar_arrive_expect(loaded, L::RESIDENT_BYTES);
#pragma unroll
      for (int i = 0; i < NWG; ++i) {
        tma_load_4d(dst + i * TILE_BYTES, res_a, loaded, 0, it.r0 + 64 * i,
                    it.h, it.b);
        tma_load_4d(dst + (NWG + i) * TILE_BYTES, res_b, loaded, 0,
                    it.r0 + 64 * i, it.h, it.b);
      }
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
        const unsigned dst = base + L::RING + stage * 2 * TILE_BYTES;
        mbar_arrive_expect(full, 2 * TILE_BYTES);
        tma_load_4d(dst, str_a, full, 0, t * TILE_ROWS, it.h, it.b);
        tma_load_4d(dst + TILE_BYTES, str_b, full, 0, t * TILE_ROWS, it.h,
                    it.b);
      }
    }
  }
}

// What a consumer warp needs of the ring.
template <int NWG>
struct Ring {
  using L = Layout<NWG>;
  unsigned base;
  // descriptor of the first tile of a stage; the second is one tile on
  __device__ __forceinline__ uint64_t tile(int stage) const {
    return sw128_desc(base + L::RING) + stage * (2 * TILE_BYTES >> 4);
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

// The two logits products of one streamed tile pair, as one wgmma group:
// s = a_s · tile^T, dp = a_dp · (the pair's second tile)^T.
__device__ __forceinline__ void start_logits(float (&s)[8][4],
                                             float (&dp)[8][4],
                                             const unsigned (&a_s)[4][4],
                                             const unsigned (&a_dp)[4][4],
                                             uint64_t tile) {
  wgmma_fence();
  wgmma_tile_abt(s, a_s, tile);
  wgmma_tile_abt(dp, a_dp, tile + (TILE_BYTES >> 4));
  wgmma_commit();
}

// A tile body starts its two logits products, waits, does all of its
// arithmetic, starts the gradient products and waits again: the warpgroup
// itself overlaps nothing, the block's other warpgroups fill the tensor
// cores meanwhile. Measured on the H100 this beat the finer order (exp under
// the second logits product, ds under the first gradient product: 0.762 ms
// against 0.717 for dK/dV at [256, 576, 6, 64]) and it keeps p out of the
// live registers. No group may stay in flight across the loop's back edge:
// ptxas 12.9 then serialises every wgmma of the loop behind a full wait (its
// note C7515), which cost a quarter of the time. EDGE is the last tile of a
// length that is no multiple of 64: only it pays for masking the columns
// past S (keys in dQ, queries in dK/dV).

// Calls tile(g, t, edge) for every tile t of a walk over S rows, g counting
// on from g0.
template <typename Tile>
__device__ __forceinline__ void walk(int S, int g0, Tile tile) {
  const int whole = S / TILE_ROWS;
  for (int t = 0; t < whole; ++t) tile(g0 + t, t, false);
  if (S % TILE_ROWS) tile(g0 + whole, whole, true);
}

// dQ, one tile of 64 keys for a warpgroup's 64 queries (q_f, do_f: this
// warp's rows of them as A fragments): s = Q K^T, dp = dO V^T, dq += dS K.
// lse2 = lse * log2(e) and dis = di * scale of this lane's rows g and g + 8.
template <int NWG, bool EDGE>
__device__ __forceinline__ void dq_tile(float (&dq)[8][4], const Ring<NWG>& ring,
                                        int g, int t,
                                        const unsigned (&q_f)[4][4],
                                        const unsigned (&do_f)[4][4],
                                        int S, float scale,
                                        const float (&lse2)[2],
                                        const float (&dis)[2], int tg) {
  const float scale2 = scale * LOG2E;
  const uint64_t k_s = ring.tile(g % STAGES);
  float s[8][4], dp[8][4];
  ring.wait_full(g);
  start_logits(s, dp, q_f, do_f, k_s);
  wgmma_wait<0>();
  unsigned ds[4][4];
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
      ds[j][i] = pack_bf16(p0 * fmaf(dp[nt][e], scale, -dis[e / 2]),
                           p1 * fmaf(dp[nt][e + 1], scale, -dis[e / 2]));
    }
  wgmma_fence();
  wgmma_tile_ab(dq, ds, k_s);
  wgmma_commit();
  wgmma_wait<0>();
  ring.release(g);
}

// dK and dV, one tile of 64 queries for a warpgroup's 64 keys (k_f, v_f:
// this warp's rows of them as A fragments), on transposed tiles so that
// nothing leaves registers:
// p^T = exp(K Q^T * scale - lse), dp^T = V dO^T, dv += P^T dO, dk += dS^T Q.
// `stats`: per stage the tile's lse * log2(e) [64], then di * scale [64].
template <int NWG, bool EDGE>
__device__ __forceinline__ void dkv_tile(float (&dk)[8][4], float (&dv)[8][4],
                                         const Ring<NWG>& ring, int g, int t,
                                         const unsigned (&k_f)[4][4],
                                         const unsigned (&v_f)[4][4],
                                         const float* stats, int S,
                                         float scale, int tg) {
  const float scale2 = scale * LOG2E;
  const uint64_t q_s = ring.tile(g % STAGES), do_s = q_s + (TILE_BYTES >> 4);
  const float* st = stats + (g % STAGES) * 2 * TILE_ROWS + 2 * tg;
  float pt[8][4], dpt[8][4];
  ring.wait_full(g);
  start_logits(pt, dpt, k_f, v_f, q_s);
  wgmma_wait<0>();
  unsigned pf[4][4], dsf[4][4];
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
      pf[j][i] = pack_bf16(p0, p1);
      dsf[j][i] = pack_bf16(p0 * fmaf(dpt[nt][e], scale, -dis.x),
                            p1 * fmaf(dpt[nt][e + 1], scale, -dis.y));
    }
  wgmma_fence();
  wgmma_tile_ab(dv, pf, do_s);
  wgmma_tile_ab(dk, dsf, q_s);
  wgmma_commit();
  wgmma_wait<0>();
  ring.release(g);
}

// One persistent block of either kernel. DKV: out_a = dk, out_b = dv for
// the keys of each of its items. Else out_a = dq for the queries (out_b
// unused).
template <bool DKV, int NWG>
__device__ __forceinline__ void bwd_block(
    const CUtensorMap& map_q, const CUtensorMap& map_k,
    const CUtensorMap& map_v, const CUtensorMap& map_do,
    const float* __restrict__ lse, const float* __restrict__ di,
    bf16* __restrict__ out_a, bf16* __restrict__ out_b, int items,
    int row_blocks, int S, int H, float scale) {
  using L = Layout<NWG>;
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
    for (int buf = 0; buf < 2; ++buf) {
      mbar_init(base + L::LOADED + 8 * buf, 1);
      mbar_init(base + L::FREE + 8 * buf, NWG * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= NWG * 4) {
    setmaxnreg_dec<L::PRODUCER_REGS>();
    if (warp > NWG * 4) return;  // one warp of the producer's group works
    if (DKV)
      produce<true, NWG>(&map_k, &map_v, &map_q, &map_do, lse, di, base,
                         stats, items, row_blocks, S, H, scale);
    else
      produce<false, NWG>(&map_q, &map_do, &map_k, &map_v, lse, di, base,
                          stats, items, row_blocks, S, H, scale);
  } else {
    setmaxnreg_inc<L::CONSUMER_REGS>();
    const int wg = warp / 4;
    const Lanes ln;
    const int tiles = (S + TILE_ROWS - 1) / TILE_ROWS;
    const Ring<NWG> ring{base};
    int g = 0;  // tiles taken so far, over all items
    for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n, g += tiles) {
      const Item it = item_at(w, row_blocks, 64 * NWG, H);
      const int buf = n & 1;
      const int row0 = it.r0 + wg * 64 + (warp % 4) * 16;
      if (it.r0 + wg * 64 < S) {
        mbar_wait(base + L::LOADED + 8 * buf, (n >> 1) & 1);
        __syncwarp();
        // this warp's 16 rows of the block's own operands (K and V, or Q
        // and dO) as A fragments for the whole walk; once every warp holds
        // its own, the producer may load the next item's over the tiles
        const unsigned own =
            base + L::RESIDENT + buf * L::RESIDENT_BYTES + wg * TILE_BYTES;
        unsigned own_a[4][4], own_b[4][4];
        load_a_sw128(own_a, own, warp % 4);
        load_a_sw128(own_b, own + NWG * TILE_BYTES, warp % 4);
        __syncwarp();
        if (threadIdx.x % 32 == 0) mbar_arrive(base + L::FREE + 8 * buf);

        float acc_a[8][4], acc_b[8][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc_a[nt][e] = acc_b[nt][e] = 0.f;
        if (DKV) {
          walk(S, g, [&](int gt, int t, bool edge) {
            if (edge)
              dkv_tile<NWG, true>(acc_a, acc_b, ring, gt, t, own_a, own_b,
                                  stats, S, scale, ln.tg);
            else
              dkv_tile<NWG, false>(acc_a, acc_b, ring, gt, t, own_a, own_b,
                                   stats, S, scale, ln.tg);
          });
        } else {
          // lse * log2(e) and di * scale of rows g and g + 8 (0 past S:
          // those rows are not written)
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
              dq_tile<NWG, true>(acc_a, ring, gt, t, own_a, own_b, S, scale,
                                 lse2, dis, ln.tg);
            else
              dq_tile<NWG, false>(acc_a, ring, gt, t, own_a, own_b, S, scale,
                                  lse2, dis, ln.tg);
          });
        }
        acc_fence(acc_a);
        store_rows<64>(out_a, acc_a, it.b, it.h, row0, S, H, ln);
        if (DKV) {
          acc_fence(acc_b);
          store_rows<64>(out_b, acc_b, it.b, it.h, row0, S, H, ln);
        }
      } else {
        // no row of this warpgroup exists: it only hands the tiles back
        for (int t = 0; t < tiles; ++t) {
          ring.wait_full(g + t);
          ring.release(g + t);
        }
        if (threadIdx.x % 32 == 0) mbar_arrive(base + L::FREE + 8 * buf);
      }
    }
  }
}

constexpr int DKV_NWG = 2, DQ_NWG = 3;

// Warpgroups a block, fixed per kernel by what was fastest on the H100 at
// [256, 576, 6, 64] without losing to the mma.sync kernels at [16, 1024, 6,
// 64]. dQ: three (192 queries; 576 = 3 * 192 leaves no block half empty;
// 0.43 ms against 0.52 with two, before the grid was made persistent).
// dK/dV: two (128 keys): its two accumulators, two logits tiles and two
// operand sets need about 200 registers a thread, which a block of three
// consumer warpgroups cannot give (160 at most; 0.89 ms with spills against
// 0.72 with two).
__global__ void __launch_bounds__(Layout<DKV_NWG>::THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_do,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int items, int row_blocks, int S,
                     int H, float scale) {
  bwd_block<true, DKV_NWG>(map_q, map_k, map_v, map_do, lse, di, dk, dv,
                           items, row_blocks, S, H, scale);
}

__global__ void __launch_bounds__(Layout<DQ_NWG>::THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_do,
                    const float* __restrict__ lse,
                    const float* __restrict__ di, bf16* __restrict__ dq,
                    int items, int row_blocks, int S, int H, float scale) {
  bwd_block<false, DQ_NWG>(map_q, map_k, map_v, map_do, lse, di, dq, nullptr,
                           items, row_blocks, S, H, scale);
}

// Encodes the four maps and launches `kernel` as one persistent block per SM
// (fewer where there is less work) over the items of 64 * NWG rows.
template <int NWG, typename Kernel, typename... Outs>
int launch(Kernel kernel, const BwdArgs& a, Outs... outs) {
  using L = Layout<NWG>;
  static_assert(L::DYNAMIC <= 232448, "shared memory of one block");
  CUtensorMap mq, mk, mv, md;
  cudaError_t err;
  if ((err = make_map(&mq, a.q, a.sq, a.B, a.S, a.H)) != cudaSuccess ||
      (err = make_map(&mk, a.k, a.sk, a.B, a.S, a.H)) != cudaSuccess ||
      (err = make_map(&mv, a.v, a.sv, a.B, a.S, a.H)) != cudaSuccess ||
      (err = make_map(&md, a.dout, a.sd, a.B, a.S, a.H)) != cudaSuccess)
    return (int)err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::DYNAMIC);
  if (err != cudaSuccess) return (int)err;
  int device, sms;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return (int)err;
  const int row_blocks = (a.S + 64 * NWG - 1) / (64 * NWG);
  const int64_t items = (int64_t)row_blocks * a.H * a.B;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int grid = (int)(items < sms ? items : sms);
  kernel<<<grid, L::THREADS, L::DYNAMIC, a.stream>>>(
      mq, mk, mv, md, (const float*)a.lse, (const float*)a.di, outs...,
      (int)items, row_blocks, a.S, a.H, a.scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, dout: bf16 [B, S, H, 64] given with element strides
// `strides[12]` = (batch, sequence, head) of q, k, v, dout, the last axis
// contiguous, every row and stride 16-byte aligned. lse, di: float32
// [B, H, S]. dk, dv (and dq below): contiguous bf16 [B, S, H, 64]. Each
// returns a cudaError_t as int: a tensor map that cannot be encoded, a
// refused attribute or launch.
extern "C" int vcd_flash_bwd_dkv_wgmma(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* di,
                                       void* dk, void* dv,
                                       const int64_t* strides, int B, int S,
                                       int H, float scale, void* stream) {
  if (B < 1 || S < 1 || H < 1) return (int)cudaErrorInvalidValue;
  return launch<DKV_NWG>(flash_bwd_dkv_kernel,
                         bwd_args(q, k, v, dout, lse, di, strides, B, S, H,
                                  scale, 0, stream),
                         (bf16*)dk, (bf16*)dv);
}

extern "C" int vcd_flash_bwd_dq_wgmma(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* di,
                                      void* dq, const int64_t* strides, int B,
                                      int S, int H, float scale,
                                      void* stream) {
  if (B < 1 || S < 1 || H < 1) return (int)cudaErrorInvalidValue;
  return launch<DQ_NWG>(flash_bwd_dq_kernel,
                        bwd_args(q, k, v, dout, lse, di, strides, B, S, H,
                                 scale, 0, stream),
                        (bf16*)dq);
}

namespace {

constexpr int D16_DKV_NWG = d16::BWD_NWG<true, false>;
constexpr int D16_DQ_NWG = d16::BWD_NWG<false, false>;

__global__ void __launch_bounds__(d16::Block<D16_DKV_NWG>::THREADS, 1)
flash_bwd_dkv_wgmma_d16_kernel(const __grid_constant__ d16::Maps<false> maps,
                               const float* __restrict__ lse,
                               const float* __restrict__ di,
                               bf16* __restrict__ dk, bf16* __restrict__ dv,
                               float scale, int items, int row_blocks, int S,
                               int H) {
  d16::bwd_block<true, false, D16_DKV_NWG>(maps, lse, di, dk, dv, items,
                                           row_blocks, S, H, scale);
}

__global__ void __launch_bounds__(d16::Block<D16_DQ_NWG>::THREADS, 1)
flash_bwd_dq_wgmma_d16_kernel(const __grid_constant__ d16::Maps<false> maps,
                              const float* __restrict__ lse,
                              const float* __restrict__ di,
                              bf16* __restrict__ dq, float scale, int items,
                              int row_blocks, int S, int H) {
  d16::bwd_block<false, false, D16_DQ_NWG>(maps, lse, di, dq, (bf16*)nullptr,
                                           items, row_blocks, S, H, scale);
}

// The maps of q, k, v, dout through their own strides, boxes of 64 rows.
auto bwd16_maps(const BwdArgs& a) {
  return [a](d16::Maps<false>& m) {
    cudaError_t err;
    if ((err = make_map16(&m.q[0], a.q, a.sq, a.B, a.S, a.H, d16::ST)) !=
            cudaSuccess ||
        (err = make_map16(&m.k[0], a.k, a.sk, a.B, a.S, a.H, d16::ST)) !=
            cudaSuccess ||
        (err = make_map16(&m.v[0], a.v, a.sv, a.B, a.S, a.H, d16::ST)) !=
            cudaSuccess)
      return err;
    return make_map16(&m.dout[0], a.dout, a.sd, a.B, a.S, a.H, d16::ST);
  };
}

}  // namespace

// The same two for head_dim 16: q, k, v, dout bf16 [B, S, H, 16] with
// element strides `strides[12]`, every stride 16-byte aligned; dk, dv
// (and dq) contiguous bf16 [B, S, H, 16].
extern "C" int vcd_flash_bwd_dkv_wgmma_d16(const void* q, const void* k,
                                           const void* v, const void* dout,
                                           const void* lse, const void* di,
                                           void* dk, void* dv,
                                           const int64_t* strides, int B,
                                           int S, int H, float scale,
                                           void* stream) {
  const BwdArgs a = bwd_args(q, k, v, dout, lse, di, strides, B, S, H, scale,
                             0, stream);
  return d16::launch<d16::Maps<false>, D16_DKV_NWG>(
      flash_bwd_dkv_wgmma_d16_kernel,
      d16::BwdLayout<false, D16_DKV_NWG>::DYNAMIC, B, S, H, a.stream,
      bwd16_maps(a), (const float*)lse, (const float*)di, (bf16*)dk,
      (bf16*)dv, scale);
}

extern "C" int vcd_flash_bwd_dq_wgmma_d16(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const void* lse, const void* di,
                                          void* dq, const int64_t* strides,
                                          int B, int S, int H, float scale,
                                          void* stream) {
  const BwdArgs a = bwd_args(q, k, v, dout, lse, di, strides, B, S, H, scale,
                             0, stream);
  return d16::launch<d16::Maps<false>, D16_DQ_NWG>(
      flash_bwd_dq_wgmma_d16_kernel,
      d16::BwdLayout<false, D16_DQ_NWG>::DYNAMIC, B, S, H, a.stream,
      bwd16_maps(a), (const float*)lse, (const float*)di, (bf16*)dq, scale);
}
