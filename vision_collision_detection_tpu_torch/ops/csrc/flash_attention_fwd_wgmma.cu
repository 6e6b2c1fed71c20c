// K4 forward for bf16 and head_dim 64, the scaled ViViT configuration's
// case, on Hopper's warpgroup products (wgmma) fed by the Tensor Memory
// Accelerator; and, at the end, bf16 with head_dim 16 (vivit_tiny), the
// design of flash_d16.cuh.
//
// Replaces the same TPU kernel as flash_attention.cu (the JAX library's
// `_flash_attention_kernel_single_batch` behind
// vision_collision_detection_tpu/ops/flash_attention.py `flash_mha`), with
// the same function and roundings: logits, running max, row sum and output
// in float32; p rounded to bf16 before p @ v; the row sum taken from the
// unrounded p; one division at the end; the float32 log-sum-exp [B, H, S]
// written when the caller wants a gradient. Keys past S are masked by
// length, queries past S are computed on zero rows and not written.
//
// Bound on the H100: 4*S^2*D flops per (batch, head) against 8*S*D bytes,
// S/2 flops per byte, at S = 576 a hair under the card's ridge (bytes bind).
// The mma.sync kernel this replaces for bf16 and head_dim 64 ran 64 queries
// a block of 4 warps (13,824 small blocks at [256, 576, 6, 64]), reloaded K
// and V per 64 queries, stopped the block at two barriers a tile and could
// not overlap its softmax with the tensor cores.
//
// Design, on the parts of the backward (flash_attention_bwd_wgmma.cu). The
// grid is persistent, one block per SM; a work item is 192 queries of one
// (batch, head), three consumer warpgroups of 64 queries (576 = 3 * 192).
// One producer warp loads the item's Q tiles by TMA into one of two
// buffers and streams K and V tile pairs of 64 keys through a ring of
// mbarrier-guarded stages; every tile serves all three warpgroups. Each
// consumer warp takes its 16 query rows into registers as A fragments once
// per item. The walk takes two key tiles an iteration: s0 = Q K0^T and
// s1 = Q K1^T start together; s0's softmax runs while s1's product is in
// flight, o += P0 V0 starts, s1's softmax runs under it, then o += P1 V1.
// Every group is drained before the loop's back edge (ptxas serialises the
// products of a loop that leaves one in flight there). The exponentials are
// ex2 of logits scaled by scale * log2(e) minus the running max so scaled,
// one FMA each; the running max is kept in unscaled logits. Only the last
// tile of a length that is no multiple of 64 pays for the key mask.
#include "flash_d16.cuh"

namespace {

using namespace vcd;

constexpr int NWG = 3;      // consumer warpgroups, 64 queries each
constexpr int STAGES = 6;   // K, V tile pairs in flight
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of one block, as byte offsets from its 1024-aligned base.
struct Layout {
  static constexpr int Q = 0;  // [2 buffers][NWG] tiles
  static constexpr int Q_BYTES = NWG * TILE_BYTES;  // one buffer
  static constexpr int RING = 2 * Q_BYTES;          // [STAGES][K, V] tiles
  static constexpr int BARS = RING + STAGES * 2 * TILE_BYTES;
  // ring: FULL and EMPTY per stage; Q buffers: LOADED and FREE each
  static constexpr int FULL = BARS, EMPTY = FULL + 8 * STAGES,
                       LOADED = EMPTY + 8 * STAGES, FREE = LOADED + 16;
  static constexpr int BYTES = FREE + 16;
  static constexpr int DYNAMIC = BYTES + 1024;  // room to align the base
  // the producer is a warpgroup of which one warp works (see the backward)
  static constexpr int THREADS = (NWG + 1) * 128;
  static constexpr int CONSUMER_REGS = 160, PRODUCER_REGS = 32;
};

// The producer warp's lane 0: per item the Q tiles into the buffer the
// consumers have freed, then every K, V tile pair of the (batch, head)
// through the ring, running ahead across items.
__device__ __forceinline__ void produce(const CUtensorMap* map_q,
                                        const CUtensorMap* map_k,
                                        const CUtensorMap* map_v,
                                        unsigned base, int items,
                                        int row_blocks, int S, int H) {
  using L = Layout;
  const int tiles = (S + TILE_ROWS - 1) / TILE_ROWS;
  int g = 0;  // tiles started so far, over all items
  for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n) {
    const Item it = item_at(w, row_blocks, 64 * NWG, H);
    const int buf = n & 1;
    mbar_wait(base + L::FREE + 8 * buf, ((n >> 1) & 1) ^ 1);
    const unsigned loaded = base + L::LOADED + 8 * buf;
    mbar_arrive_expect(loaded, L::Q_BYTES);
#pragma unroll
    for (int i = 0; i < NWG; ++i)
      tma_load_4d(base + L::Q + buf * L::Q_BYTES + i * TILE_BYTES, map_q,
                  loaded, 0, it.r0 + 64 * i, it.h, it.b);
    for (int t = 0; t < tiles; ++t, ++g) {
      const int stage = g % STAGES;
      mbar_wait(base + L::EMPTY + 8 * stage, ((g / STAGES) & 1) ^ 1);
      const unsigned full = base + L::FULL + 8 * stage;
      const unsigned dst = base + L::RING + stage * 2 * TILE_BYTES;
      mbar_arrive_expect(full, 2 * TILE_BYTES);
      tma_load_4d(dst, map_k, full, 0, t * TILE_ROWS, it.h, it.b);
      tma_load_4d(dst + TILE_BYTES, map_v, full, 0, t * TILE_ROWS, it.h,
                  it.b);
    }
  }
}

// What a consumer warp needs of the ring; g counts the block's tiles over
// all of its items.
struct Ring {
  unsigned base;
  // descriptor of tile g's K; its V is one tile on
  __device__ __forceinline__ uint64_t k_tile(int g) const {
    return sw128_desc(base + Layout::RING) +
           (g % STAGES) * (2 * TILE_BYTES >> 4);
  }
  __device__ __forceinline__ void wait_full(int g) const {
    mbar_wait(base + Layout::FULL + 8 * (g % STAGES), (g / STAGES) & 1);
    __syncwarp();
  }
  // this warp has read everything of tile g
  __device__ __forceinline__ void release(int g) const {
    __syncwarp();
    if (threadIdx.x % 32 == 0)
      mbar_arrive(base + Layout::EMPTY + 8 * (g % STAGES));
  }
};

// The running statistics of this lane's rows g and g + 8: the largest
// unscaled logit so far and this lane's part of the row sum.
struct RowStats {
  float m[2], l[2];
};

// One tile's online softmax on its logits s (this warp's 16 rows x 64 keys):
// the running max and sum move on, alpha is the factor that rescales what
// o has summed so far, p the weights rounded to bf16 as A fragments. key0:
// the key of this lane's first column. EDGE: the tile ends past S.
template <bool EDGE>
__device__ __forceinline__ void softmax_tile(float (&s)[8][4], RowStats& st,
                                             float (&alpha)[2],
                                             unsigned (&p)[4][4], int key0,
                                             int S, float scale2) {
  if (EDGE) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (key0 + nt * 8 + (e & 1) >= S) s[nt][e] = -CUDART_INF_F;
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      mx = fmaxf(mx, fmaxf(s[nt][2 * half], s[nt][2 * half + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // every tile holds a key below S, so m_new is finite; the first tile's
    // alpha is ex2(-inf) = 0
    const float m_new = fmaxf(st.m[half], mx);
    alpha[half] = ex2((st.m[half] - m_new) * scale2);
    st.m[half] = m_new;
    const float mb = m_new * scale2;
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 2 * half; e < 2 * half + 2; ++e) {
        s[nt][e] = ex2(fmaf(s[nt][e], scale2, -mb));
        sum += s[nt][e];
      }
    st.l[half] = st.l[half] * alpha[half] + sum;
  }
  acc_to_a(s, p);
}

__device__ __forceinline__ void rescale(float (&o)[8][4],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    o[nt][0] *= alpha[0];
    o[nt][1] *= alpha[0];
    o[nt][2] *= alpha[1];
    o[nt][3] *= alpha[1];
  }
}

// s = Q · K^T for the K tile of ring tile g, as one wgmma group.
__device__ __forceinline__ void start_logits(float (&s)[8][4],
                                             const unsigned (&q_f)[4][4],
                                             const Ring& ring, int g) {
  ring.wait_full(g);
  wgmma_fence();
  wgmma_tile_abt(s, q_f, ring.k_tile(g));
  wgmma_commit();
}

// o += P · V for the V tile of ring tile g, as one wgmma group.
__device__ __forceinline__ void start_pv(float (&o)[8][4],
                                         const unsigned (&p)[4][4],
                                         const Ring& ring, int g) {
  wgmma_fence();
  wgmma_tile_ab(o, p, ring.k_tile(g) + (TILE_BYTES >> 4));
  wgmma_commit();
}

// Key tiles t and t + 1 (ring tiles g, g + 1); EDGE1: t + 1 ends past S.
template <bool EDGE1>
__device__ __forceinline__ void tile_pair(float (&o)[8][4], RowStats& st,
                                          const Ring& ring, int g, int t,
                                          const unsigned (&q_f)[4][4], int S,
                                          float scale2, int tg) {
  float s0[8][4], s1[8][4], a0[2], a1[2];
  unsigned p0[4][4], p1[4][4];
  start_logits(s0, q_f, ring, g);
  start_logits(s1, q_f, ring, g + 1);
  wgmma_wait<1>();
  acc_fence(s0);
  softmax_tile<false>(s0, st, a0, p0, t * TILE_ROWS + 2 * tg, S, scale2);
  rescale(o, a0);
  start_pv(o, p0, ring, g);
  wgmma_wait<1>();
  acc_fence(s1);
  softmax_tile<EDGE1>(s1, st, a1, p1, (t + 1) * TILE_ROWS + 2 * tg, S,
                      scale2);
  wgmma_wait<0>();
  acc_fence(o);
  ring.release(g);
  rescale(o, a1);
  start_pv(o, p1, ring, g + 1);
  wgmma_wait<0>();
  acc_fence(o);
  ring.release(g + 1);
}

// Key tile t alone (ring tile g); EDGE: it ends past S.
template <bool EDGE>
__device__ __forceinline__ void tile_single(float (&o)[8][4], RowStats& st,
                                            const Ring& ring, int g, int t,
                                            const unsigned (&q_f)[4][4],
                                            int S, float scale2, int tg) {
  float s[8][4], a[2];
  unsigned p[4][4];
  start_logits(s, q_f, ring, g);
  wgmma_wait<0>();
  acc_fence(s);
  softmax_tile<EDGE>(s, st, a, p, t * TILE_ROWS + 2 * tg, S, scale2);
  rescale(o, a);
  start_pv(o, p, ring, g);
  wgmma_wait<0>();
  acc_fence(o);
  ring.release(g);
}

__global__ void __launch_bounds__(Layout::THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       bf16* __restrict__ o_out, float* __restrict__ lse,
                       int items, int row_blocks, int S, int H,
                       float scale) {
  using L = Layout;
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = smem_u32(smem_raw);
  const unsigned base = (raw + 1023u) & ~1023u;
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
    if (threadIdx.x == NWG * 128)
      produce(&map_q, &map_k, &map_v, base, items, row_blocks, S, H);
    return;
  }
  setmaxnreg_inc<L::CONSUMER_REGS>();
  const int wg = warp / 4;
  const Lanes ln;
  const int tiles = (S + TILE_ROWS - 1) / TILE_ROWS;
  const bool ragged = S % TILE_ROWS != 0;
  const float scale2 = scale * LOG2E;
  const Ring ring{base};
  int g = 0;  // tiles taken so far, over all items
  for (int w = blockIdx.x, n = 0; w < items;
       w += gridDim.x, ++n, g += tiles) {
    const Item it = item_at(w, row_blocks, 64 * NWG, H);
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
    unsigned q_f[4][4];
    load_a_sw128(q_f, base + L::Q + buf * L::Q_BYTES + wg * TILE_BYTES,
                 warp % 4);
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(base + L::FREE + 8 * buf);

    float o[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
    RowStats st{{-CUDART_INF_F, -CUDART_INF_F}, {0.f, 0.f}};
    int t = 0;
    for (; t + 2 < tiles; t += 2)
      tile_pair<false>(o, st, ring, g + t, t, q_f, S, scale2, ln.tg);
    if (t + 2 == tiles) {
      if (ragged)
        tile_pair<true>(o, st, ring, g + t, t, q_f, S, scale2, ln.tg);
      else
        tile_pair<false>(o, st, ring, g + t, t, q_f, S, scale2, ln.tg);
    } else {
      if (ragged)
        tile_single<true>(o, st, ring, g + t, t, q_f, S, scale2, ln.tg);
      else
        tile_single<false>(o, st, ring, g + t, t, q_f, S, scale2, ln.tg);
    }

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float l = st.l[half];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / l;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        o[nt][2 * half] *= inv;
        o[nt][2 * half + 1] *= inv;
      }
      const int row = row0 + ln.g + 8 * half;
      if (lse != nullptr && ln.tg == 0 && row < S)
        lse[((int64_t)it.b * H + it.h) * S + row] =
            st.m[half] * scale + logf(l);
    }
    store_rows<64>(o_out, o, it.b, it.h, row0, S, H, ln);
  }
}

}  // namespace

// q, k, v: bf16 [B, S, H, 64] given with element strides `strides[9]` =
// (batch, sequence, head) of q, k, v, the last axis contiguous, every row
// and stride 16-byte aligned. o: contiguous bf16 [B, S, H, 64]; lse:
// float32 [B, H, S] or null.
extern "C" int vcd_flash_fwd_wgmma(const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   const int64_t* strides, int B, int S,
                                   int H, float scale, void* stream) {
  using L = Layout;
  static_assert(L::DYNAMIC <= 232448, "shared memory of one block");
  if (B < 1 || S < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const int64_t* s = strides;
  CUtensorMap mq, mk, mv;
  cudaError_t err;
  if ((err = make_map(&mq, q, {s[0], s[1], s[2]}, B, S, H)) != cudaSuccess ||
      (err = make_map(&mk, k, {s[3], s[4], s[5]}, B, S, H)) != cudaSuccess ||
      (err = make_map(&mv, v, {s[6], s[7], s[8]}, B, S, H)) != cudaSuccess)
    return (int)err;
  err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::DYNAMIC);
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
  flash_fwd_wgmma_kernel<<<grid, L::THREADS, L::DYNAMIC,
                           (cudaStream_t)stream>>>(
      mq, mk, mv, (bf16*)o, (float*)lse, (int)items, row_blocks, S, H, scale);
  return (int)cudaGetLastError();
}

namespace {

using D16Layout = d16::FwdLayout<false, d16::FWD_NWG, d16::FWD_KT>;

__global__ void __launch_bounds__(d16::Block<d16::FWD_NWG>::THREADS, 1)
flash_fwd_wgmma_d16_kernel(const __grid_constant__ d16::Maps<false> maps,
                           bf16* __restrict__ o, float* __restrict__ lse,
                           float scale, int items, int row_blocks, int S,
                           int H) {
  d16::fwd_block<false, d16::FWD_NWG, d16::FWD_KT>(maps, o, lse, items,
                                                   row_blocks, S, H, scale);
}

}  // namespace

// The same for head_dim 16: q, k, v bf16 [B, S, H, 16] given with element
// strides `strides[9]`, the last axis contiguous, every stride 16-byte
// aligned; o contiguous bf16 [B, S, H, 16]; lse float32 [B, H, S] or null.
extern "C" int vcd_flash_fwd_wgmma_d16(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       const int64_t* strides, int B, int S,
                                       int H, float scale, void* stream) {
  const int64_t* s = strides;
  return d16::launch<d16::Maps<false>, d16::FWD_NWG>(
      flash_fwd_wgmma_d16_kernel, D16Layout::DYNAMIC, B, S, H,
      (cudaStream_t)stream,
      [&](d16::Maps<false>& m) {
        cudaError_t err;
        if ((err = make_map16(&m.q[0], q, {s[0], s[1], s[2]}, B, S, H,
                              d16::Block<d16::FWD_NWG>::ITEM_ROWS)) !=
                cudaSuccess ||
            (err = make_map16(&m.k[0], k, {s[3], s[4], s[5]}, B, S, H,
                              d16::FWD_KT)) != cudaSuccess)
          return err;
        return make_map16(&m.v[0], v, {s[6], s[7], s[8]}, B, S, H,
                          d16::FWD_KT);
      },
      (bf16*)o, (float*)lse, scale);
}
