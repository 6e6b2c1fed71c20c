// K4 forward for float32 and head_dim 64 (a float32 ViViT with
// attention_impl="flash"), on Hopper's warpgroup products (wgmma) fed by the
// Tensor Memory Accelerator, with float32 accuracy from split bf16
// products (flash_f32.cuh); the split pass that K4's float32 kernels read
// their operands through (head_dim 64 and 16); and, at the end, float32
// with head_dim 16 (vivit_tiny), the design of flash_d16.cuh on the split
// copies.
//
// Replaces the same TPU kernel as flash_attention.cu (the JAX library's
// `_flash_attention_impl`, whose pallas_call runs the float32 operands of a
// float32 model with float32 accumulation), with the function of the
// plain version flash_mha_plain on float32 inputs: logits, softmax, p (not
// rounded) and output in float32, one division at the end, the float32
// log-sum-exp [B, H, S] written when the caller wants a gradient. Keys past
// S are masked by length, queries past S are computed on zero rows and not
// written. The CUDA-core kernel of flash_attention.cu (one thread a query,
// every product a scalar float32 FMA: at most 67 TFLOP/s) stays compiled
// for head_dim 16 and as the card's yardstick.
//
// Bound on the H100, per (batch, head): the function's two products,
// 2*S^2*D flops each, taken to float32 accuracy as three bf16 products
// apiece, 12*S^2*D flops at 989 TFLOP/s, against 16*S*D bytes (q, k, v
// in, o out, float32): operations bind (at S = 576, about 1.5 times the
// bytes' time). This design issues 8 bf16 products, not 6 (three for the
// logits, five for p*v). The split pass moves 4 bytes an element of each
// operand in and 2 a part out, and is bound by bytes.
//
// Design: the bf16 forward's (flash_attention_fwd_wgmma.cu) with every
// tile doubled, read from the split copies that the split pass below
// wrote (vcd_flash_split_f32, launched by the wrapper before this
// kernel). A persistent block per SM; a work item is 192 queries of one
// (batch, head), three consumer warpgroups of 64. The producer warp
// loads the item's Q hi and lo tiles into one of two buffers and streams
// the K hi, K lo, V hi, V lo, V lo2 tiles of 64 keys through a ring of
// STAGES mbarrier-guarded stages (40 KB each). Each consumer warp takes
// its 16 query rows into registers as hi and lo A fragments once per item.
// Per key tile: s = Q K^T as three products, one wait, the online softmax
// in float32 (exponentials as ex2 of logits prescaled by scale * log2(e),
// the running max in unscaled logits), p split into hi and lo A fragments
// in registers, o rescaled, o += P V as five products, one wait. A
// warpgroup overlaps nothing of its own; the block's other two fill the
// tensor cores meanwhile (one key tile at a time keeps q, o, s and p's two
// halves within 160 registers). No wgmma group stays in flight across the
// loop's back edge.
#include "flash_d16.cuh"

namespace {

using namespace vcd;

constexpr int NWG = 3;      // consumer warpgroups, 64 queries each
constexpr int STAGES = 3;   // K, V tile sets in flight
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of one block, as byte offsets from its 1024-aligned base.
struct Layout {
  static constexpr int Q = 0;  // [2 buffers][NWG][hi, lo] tiles
  static constexpr int Q_BYTES = NWG * 2 * TILE_BYTES;  // one buffer
  // [STAGES][K hi, K lo, V hi, V lo, V lo2]
  static constexpr int RING = 2 * Q_BYTES;
  static constexpr int STAGE_BYTES = 5 * TILE_BYTES;
  static constexpr int BARS = RING + STAGES * STAGE_BYTES;
  // ring: FULL and EMPTY per stage; Q buffers: LOADED and FREE each
  static constexpr int FULL = BARS, EMPTY = FULL + 8 * STAGES,
                       LOADED = EMPTY + 8 * STAGES, FREE = LOADED + 16;
  static constexpr int BYTES = FREE + 16;
  static constexpr int DYNAMIC = BYTES + 1024;  // room to align the base
  // the producer is a warpgroup of which one warp works
  static constexpr int THREADS = (NWG + 1) * 128;
  static constexpr int CONSUMER_REGS = 160, PRODUCER_REGS = 32;
};

// The tensor maps of the split copies, in the scratch's order: q and k
// hi and lo, v hi, lo and lo2.
struct Maps {
  CUtensorMap q_hi, q_lo, k_hi, k_lo, v_hi, v_lo, v_lo2;
};

// The producer warp's lane 0: per item the Q hi and lo tiles into the
// buffer the consumers have freed, then every K, V tile set of the
// (batch, head) through the ring, running ahead across items.
__device__ __forceinline__ void produce(const Maps* m, unsigned base,
                                        int items, int row_blocks, int S,
                                        int H) {
  using L = Layout;
  const int tiles = (S + TILE_ROWS - 1) / TILE_ROWS;
  int g = 0;  // tiles started so far, over all items
  for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n) {
    const Item it = item_at(w, row_blocks, 64 * NWG, H);
    const int buf = n & 1;
    mbar_wait(base + L::FREE + 8 * buf, ((n >> 1) & 1) ^ 1);
    const unsigned loaded = base + L::LOADED + 8 * buf;
    const unsigned q = base + L::Q + buf * L::Q_BYTES;
    mbar_arrive_expect(loaded, L::Q_BYTES);
#pragma unroll
    for (int i = 0; i < NWG; ++i) {
      tma_load_4d(q + 2 * i * TILE_BYTES, &m->q_hi, loaded, 0,
                  it.r0 + 64 * i, it.h, it.b);
      tma_load_4d(q + (2 * i + 1) * TILE_BYTES, &m->q_lo, loaded, 0,
                  it.r0 + 64 * i, it.h, it.b);
    }
    for (int t = 0; t < tiles; ++t, ++g) {
      const int stage = g % STAGES;
      mbar_wait(base + L::EMPTY + 8 * stage, ((g / STAGES) & 1) ^ 1);
      const unsigned full = base + L::FULL + 8 * stage;
      const unsigned dst = base + L::RING + stage * L::STAGE_BYTES;
      const int r = t * TILE_ROWS;
      mbar_arrive_expect(full, L::STAGE_BYTES);
      tma_load_4d(dst, &m->k_hi, full, 0, r, it.h, it.b);
      tma_load_4d(dst + TILE_BYTES, &m->k_lo, full, 0, r, it.h, it.b);
      tma_load_4d(dst + 2 * TILE_BYTES, &m->v_hi, full, 0, r, it.h, it.b);
      tma_load_4d(dst + 3 * TILE_BYTES, &m->v_lo, full, 0, r, it.h, it.b);
      tma_load_4d(dst + 4 * TILE_BYTES, &m->v_lo2, full, 0, r, it.h, it.b);
    }
  }
}

// What a consumer warp needs of the ring; g counts the block's tiles over
// all of its items.
struct Ring {
  unsigned base;
  // descriptor of tile g's K hi; K lo, V hi, V lo, V lo2 follow a tile
  // apart
  __device__ __forceinline__ uint64_t k_hi(int g) const {
    return sw128_desc(base + Layout::RING) +
           (g % STAGES) * (Layout::STAGE_BYTES >> 4);
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

constexpr uint64_t TILE_DESC = TILE_BYTES >> 4;  // one tile, in descriptor units

// The running statistics of this lane's rows g and g + 8: the largest
// unscaled logit so far and this lane's part of the row sum.
struct RowStats {
  float m[2], l[2];
};

// Key tile t (ring tile g) for this warp's 16 queries: s = Q K^T, the
// online softmax, o += P V. key0: the key of this lane's first column.
// EDGE: the tile ends past S.
template <bool EDGE>
__device__ __forceinline__ void key_tile(float (&o)[8][4], RowStats& st,
                                         const Ring& ring, int g, int key0,
                                         const unsigned (&q_hi)[4][4],
                                         const unsigned (&q_lo)[4][4], int S,
                                         float scale2) {
  const uint64_t k_hi = ring.k_hi(g);
  float s[8][4];
  ring.wait_full(g);
  wgmma_fence();
  split_abt(s, q_hi, q_lo, k_hi, k_hi + TILE_DESC);
  wgmma_commit();
  wgmma_wait<0>();
  acc_fence(s);
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
    const float alpha = ex2((st.m[half] - m_new) * scale2);
    st.m[half] = m_new;
    const float mb = m_new * scale2;
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 2 * half; e < 2 * half + 2; ++e) {
        s[nt][e] = ex2(fmaf(s[nt][e], scale2, -mb));
        sum += s[nt][e];
      }
      o[nt][2 * half] *= alpha;
      o[nt][2 * half + 1] *= alpha;
    }
    st.l[half] = st.l[half] * alpha + sum;
  }
  unsigned p_hi[4][4], p_lo[4][4];
  acc_to_a_split(s, p_hi, p_lo);
  wgmma_fence();
  split_ab5(o, p_hi, p_lo, k_hi + 2 * TILE_DESC, k_hi + 3 * TILE_DESC,
            k_hi + 4 * TILE_DESC);
  wgmma_commit();
  wgmma_wait<0>();
  acc_fence(o);
  ring.release(g);
}

__global__ void __launch_bounds__(Layout::THREADS, 1)
flash_fwd_f32_wgmma_kernel(const __grid_constant__ Maps maps,
                     float* __restrict__ o_out, float* __restrict__ lse,
                     int items, int row_blocks, int S, int H, float scale) {
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
      produce(&maps, base, items, row_blocks, S, H);
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
    unsigned q_hi[4][4], q_lo[4][4];
    const unsigned q = base + L::Q + buf * L::Q_BYTES + 2 * wg * TILE_BYTES;
    load_a_sw128(q_hi, q, warp % 4);
    load_a_sw128(q_lo, q + TILE_BYTES, warp % 4);
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(base + L::FREE + 8 * buf);

    float o[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
    RowStats st{{-CUDART_INF_F, -CUDART_INF_F}, {0.f, 0.f}};
    const int whole = ragged ? tiles - 1 : tiles;
    for (int t = 0; t < whole; ++t)
      key_tile<false>(o, st, ring, g + t, t * TILE_ROWS + 2 * ln.tg, q_hi,
                      q_lo, S, scale2);
    if (ragged)
      key_tile<true>(o, st, ring, g + whole, whole * TILE_ROWS + 2 * ln.tg,
                     q_hi, q_lo, S, scale2);

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

// The operands of one split launch, float32 [B, S, H, 64] each with its
// strides, and the parts each writes: hi, lo and lo2 (null where the
// operand has two parts).
struct SplitOperands {
  const float* x[4];
  Strides st[4];
  bf16* part[4][3];
};

// The split pass: operand blockIdx.y; one thread takes 8 neighbouring
// values of a row of D (64 or 16; two 16-byte loads) and writes their hi
// and lo parts (16 bytes each), and lo2 where the operand has it.
__global__ void __launch_bounds__(256)
flash_split_f32_kernel(SplitOperands ops, int S, int H, int D,
                       int64_t rows) {
  const int64_t gid = (int64_t)blockIdx.x * 256 + threadIdx.x;
  const int64_t row = gid / (D / 8);
  const int col = (int)(gid % (D / 8)) * 8;
  if (row >= rows) return;
  const int op = blockIdx.y;
  const Strides st = ops.st[op];
  bf16* const hi = ops.part[op][0];
  bf16* const lo = ops.part[op][1];
  bf16* const lo2 = ops.part[op][2];
  const int h = (int)(row % H), s = (int)(row / H % S);
  const int64_t b = row / H / S;
  const float* src = ops.x[op] + b * st.b + s * st.s + h * st.h + col;
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 c = *reinterpret_cast<const float4*>(src + 4);
  const float v[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
  unsigned p_hi[4], p_lo[4], p_lo2[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    split_pack(v[2 * i], v[2 * i + 1], p_hi[i], p_lo[i]);
    if (lo2 != nullptr) {
      // x - hi - lo, exact in float32, rounded once more
      const float2 hf = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&p_hi[i]));
      const float2 lf = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&p_lo[i]));
      p_lo2[i] =
          pack_bf16(v[2 * i] - hf.x - lf.x, v[2 * i + 1] - hf.y - lf.y);
    }
  }
  *reinterpret_cast<uint4*>(hi + row * D + col) =
      make_uint4(p_hi[0], p_hi[1], p_hi[2], p_hi[3]);
  *reinterpret_cast<uint4*>(lo + row * D + col) =
      make_uint4(p_lo[0], p_lo[1], p_lo[2], p_lo[3]);
  if (lo2 != nullptr)
    *reinterpret_cast<uint4*>(lo2 + row * D + col) =
        make_uint4(p_lo2[0], p_lo2[1], p_lo2[2], p_lo2[3]);
}

using D16Layout = d16::FwdLayout<true, d16::FWD_NWG, d16::FWD_KT>;

__global__ void __launch_bounds__(d16::Block<d16::FWD_NWG>::THREADS, 1)
flash_fwd_f32_d16_kernel(const __grid_constant__ d16::Maps<true> maps,
                         float* __restrict__ o, float* __restrict__ lse,
                         float scale, int items, int row_blocks, int S,
                         int H) {
  d16::fwd_block<true, d16::FWD_NWG, d16::FWD_KT>(maps, o, lse, items,
                                                  row_blocks, S, H, scale);
}

}  // namespace

// q, k, v and dout (or null): float32 [B, S, H, D] (D 64 or 16) given
// with element strides `strides[3 * operands]` = (batch, sequence, head)
// of each, the last axis contiguous, every row 16-byte aligned. split:
// contiguous bf16 [7 or 10, B, S, H, D], in this order: q and k hi, lo; v
// (and dout) hi, lo, lo2. One launch splits every operand.
extern "C" int vcd_flash_split_f32(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const int64_t* strides, void* split,
                                   int B, int S, int H, int D, void* stream) {
  if (B < 1 || S < 1 || H < 1 || (D != 64 && D != 16))
    return (int)cudaErrorInvalidValue;
  const void* const src[4] = {q, k, v, dout};
  const int n_parts[4] = {Q_PARTS, K_PARTS, V_PARTS, DO_PARTS};
  const int operands = dout != nullptr ? 4 : 3;
  const int64_t n = (int64_t)B * S * H * D;
  SplitOperands ops{};
  bf16* at = (bf16*)split;
  for (int i = 0; i < operands; ++i) {
    ops.x[i] = (const float*)src[i];
    ops.st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
    for (int p = 0; p < n_parts[i]; ++p) ops.part[i][p] = at + p * n;
    at += n_parts[i] * n;
  }
  const int64_t rows = (int64_t)B * S * H;
  const int64_t blocks = (rows * (D / 8) + 255) / 256;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  flash_split_f32_kernel<<<dim3((unsigned)blocks, operands), 256, 0,
                           (cudaStream_t)stream>>>(ops, S, H, D, rows);
  return (int)cudaGetLastError();
}

// split: contiguous bf16 [7, B, S, H, 64], vcd_flash_split_f32's copies of
// q, k, v. o: contiguous float32 [B, S, H, 64]; lse: float32 [B, H, S] or
// null.
extern "C" int vcd_flash_fwd_f32(const void* split, void* o, void* lse,
                                 int B, int S, int H, float scale,
                                 void* stream) {
  using L = Layout;
  static_assert(L::DYNAMIC <= 232448, "shared memory of one block");
  if (B < 1 || S < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int64_t n = split_elems(B, S, H);
  const bf16* parts = (const bf16*)split;
  cudaError_t err;
  const Strides cs = contiguous_strides(S, H);
  Maps maps;
  CUtensorMap* m[7] = {&maps.q_hi, &maps.q_lo, &maps.k_hi, &maps.k_lo,
                       &maps.v_hi, &maps.v_lo, &maps.v_lo2};
  for (int i = 0; i < 7; ++i)
    if ((err = make_map(m[i], parts + i * n, cs, B, S, H)) != cudaSuccess)
      return (int)err;
  err = cudaFuncSetAttribute(flash_fwd_f32_wgmma_kernel,
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
  flash_fwd_f32_wgmma_kernel<<<grid, L::THREADS, L::DYNAMIC, st>>>(
      maps, (float*)o, (float*)lse, (int)items, row_blocks, S, H, scale);
  return (int)cudaGetLastError();
}

// The same for head_dim 16: split, contiguous bf16 [7, B, S, H, 16]; o
// contiguous float32 [B, S, H, 16].
extern "C" int vcd_flash_fwd_f32_d16(const void* split, void* o, void* lse,
                                     int B, int S, int H, float scale,
                                     void* stream) {
  return d16::launch<d16::Maps<true>, d16::FWD_NWG>(
      flash_fwd_f32_d16_kernel, D16Layout::DYNAMIC, B, S, H,
      (cudaStream_t)stream,
      [&](d16::Maps<true>& m) {
        return d16::split_maps(m, split, 3, B, S, H,
                               d16::Block<d16::FWD_NWG>::ITEM_ROWS,
                               d16::FWD_KT);
      },
      (float*)o, (float*)lse, scale);
}
