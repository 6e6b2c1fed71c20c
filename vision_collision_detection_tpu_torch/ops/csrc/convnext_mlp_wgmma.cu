// K3 for bf16 activations on Hopper's warpgroup products (wgmma) fed by the
// Tensor Memory Accelerator: the ConvNeXt block after the depthwise conv,
//   out = x + gamma * (GELU(LN(y) @ W1 + b1) @ W2 + b2),
// eval and train variants of one template body.
//
// Replaces the same TPU kernels as convnext_mlp.cu
// (vision_collision_detection_tpu/ops/convnext_mlp_pallas.py `_call` with
// `_eval_kernel` or `_train_kernel`, math `_ln_mlp`), with its roundings:
// LN with eps 1e-6 and two-pass float32 statistics, t = LN(y) rounded to
// bf16; products on bf16 with float32 accumulation; h_pre = t @ W1 + b1
// rounded to bf16; GELU (tanh or erf) in float32, rounded to bf16; the
// residual added in float32. The train variant also writes t, h_pre and
// m = h @ W2 + b2 in bf16; out uses the float32 m.
//
// Bound on the H100: eval, operations (16*C^2 flops per row against 6*C
// bytes); train, bytes at C <= 192 (18*C bytes per row: h_pre alone is 8*C)
// and operations above. The mma.sync kernel this replaces streamed all of
// W1 and W2 (16*C^2 bytes from L2) for every 64 rows, at 64 flops per byte
// of L2, and could not reach the tensor cores' rate with mma.sync.
//
// Design. The weights are read in nn.Linear's own layout, which is K-major
// for both products: W1 as [4C, C], W2 as [C, 4C]. The grid is persistent,
// one block per SM; a work item is BM = 64 * RG rows. One producer warp
// loads the item's rows of y by TMA into the t tiles (128-byte-swizzled,
// 64 columns of C each) and streams 64 x 64 weight tiles through a ring of
// mbarrier-guarded slots, per hidden chunk of 64 columns: the C/64 tiles of
// W1's chunk rows, then the C/64 tiles of W2's chunk columns, each with
// zeros past C. The consumer warpgroups normalise the rows of t in place
// (and the producer loads the next item's y once the last chunk's first
// product has read t). Per chunk each consumer warpgroup
//   1. h_pre = t @ W1_chunk^T by wgmma with both operands in shared memory,
//      a group a W1 tile, up to four in flight; b1 is read meanwhile;
//   2. + b1, bf16, GELU, bf16 in the accumulator's registers (the GELU form
//      chosen once a chunk: a per-element choice cost the erf form's
//      instructions on every element);
//   3. out_acc += h @ W2_chunk^T, a group an output tile.
// The [64, C] float32 second-product accumulator stays in registers for
// the whole item: C/2 registers a thread at full width. Up to C = 256 a
// warpgroup owns all C columns of its 64 rows (CG = 1): h goes from the
// accumulator straight into A fragments, as p does in K4. From C = 384 on,
// two warpgroups share 64 rows (CG = 2), each owning C/2 output columns
// and half of each chunk's first product; they exchange the bf16 h chunk
// through a swizzled tile in shared memory (two buffers, one named barrier
// a chunk) and read it as the second product's A operand there. At C = 768
// C/2 columns would need 192 accumulator registers (ptxas spilled and
// serialised the products): the hidden dimension is walked twice
// (PASSES), each pass producing half of a warpgroup's columns and
// recomputing the first product. Each pass is a work item of its own: the
// flagship's last stage makes 308 items, 2.3 rounds of 132 SMs, where 154
// items of both passes took two rounds, the second a sixth full.
// setmaxnreg gives each consumer thread 232 registers (160 with three
// warpgroups); ptxas still reports spills of some hundred bytes in the
// train variants and at C = 768. The train
// variant stages each rounded h_pre chunk in a swizzled tile and stores it
// by TMA (one thread of the row group, after the barrier that completes
// the tile); t leaves from the LayerNorm's 16-byte rows, m from the
// epilogue. No wgmma group stays in flight across a loop's back edge
// (ptxas serialises the loop's products if one does): the loops over a
// chunk's tiles are unrolled and each chunk drains its groups.
#include <type_traits>

#include "convnext_mlp_common.cuh"
#include "hopper.cuh"

namespace {

using namespace vcd;

// Row groups of 64 rows per block (RG), warpgroups sharing a row group's
// output columns (CG), passes over the hidden dimension that each produce
// a share of those columns (PASSES), weight tiles in the ring (SLOTS).
template <int C>
struct Cfg;
#define VCD_K3W_CFG(C_, RG_, CG_, PASSES_, SLOTS_)                     \
  template <>                                                          \
  struct Cfg<C_> {                                                     \
    static constexpr int RG = RG_, CG = CG_, PASSES = PASSES_,         \
                         SLOTS = SLOTS_;                               \
  };
VCD_K3W_CFG(96, 2, 1, 1, 8)
VCD_K3W_CFG(128, 2, 1, 1, 10)
VCD_K3W_CFG(192, 2, 1, 1, 10)
VCD_K3W_CFG(256, 2, 1, 1, 10)
VCD_K3W_CFG(384, 1, 2, 1, 12)
VCD_K3W_CFG(512, 1, 2, 1, 12)
VCD_K3W_CFG(768, 1, 2, 2, 10)
#undef VCD_K3W_CFG

template <int C>
struct Plan {
  static constexpr int RG = Cfg<C>::RG, CG = Cfg<C>::CG;
  static constexpr int PASSES = Cfg<C>::PASSES, SLOTS = Cfg<C>::SLOTS;
  static constexpr int WG = RG * CG;  // consumer warpgroups
  static constexpr int BM = 64 * RG;  // rows per item
  static constexpr int KT = (C + 63) / 64;  // 64-column tiles of C
  static constexpr int NTW = KT / CG;       // output tiles per warpgroup
  static constexpr int NTP = NTW / PASSES;  // of them in one pass
  static constexpr int N1 = 64 / CG;        // chunk columns per warpgroup
  static constexpr int CHUNKS = 4 * C / 64;
  // wgmma groups left in flight behind the newest one, in the first
  // product (a group a W1 tile) and the second (a group an output tile)
  static constexpr int D1 = KT - 1 < 3 ? KT - 1 : 3;
  static constexpr int D2 = NTP - 1 < 3 ? NTP - 1 : 3;
  // shared memory, byte offsets from the 1024-aligned base
  static constexpr int T = 0;  // [KT][BM rows] of 128 bytes
  static constexpr int H = T + KT * BM * 128;  // [2][RG] h tiles, CG > 1
  // [2][RG] staged h_pre tiles of the train variant
  static constexpr int HP = H + (CG > 1 ? 2 * RG * TILE_BYTES : 0);
  static constexpr int RING = HP + 2 * RG * TILE_BYTES;
  static constexpr int BARS = RING + SLOTS * TILE_BYTES;
  static constexpr int FULL = BARS, EMPTY = FULL + 8 * SLOTS,
                       T_FULL = EMPTY + 8 * SLOTS, T_FREE = T_FULL + 8;
  static constexpr int DYNAMIC = T_FREE + 8 + 1024;
  static constexpr int THREADS = (WG + 1) * 128;
  static constexpr int CONSUMER_REGS = WG == 2 ? 232 : 160;
  static constexpr int PRODUCER_REGS = WG == 2 ? 40 : 32;
  static_assert(WG == 2 || WG == 3, "two or three consumer warpgroups");
  static_assert(KT % CG == 0 && NTW % PASSES == 0 && C % 32 == 0,
                "widths");
  static_assert(DYNAMIC <= 232448, "shared memory of one block");
};

// The tensors of the train variant (null in the eval variant).
struct Saved {
  bf16* t;      // [M, C]
  bf16* h_pre;  // [M, 4C]
  bf16* m;      // [M, C]
};

// The producer warp's lane 0: per item the rows of y into the t tiles once
// the consumers have freed them, then every chunk's weight tiles through
// the ring, running ahead across items.
template <int C>
__device__ __forceinline__ void produce(const CUtensorMap* map_y,
                                        const CUtensorMap* map_w1,
                                        const CUtensorMap* map_w2,
                                        unsigned base, int items) {
  using P = Plan<C>;
  int g = 0;  // weight tiles started so far, over all items
  auto load = [&](const CUtensorMap* map, int c0, int c1) {
    const int slot = g % P::SLOTS;
    mbar_wait(base + P::EMPTY + 8 * slot, ((g / P::SLOTS) & 1) ^ 1);
    const unsigned full = base + P::FULL + 8 * slot;
    mbar_arrive_expect(full, TILE_BYTES);
    tma_load_2d(base + P::RING + slot * TILE_BYTES, map, full, c0, c1);
    ++g;
  };
  for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n) {
    const int rows = w / P::PASSES * P::BM, ps = w % P::PASSES;
    mbar_wait(base + P::T_FREE, (n & 1) ^ 1);
    mbar_arrive_expect(base + P::T_FULL, P::KT * P::RG * TILE_BYTES);
    for (int kt = 0; kt < P::KT; ++kt)
      for (int rg = 0; rg < P::RG; ++rg)
        tma_load_2d(base + P::T + kt * P::BM * 128 + rg * TILE_BYTES, map_y,
                    base + P::T_FULL, kt * 64, rows + rg * 64);
    // per chunk its W1 tiles, then the output tiles of this pass,
    // warpgroup by warpgroup
    for (int j = 0; j < P::CHUNKS; ++j) {
      for (int kt = 0; kt < P::KT; ++kt) load(map_w1, kt * 64, j * 64);
      for (int cg = 0; cg < P::CG; ++cg)
        for (int i = 0; i < P::NTP; ++i)
          load(map_w2, j * 64, (cg * P::NTW + ps * P::NTP + i) * 64);
    }
  }
}

// What a consumer warp needs of the ring; g counts the block's weight
// tiles over all of its items. A slot is free again once every consumer
// warp has handed it back.
template <int C>
struct Ring {
  using P = Plan<C>;
  unsigned base;
  __device__ __forceinline__ unsigned tile(int g) const {
    return base + P::RING + (g % P::SLOTS) * TILE_BYTES;
  }
  __device__ __forceinline__ void wait_full(int g) const {
    mbar_wait(base + P::FULL + 8 * (g % P::SLOTS), (g / P::SLOTS) & 1);
    __syncwarp();
  }
  __device__ __forceinline__ void release(int g) const {
    __syncwarp();
    if (threadIdx.x % 32 == 0)
      mbar_arrive(base + P::EMPTY + 8 * (g % P::SLOTS));
  }
};

// Eight bf16 values of 16 bytes as float32, and back.
__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 v = __bfloat1622float2(b[k]);
    f[2 * k] = v.x;
    f[2 * k + 1] = v.y;
  }
}
__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                    pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
}

// LayerNorm of the item's BM rows in place in the t tiles, once they have
// landed (t_full, parity), 16 bytes (8 columns) a lane at a time: a row
// takes LPR lanes (16 where C <= 128, so that a warp works on two rows at
// once), and each consumer warp takes NR rows per group of lanes at once,
// so that their sums overlap. A lane's columns are the same in every row:
// it reads their LayerNorm weights before it waits for the rows. The train
// variant writes each normalised row to t_out too.
template <int C, bool TRAIN>
__device__ __forceinline__ void layer_norm(unsigned char* t, unsigned t_full,
                                           unsigned parity,
                                           const float* __restrict__ ln_w,
                                           const float* __restrict__ ln_b,
                                           bf16* __restrict__ t_out,
                                           int64_t row0, int M) {
  using P = Plan<C>;
  constexpr int VECS = C / 8, LPR = VECS <= 16 ? 16 : 32;
  constexpr int PER_LANE = (VECS + LPR - 1) / LPR;
  constexpr int NR = PER_LANE == 1 ? 8 : 4, RPI = 32 / LPR;
  static_assert(P::BM % (4 * P::WG * NR * RPI) == 0, "rows per warp");
  const int lane = threadIdx.x % LPR, sub = threadIdx.x % 32 / LPR;
  // the sum over the lanes of a row
  auto row_sum = [](float v) {
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
  };
  auto at = [&](int r, int vi) {
    return reinterpret_cast<uint4*>(t + (vi / 8) * P::BM * 128 +
                                    sw128_chunk(r, vi % 8));
  };
  float w[PER_LANE][8], b[PER_LANE][8];
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const int vi = lane + LPR * i;
    if (vi >= VECS) continue;
    const float4* w4 = reinterpret_cast<const float4*>(ln_w + vi * 8);
    const float4* b4 = reinterpret_cast<const float4*>(ln_b + vi * 8);
    const float4 wa = w4[0], wb = w4[1], ba = b4[0], bb = b4[1];
    const float wf[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
    const float bf[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      w[i][e] = wf[e];
      b[i][e] = bf[e];
    }
  }
  mbar_wait(t_full, parity);
  for (int r0 = threadIdx.x / 32 * NR * RPI + sub; r0 < P::BM;
       r0 += 4 * P::WG * NR * RPI) {
    // this lane's rows r0, r0 + RPI, ...
    auto row = [&](int k) { return r0 + k * RPI; };
    float v[NR][PER_LANE][8], mu[NR], rstd[NR];
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        const int vi = lane + LPR * i;
        if (vi < VECS) {
          unpack8(*at(row(k), vi), v[k][i]);
#pragma unroll
          for (int e = 0; e < 8; ++e) s += v[k][i][e];
        }
      }
      mu[k] = s;
    }
#pragma unroll
    for (int k = 0; k < NR; ++k) mu[k] = row_sum(mu[k]) / C;
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i)
        if (lane + LPR * i < VECS)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            q += (v[k][i][e] - mu[k]) * (v[k][i][e] - mu[k]);
      rstd[k] = q;
    }
#pragma unroll
    for (int k = 0; k < NR; ++k)
      rstd[k] = rsqrtf(row_sum(rstd[k]) / C + LN_EPS);
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int vi = lane + LPR * i;
      if (vi >= VECS) continue;
#pragma unroll
      for (int k = 0; k < NR; ++k) {
        float o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          o[e] = (v[k][i][e] - mu[k]) * rstd[k] * w[i][e] + b[i][e];
        const uint4 u = pack8(o);
        *at(row(k), vi) = u;
        if (TRAIN && t_out != nullptr && row0 + row(k) < M)
          *reinterpret_cast<uint4*>(t_out + (row0 + row(k)) * C + vi * 8) = u;
      }
    }
  }
}

__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t a,
                                         uint64_t b, int accumulate) {
  wgmma_ss64(d, a, b, accumulate);
}
__device__ __forceinline__ void wgmma_ss(float (&d)[4][4], uint64_t a,
                                         uint64_t b, int accumulate) {
  wgmma_ss32(d, a, b, accumulate);
}

template <int C, bool TRAIN>
__global__ void __launch_bounds__(Plan<C>::THREADS, 1)
convnext_mlp_wgmma_kernel(const __grid_constant__ CUtensorMap map_y,
                          const __grid_constant__ CUtensorMap map_w1,
                          const __grid_constant__ CUtensorMap map_w2,
                          const __grid_constant__ CUtensorMap map_hp,
                          const bf16* __restrict__ x,
                          const float* __restrict__ ln_w,
                          const float* __restrict__ ln_b,
                          const float* __restrict__ b1,
                          const float* __restrict__ b2,
                          const float* __restrict__ gamma,
                          bf16* __restrict__ out, Saved saved, int M,
                          int items, int approximate) {
  using P = Plan<C>;
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = smem_u32(smem_raw);
  const unsigned base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::SLOTS; ++s) {
      mbar_init(base + P::FULL + 8 * s, 1);
      mbar_init(base + P::EMPTY + 8 * s, 4 * P::WG);  // a lane a consumer warp
    }
    mbar_init(base + P::T_FULL, 1);
    mbar_init(base + P::T_FREE, 4 * P::WG);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * P::WG) {
    setmaxnreg_dec<P::PRODUCER_REGS>();
    if (threadIdx.x == 4 * P::WG * 32)
      produce<C>(&map_y, &map_w1, &map_w2, base, items);
  } else {
    setmaxnreg_inc<P::CONSUMER_REGS>();
    const int wg = warp / 4, rg = wg / P::CG, cg = wg % P::CG;
    const int lane = threadIdx.x % 32, tg = lane % 4;
    // this warp's rows g and g + 8 of its row group's 64
    const int r = (warp % 4) * 16 + lane / 4;
    // the thread that stores the row group's staged h_pre tiles
    const bool hp_leader = threadIdx.x == rg * P::CG * 128;
    const Ring<C> ring{base};
    // this warpgroup's rows of the first t tile
    const uint64_t t_desc = sw128_desc(base + P::T + rg * TILE_BYTES);
    int g = 0;      // weight tiles taken so far, over all items
    int chunk = 0;  // chunks done so far, over all items (buffer parity)
    for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n) {
      // an item is one pass over one block of rows; its first pass writes
      // the train variant's t and h_pre
      const int64_t row0 = (int64_t)(w / P::PASSES) * P::BM;
      const int ps = w % P::PASSES;
      const int64_t rw = row0 + rg * 64 + r;  // this lane's rows rw, rw + 8
      layer_norm<C, TRAIN>(smem + P::T, base + P::T_FULL, n & 1, ln_w, ln_b,
                           ps == 0 ? saved.t : nullptr, row0, M);
      fence_proxy_async();
      // (the last item's stores have read their tiles: a pass that stores
      // none runs no barrier that would say so)
      if (TRAIN && hp_leader) tma_store_wait_read();
      named_barrier(1, 128 * P::WG);

      {
        float acc[P::NTP][8][4];
#pragma unroll
        for (int i = 0; i < P::NTP; ++i)
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.f;

        for (int j = 0; j < P::CHUNKS; ++j, ++chunk) {
          // this chunk's b1 at this lane's columns, read while the
          // products run
          const int c0 = cg * P::N1 + 2 * tg;  // column in the chunk
          float2 bias[P::N1 / 8];
#pragma unroll
          for (int nt = 0; nt < P::N1 / 8; ++nt)
            bias[nt] =
                *reinterpret_cast<const float2*>(b1 + j * 64 + c0 + nt * 8);

          // 1. h_pre = t @ W1_chunk^T from the W1 tiles g on: this
          // warpgroup's N1 chunk columns are rows cg * N1 on of each tile;
          // a wgmma group a tile, each tile handed back once its products
          // are done
          float h[P::N1 / 8][4];
#pragma unroll
          for (int kt = 0; kt < P::KT; ++kt) {
            ring.wait_full(g + kt);
            // descriptors step in 16-byte units: one base for all t tiles
            const uint64_t a = t_desc + kt * (P::BM * 128 >> 4);
            const uint64_t b = sw128_desc(ring.tile(g + kt) + cg * P::N1 * 128);
            constexpr int LAST_STEPS = (C - (P::KT - 1) * 64) / 16;
            wgmma_fence();
#pragma unroll
            for (int s = 0; s < (kt + 1 < P::KT ? 4 : LAST_STEPS); ++s)
              wgmma_ss(h, a + 2 * s, b + 2 * s, kt > 0 || s > 0);
            wgmma_commit();
            if (kt >= P::D1) {
              wgmma_wait<P::D1>();
              ring.release(g + kt - P::D1);
            }
          }
          wgmma_wait<0>();
          acc_fence(h);
#pragma unroll
          for (int kt = P::KT - P::D1; kt < P::KT; ++kt) ring.release(g + kt);
          g += P::KT;
          // t is read: the producer may load the next item's rows
          if (j + 1 == P::CHUNKS) {
            __syncwarp();
            if (lane == 0) mbar_arrive(base + P::T_FREE);
          }

          // 2. + b1, bf16 (h_pre, which the train variant stages for a TMA
          // store in its first pass), GELU in float32, rounded to bf16
          // where it is packed: into A fragments f, or, with CG > 1, into
          // the row group's h tile of this chunk
          const bool store_hp = TRAIN && ps == 0;
          unsigned char* hp_tile =
              smem + P::HP + ((chunk & 1) * P::RG + rg) * TILE_BYTES;
          unsigned char* h_tile =
              smem + P::H + ((chunk & 1) * P::RG + rg) * TILE_BYTES;
          // (the GELU form is chosen once a chunk, not per element)
          auto activate = [&](auto approx) {
            constexpr bool APPROX = decltype(approx)::value;
#pragma unroll
            for (int nt = 0; nt < P::N1 / 8; ++nt) {
              const int col = c0 + nt * 8;
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const __nv_bfloat162 hp =
                    __floats2bfloat162_rn(h[nt][2 * half] + bias[nt].x,
                                          h[nt][2 * half + 1] + bias[nt].y);
                const int at =
                    sw128_chunk(r + 8 * half, col / 8) + (col % 8) * 2;
                if (store_hp)
                  *reinterpret_cast<__nv_bfloat162*>(hp_tile + at) = hp;
                const float2 hf = __bfloat1622float2(hp);
                h[nt][2 * half] = gelu<APPROX>(hf.x);
                h[nt][2 * half + 1] = gelu<APPROX>(hf.y);
                if constexpr (P::CG > 1)
                  *reinterpret_cast<unsigned*>(h_tile + at) =
                      pack_bf16(h[nt][2 * half], h[nt][2 * half + 1]);
              }
            }
          };
          if (approximate)
            activate(std::true_type());
          else
            activate(std::false_type());
          unsigned f[4][4];
          if constexpr (P::CG == 1) acc_to_a(h, f);
          if (P::CG > 1 || store_hp) {
            fence_proxy_async();
            // the store from this staging tile two chunks ago has read it
            // (the leader waits before the barrier that lets the others
            // write)
            if (store_hp && hp_leader) tma_store_wait_read();
            named_barrier(2 + rg, 128 * P::CG);
            if (store_hp && hp_leader)
              tma_store_2d(&map_hp, smem_u32(hp_tile), j * 64,
                           row0 + rg * 64);
          }

          // 3. out_acc += h @ W2_chunk^T over this warpgroup's output tiles
          // of the pass among the W2 tiles g on (the tiles of the other
          // warpgroups of the row group are only handed back)
          for (int q = 0; q < cg * P::NTP; ++q) {
            ring.wait_full(g + q);
            ring.release(g + q);
          }
          const int mine = g + cg * P::NTP;
          const uint64_t ha = sw128_desc(smem_u32(h_tile));
#pragma unroll
          for (int i = 0; i < P::NTP; ++i) {
            ring.wait_full(mine + i);
            const uint64_t b = sw128_desc(ring.tile(mine + i));
            wgmma_fence();
            if constexpr (P::CG == 1) {
              wgmma_tile_abt(acc[i], f, b, 1);
            } else {
#pragma unroll
              for (int s = 0; s < 4; ++s)
                wgmma_ss64(acc[i], ha + 2 * s, b + 2 * s, 1);
            }
            wgmma_commit();
            if (i >= P::D2) {
              wgmma_wait<P::D2>();
              ring.release(mine + i - P::D2);
            }
          }
          wgmma_wait<0>();
#pragma unroll
          for (int i = 0; i < P::NTP; ++i) acc_fence(acc[i]);
#pragma unroll
          for (int i = P::NTP - P::D2; i < P::NTP; ++i) ring.release(mine + i);
          for (int q = (cg + 1) * P::NTP; q < P::CG * P::NTP; ++q) {
            ring.wait_full(g + q);
            ring.release(g + q);
          }
          g += P::CG * P::NTP;
        }

        // out = x + gamma * m, m = out_acc + b2 (the train variant also
        // writes m in bf16) for this pass's columns; columns past C (C =
        // 96's padded tile) are left out
#pragma unroll
        for (int i = 0; i < P::NTP; ++i)
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int c =
                (cg * P::NTW + ps * P::NTP + i) * 64 + nt * 8 + 2 * tg;
            if (C % 64 != 0 && c >= C) continue;
            const float2 bb = *reinterpret_cast<const float2*>(b2 + c);
            const float2 gg = *reinterpret_cast<const float2*>(gamma + c);
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int64_t row = rw + 8 * half;
              if (row >= M) continue;
              const float m0 = acc[i][nt][2 * half] + bb.x;
              const float m1 = acc[i][nt][2 * half + 1] + bb.y;
              if (TRAIN)
                *reinterpret_cast<__nv_bfloat162*>(saved.m + row * C + c) =
                    __floats2bfloat162_rn(m0, m1);
              const float2 xv = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(x + row * C + c));
              *reinterpret_cast<__nv_bfloat162*>(out + row * C + c) =
                  __floats2bfloat162_rn(xv.x + gg.x * m0, xv.y + gg.y * m1);
            }
          }
      }
    }
    // the staged tiles stay in shared memory until their stores are done
    if (TRAIN && hp_leader) tma_store_wait();
  }
}

template <int C, bool TRAIN>
int launch(const void* x, const void* y, const void* ln_w, const void* ln_b,
           const void* w1, const void* b1, const void* w2, const void* b2,
           const void* gamma, void* out, Saved saved, int M, int approximate,
           cudaStream_t stream) {
  using P = Plan<C>;
  if (M == 0) return (int)cudaSuccess;
  CUtensorMap my, mw1, mw2;
  const cuuint32_t box[2] = {64, 64};
  const cuuint64_t dy[2] = {C, (cuuint64_t)M}, sy[1] = {C * 2};
  const cuuint64_t dw1[2] = {C, 4 * C}, sw1[1] = {C * 2};
  const cuuint64_t dw2[2] = {4 * C, C}, sw2[1] = {4 * C * 2};
  cudaError_t err;
  if ((err = make_bf16_map(&my, y, 2, dy, sy, box)) != cudaSuccess ||
      (err = make_bf16_map(&mw1, w1, 2, dw1, sw1, box)) != cudaSuccess ||
      (err = make_bf16_map(&mw2, w2, 2, dw2, sw2, box)) != cudaSuccess)
    return (int)err;
  // the train variant's h_pre [M, 4C], stored a 64 x 64 tile at a time (the
  // eval variant gets the y map, unused)
  CUtensorMap mhp = my;
  const cuuint64_t dhp[2] = {4 * C, (cuuint64_t)M}, shp[1] = {4 * C * 2};
  if (TRAIN &&
      (err = make_bf16_map(&mhp, saved.h_pre, 2, dhp, shp, box)) != cudaSuccess)
    return (int)err;
  auto kernel = convnext_mlp_wgmma_kernel<C, TRAIN>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::DYNAMIC);
  if (err != cudaSuccess) return (int)err;
  int device, sms;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return (int)err;
  // a persistent grid: one block per SM, fewer where there is less work
  const int items = (M + P::BM - 1) / P::BM * P::PASSES;
  kernel<<<items < sms ? items : sms, P::THREADS, P::DYNAMIC, stream>>>(
      my, mw1, mw2, mhp, (const bf16*)x, (const float*)ln_w, (const float*)ln_b,
      (const float*)b1, (const float*)b2, (const float*)gamma, (bf16*)out,
      saved, M, items, approximate);
  return (int)cudaGetLastError();
}

template <bool TRAIN>
int dispatch(const void* x, const void* y, const void* ln_w, const void* ln_b,
             const void* w1, const void* b1, const void* w2, const void* b2,
             const void* gamma, void* out, Saved saved, int M, int C,
             int approximate, cudaStream_t stream) {
#define VCD_K3W_CASE(C_)                                                     \
  case C_:                                                                   \
    return launch<C_, TRAIN>(x, y, ln_w, ln_b, w1, b1, w2, b2, gamma, out,   \
                             saved, M, approximate, stream);
  switch (C) {
    VCD_K3W_CASE(96)
    VCD_K3W_CASE(128)
    VCD_K3W_CASE(192)
    VCD_K3W_CASE(256)
    VCD_K3W_CASE(384)
    VCD_K3W_CASE(512)
    VCD_K3W_CASE(768)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef VCD_K3W_CASE
}

}  // namespace

// x, y, out: bf16 [M, C], contiguous, 16-byte aligned. ln_w, ln_b, b2,
// gamma: float32 [C]; b1: float32 [4C]; w1: bf16 [4C, C] and w2: bf16
// [C, 4C], nn.Linear's layout, contiguous and 16-byte aligned. t, h_pre, m:
// the train variant's bf16 [M, C], [M, 4C], [M, C] (all null for the eval
// variant). C is one of 96, 128, 192, 256, 384, 512, 768.
extern "C" int vcd_convnext_mlp_wgmma(
    const void* x, const void* y, const void* ln_w, const void* ln_b,
    const void* w1, const void* b1, const void* w2, const void* b2,
    const void* gamma, void* out, void* t, void* h_pre, void* m, int M, int C,
    int approximate, void* stream) {
  if (M < 0) return (int)cudaErrorInvalidValue;
  const Saved saved{(bf16*)t, (bf16*)h_pre, (bf16*)m};
  if (t != nullptr)
    return dispatch<true>(x, y, ln_w, ln_b, w1, b1, w2, b2, gamma, out, saved,
                          M, C, approximate, (cudaStream_t)stream);
  return dispatch<false>(x, y, ln_w, ln_b, w1, b1, w2, b2, gamma, out, saved,
                         M, C, approximate, (cudaStream_t)stream);
}
