// K2 on Hopper: depthwise 7x7 convolution, stride 1, SAME (3-pixel zero
// halo), + bias, NHWC, bf16 or float32 in and out (x, w, b, out of one
// dtype), float32 accumulation. Forward, and dx as the same kernel on
// flipped taps with a zero bias.
//
// Replaces the TPU kernel vision_collision_detection_tpu/ops/dwconv_pallas.py
// `dwconv7x7` -> `_run_fwd` (`_fwd_kernel`) for C a multiple of 32 (every
// ConvNeXt width); other widths keep dwconv.cu.
//
// Bound on the H100. bf16: operations on the CUDA cores. Each output takes
// 49 float32 FMAs (98 flops) against 4 bytes moved (bf16 in and out), so
// at 67 TFLOP/s the taps take longer than the bytes at 3.35 TB/s. float32:
// bytes (8 a pixel-channel against the same 98 flops). The tensor cores do
// not serve a depthwise 7x7: there is no sum over channels, so a matrix
// form needs a banded (Toeplitz) operand per channel, mostly zeros,
// gathered across the NHWC layout; the work the FMAs must do is already
// the bound. No wgmma, no tensor-core operand, no clusters here.
//
// Design (the CUDA-core stencil):
// - A block owns one 32-channel slab for its whole life (the slab's 49
//   taps sit in registers as float32 pairs, the bias after them) and walks
//   work items of that slab: a persistent grid of about one wave, each slab
//   served by the same number of blocks.
// - A work item is a band of RB output rows across the whole frame width
//   (W <= 64; wider frames take 56- or 64-column tiles with a masked edge),
//   or F whole frames where H <= 16 and a frame fits in shared memory (four
//   frames at 7x7). The band's size
//   is chosen so that its output groups fill the block's thread slots (see
//   `pick`), so no item is mostly halo or idle threads on the main path.
// - Loads: the next item's band plus its 3-pixel halo is copied from global
//   memory by 16-byte cp.async (out-of-frame pixels zero-filled by the
//   copy's source size) while the current item's FMAs run. bf16 lands in a
//   staging buffer and, after a barrier, one pass converts it to float32 in
//   the shared tile, so the inner loop does no conversions. float32 needs
//   no conversion: it lands in the other of two float32 tiles, which
//   alternate (one barrier an item), so a pixel takes 256 bytes of shared
//   memory against bf16's 192 and bands are planned smaller.
// - Compute: a thread owns one channel pair and an output group of 2 rows x
//   CC columns (CC = 7 where W divides by 7, else 8): 2*CC float2
//   accumulators. It walks the group's 8 input rows once, each row's CC+6
//   pixels loaded into registers while the row before feeds the FMAs, and
//   applies every tap a pixel carries to both output rows: 13-14 FMAs per
//   shared-memory load. Taps are
//   summed in (dy, dx) order from 0 for each output, then the bias is
//   added, and the result is rounded to the output dtype once (stored as a
//   channel pair, 4 or 8 bytes), as in the TPU kernel. That is dwconv.cu's
//   order too, so on float32 the two kernels agree bit for bit.
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int K = 7;
constexpr int PAD = 3;
constexpr int SLAB = 32;            // channels per block
constexpr int PAIRS = SLAB / 2;     // threads of an output group
constexpr int R = 2;                // output rows of a group
constexpr int SMEM_MAX = 232448;    // dynamic shared memory a block may use

// Shared bytes a pixel of an item's tile takes: bf16, the float32 tile and
// its bf16 staging; float32, two float32 tiles.
template <typename T>
constexpr int PX_BYTES = std::is_same_v<T, bf16> ? SLAB * 4 + SLAB * 2
                                                 : 2 * SLAB * 4;

struct Geo {
  int N, H, W, C;
  int F, RB, TW;        // an item: frames, output rows, output columns
  int TH, TWH;          // its tile with the halo: rows, columns
  int rgroups, cgroups; // output groups of a frame: rows / R, columns / CC
  int groups;           // F * rgroups * cgroups
  int nct, nbands;      // column tiles, bands of a frame
  int items;            // items of one slab
  int bps;              // blocks serving one slab
};

__device__ __forceinline__ void cp_async16_zfill(unsigned dst,
                                                 const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// staging (bf16) -> tile (float32), 4 channels a step, four steps in flight
// a thread
__device__ __forceinline__ void convert_tile(unsigned char* smem, int tile_px,
                                             int tid, int nt) {
  const uint2* s2 =
      reinterpret_cast<const uint2*>(smem + (size_t)tile_px * SLAB * 4);
  float4* f4 = reinterpret_cast<float4*>(smem);
  const int units = tile_px * (SLAB / 4);
  for (int u0 = tid; u0 < units; u0 += 4 * nt) {
    uint2 v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (u0 + k * nt < units) v[k] = s2[u0 + k * nt];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (u0 + k * nt < units)
        f4[u0 + k * nt] = make_float4(__uint_as_float(v[k].x << 16),
                                      __uint_as_float(v[k].x & 0xffff0000u),
                                      __uint_as_float(v[k].y << 16),
                                      __uint_as_float(v[k].y & 0xffff0000u));
  }
}

// item -> (first frame, first row, first column)
__device__ __forceinline__ void item_origin(const Geo& g, int item, int& n0,
                                            int& h0, int& w0) {
  const int ct = item % g.nct;
  const int rest = item / g.nct;
  w0 = ct * g.TW;
  h0 = (rest % g.nbands) * g.RB;
  n0 = (rest / g.nbands) * g.F;
}

// the item's tile, halo included, in x's dtype to shared address st_addr
// (bf16: the staging buffer; float32: a float32 tile); a row of the tile a
// warp at a time, 16 bytes (8 or 4 channels) a lane
template <typename T>
__device__ __forceinline__ void issue_tile(const Geo& g, const T* x,
                                           unsigned st_addr, int c0, int item,
                                           int warp, int lane, int nwarps) {
  constexpr int PER16 = 16 / sizeof(T);  // channels a 16-byte copy
  constexpr int CHUNKS = SLAB / PER16;   // copies a pixel
  int n0, h0, w0;
  item_origin(g, item, n0, h0, w0);
  for (int row = warp; row < g.F * g.TH; row += nwarps) {
    const int f = row / g.TH;
    const int n = n0 + f, gy = h0 - PAD + (row - f * g.TH);
    const bool rv = n < g.N && gy >= 0 && gy < g.H;
    const T* src_row =
        x + ((size_t)(rv ? n : 0) * g.H + (rv ? gy : 0)) * g.W * g.C + c0;
    const unsigned dst_row =
        st_addr + (unsigned)(row * g.TWH) * (SLAB * sizeof(T));
    for (int c = lane; c < g.TWH * CHUNKS; c += 32) {
      const int gx = w0 - PAD + c / CHUNKS;
      const bool v = rv && gx >= 0 && gx < g.W;
      cp_async16_zfill(dst_row + c * 16,
                       v ? src_row + (size_t)gx * g.C + (c % CHUNKS) * PER16
                         : x,
                       v);
    }
  }
  cp_async_commit();
}

template <typename T, int CC, int SLOTS>
__global__ void __launch_bounds__(SLOTS * PAIRS, 1)
dwconv7x7_hopper_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const T* __restrict__ bias, T* __restrict__ out,
                        const Geo g) {
  constexpr int NT = SLOTS * PAIRS;
  constexpr int NWARPS = NT / 32;
  constexpr int WIN = CC + K - 1;  // input columns of a group's row
  constexpr bool STAGED = std::is_same_v<T, bf16>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile_px = g.F * g.TH * g.TWH;
  const size_t tile_bytes = (size_t)tile_px * SLAB * 4;  // a float32 tile
  // bf16: the staging buffer after the tile; float32: the second tile
  const unsigned st_addr =
      (unsigned)__cvta_generic_to_shared(smem + tile_bytes);

  const int nslab = g.C / SLAB;
  const int c0 = (blockIdx.x % nslab) * SLAB;
  const int first = blockIdx.x / nslab;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int p = tid % PAIRS, slot = tid / PAIRS;

  float2 wr[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t)
    wr[t] = vcd::Pair<T>::load(w + (size_t)t * g.C + c0 + 2 * p);
  const float2 bv = vcd::Pair<T>::load(bias + c0 + 2 * p);

  int item = first;
  if (item >= g.items) return;
  const unsigned smem_addr = (unsigned)__cvta_generic_to_shared(smem);
  // float32 lands in tile `cur` (0: at smem, 1: at st_addr)
  int cur = 0;
  issue_tile(g, x, STAGED ? st_addr : smem_addr, c0, item, warp, lane,
             NWARPS);
  const int row_stride = g.TWH * PAIRS;  // float2s per tile row
  for (;;) {
    cp_async_wait_all();
    __syncthreads();  // the copies have landed; the last item's FMAs are done
    const int next = item + g.bps;
    if constexpr (STAGED) {
      convert_tile(smem, tile_px, tid, NT);
      __syncthreads();  // the tile is float32; the staging buffer is free
      if (next < g.items)  // in flight under this item's FMAs
        issue_tile(g, x, st_addr, c0, next, warp, lane, NWARPS);
    } else if (next < g.items) {
      // into the other tile, which the last item's FMAs have done reading
      issue_tile(g, x, cur ? smem_addr : st_addr, c0, next, warp, lane,
                 NWARPS);
    }
    const float2* tile2 =
        reinterpret_cast<const float2*>(smem + (cur ? tile_bytes : 0));
    int n0, h0, w0;
    item_origin(g, item, n0, h0, w0);
    for (int grp = slot; grp < g.groups; grp += SLOTS) {
      const int cg = grp % g.cgroups;
      const int rest = grp / g.cgroups;
      const int r0 = (rest % g.rgroups) * R;
      const int f = rest / g.rgroups;
      const int col0 = cg * CC;
      const float2* base =
          tile2 + ((size_t)(f * g.TH + r0) * g.TWH + col0) * PAIRS + p;
      float2 acc[R][CC];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < CC; ++j) acc[r][j] = make_float2(0.f, 0.f);
      // Input row iy feeds output row r through kernel row dy = iy - r, and
      // input column jj feeds output column j through tap dx = jj - j; for
      // each output the rows come in dy order and the taps of a row in dx
      // order. The next row's pixels are loaded into registers before this
      // row's FMAs, so the loads' latency hides under them.
      float2 nxt[WIN];
#pragma unroll
      for (int jj = 0; jj < WIN; ++jj) nxt[jj] = base[jj * PAIRS];
#pragma unroll
      for (int iy = 0; iy < R + K - 1; ++iy) {
        float2 cur[WIN];
#pragma unroll
        for (int jj = 0; jj < WIN; ++jj) cur[jj] = nxt[jj];
        if (iy + 1 < R + K - 1) {
          const float2* rowp = base + (iy + 1) * row_stride;
#pragma unroll
          for (int jj = 0; jj < WIN; ++jj) nxt[jj] = rowp[jj * PAIRS];
        }
#pragma unroll
        for (int jj = 0; jj < WIN; ++jj) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int dy = iy - r;
            if (dy < 0 || dy >= K) continue;
#pragma unroll
            for (int dx = 0; dx < K; ++dx) {
              const int j = jj - dx;
              if (j < 0 || j >= CC) continue;
              const float2 wv = wr[dy * K + dx];
              acc[r][j].x = fmaf(cur[jj].x, wv.x, acc[r][j].x);
              acc[r][j].y = fmaf(cur[jj].y, wv.y, acc[r][j].y);
            }
          }
        }
        // keep the loads of the row after next from being hoisted over
        // this row's FMAs, where they would hold registers the taps need
        asm volatile("" ::: "memory");
      }
      const int n = n0 + f;
      if (n >= g.N) continue;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int gy = h0 + r0 + r;
        if (r0 + r >= g.RB || gy >= g.H) continue;
        T* orow = out + ((size_t)n * g.H + gy) * g.W * g.C + c0 + 2 * p;
#pragma unroll
        for (int j = 0; j < CC; ++j) {
          const int gx = w0 + col0 + j;
          if (col0 + j < g.TW && gx < g.W)
            vcd::Pair<T>::store(
                orow + (size_t)gx * g.C,
                make_float2(acc[r][j].x + bv.x, acc[r][j].y + bv.y));
        }
      }
    }
    if (next >= g.items) break;
    item = next;
    if constexpr (!STAGED) cur ^= 1;
  }
}

// Share of the threads' slot-rounds that compute a real output group: G
// groups on `slots` slots take ceil(G / slots) rounds.
double slot_share(int groups, int slots) {
  const int rounds = (groups + slots - 1) / slots;
  return (double)groups / (rounds * slots);
}

// The item geometry for a shape, and the kernel variant (CC, SLOTS), for
// tiles of px_bytes shared bytes a pixel.
void pick(int N, int H, int W, int C, int px_bytes, Geo& g, int& cc,
          int& slots) {
  g.N = N;
  g.H = H;
  g.W = W;
  g.C = C;
  cc = W % 7 == 0 ? 7 : 8;
  g.TW = W <= 64 ? W : (64 / cc) * cc;
  g.cgroups = (g.TW + cc - 1) / cc;
  g.TWH = g.cgroups * cc + 2 * PAD;
  g.nct = (W + g.TW - 1) / g.TW;
  double best = -1.0;
  const int frame_rows = (H + R - 1) / R * R + 2 * PAD;
  if (H <= 16 && (size_t)frame_rows * g.TWH * px_bytes <= SMEM_MAX) {
    // whole frames, as many as fill the slots and the shared memory
    g.RB = H;
    g.rgroups = (H + R - 1) / R;
    g.TH = g.rgroups * R + 2 * PAD;
    const int per_frame = g.rgroups * g.cgroups;
    int F = per_frame >= 16 ? 1 : 16 / per_frame;
    if (F > N) F = N > 0 ? N : 1;
    while (F > 1 && (size_t)F * g.TH * g.TWH * px_bytes > SMEM_MAX) --F;
    g.F = F;
    g.groups = F * per_frame;
    for (int s : {16, 14}) {
      const double share = slot_share(g.groups, s);
      if (share > best) best = share, slots = s;
    }
  } else {
    // a band of RB rows: the largest band whose groups fill the slots and
    // whose bands fill the frame, within the shared memory (bands of 6 or 4
    // rows only where none of 8 or more fits: float32 at 64-column tiles)
    g.F = 1;
    g.RB = 4;
    for (int rb : {16, 14, 12, 10, 8, 6, 4}) {
      const int th = rb + 2 * PAD;
      if (rb < 8 && best >= 0.0) break;
      if ((size_t)th * g.TWH * px_bytes > SMEM_MAX) continue;
      const int groups = (rb / R) * g.cgroups;
      const int bands = (H + rb - 1) / rb;
      for (int s : {16, 14}) {
        const double share =
            slot_share(groups, s) * H / (double)(bands * rb);
        if (share > best) {
          best = share;
          slots = s;
          g.RB = rb;
        }
      }
    }
    g.rgroups = g.RB / R;
    g.TH = g.RB + 2 * PAD;
    g.groups = g.rgroups * g.cgroups;
  }
  g.nbands = (H + g.RB - 1) / g.RB;
  g.items = (N + g.F - 1) / g.F * g.nbands * g.nct;
}

template <typename T, int CC, int SLOTS>
int launch(const T* x, const T* w, const T* b, T* out, Geo g,
           cudaStream_t stream, int* grid_out) {
  auto kernel = dwconv7x7_hopper_kernel<T, CC, SLOTS>;
  const size_t smem = (size_t)g.F * g.TH * g.TWH * PX_BYTES<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int device, sms, per_sm;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, SLOTS * PAIRS, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // one wave, the same number of blocks for every slab
  const int nslab = g.C / SLAB;
  int bps = per_sm * sms / nslab;
  if (bps < 1) bps = 1;
  if (bps > g.items) bps = g.items;
  g.bps = bps;
  if (grid_out != nullptr) {
    *grid_out = nslab * bps;
    return 0;
  }
  kernel<<<nslab * bps, SLOTS * PAIRS, smem, stream>>>(x, w, b, out, g);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* w, const void* b, void* out, int n,
             int H, int W, int C, cudaStream_t stream, int* geo_out) {
  if (n < 0 || H < 1 || W < 1 || C < SLAB || C % SLAB)
    return (int)cudaErrorInvalidValue;
  Geo g;
  int cc = 8, slots = 16;
  pick(n, H, W, C, PX_BYTES<T>, g, cc, slots);
  int grid = 0;
  int* grid_out = geo_out != nullptr ? &grid : nullptr;
  if (n > 0 || grid_out != nullptr) {
    const T *xp = (const T*)x, *wp = (const T*)w, *bp = (const T*)b;
    T* op = (T*)out;
    int err;
    if (cc == 7 && slots == 16)
      err = launch<T, 7, 16>(xp, wp, bp, op, g, stream, grid_out);
    else if (cc == 7)
      err = launch<T, 7, 14>(xp, wp, bp, op, g, stream, grid_out);
    else if (slots == 16)
      err = launch<T, 8, 16>(xp, wp, bp, op, g, stream, grid_out);
    else
      err = launch<T, 8, 14>(xp, wp, bp, op, g, stream, grid_out);
    if (err != 0) return err;
  }
  if (geo_out != nullptr) {
    const int vals[10] = {
        cc, slots, g.F, g.RB, g.TW, g.groups, g.items, grid,
        (int)((size_t)g.F * g.TH * g.TWH * PX_BYTES<T>), g.nbands};
    for (int i = 0; i < 10; ++i) geo_out[i] = vals[i];
  }
  return 0;
}

int dispatch(int dtype, const void* x, const void* w, const void* b,
             void* out, int n, int H, int W, int C, cudaStream_t stream,
             int* geo_out) {
  if (dtype == 0)
    return dispatch<bf16>(x, w, b, out, n, H, W, C, stream, geo_out);
  if (dtype == 1)
    return dispatch<float>(x, w, b, out, n, H, W, C, stream, geo_out);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. x/out [n, H, W, C], w [49, C] (tap
// dy*7 + dx major), b [C], all of that dtype and contiguous; x 16-byte
// aligned, w, b and out aligned to a channel pair; C a multiple of 32.
extern "C" int vcd_dwconv7x7_hopper(const void* x, const void* w,
                                    const void* b, void* out, int n, int H,
                                    int W, int C, int dtype, void* stream) {
  return dispatch(dtype, x, w, b, out, n, H, W, C, (cudaStream_t)stream,
                  nullptr);
}

// The launch the kernel would make for a shape and dtype, without
// launching: geo[10] receives CC, thread slots, frames an item, output rows
// an item, output columns an item, output groups an item, items a slab,
// grid, dynamic shared bytes, bands a frame.
extern "C" int vcd_dwconv7x7_hopper_geometry(int n, int H, int W, int C,
                                             int dtype, int* geo) {
  return dispatch(dtype, nullptr, nullptr, nullptr, nullptr, n, H, W, C,
                  nullptr, geo);
}
