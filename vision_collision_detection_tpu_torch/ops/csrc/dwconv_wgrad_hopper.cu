// K2 weight gradient on Hopper: the per-tap reduction of the depthwise 7x7
// convolution's backward,
//   dw[dy*7 + dx, c] = sum over n, h, w of x[n, h+dy-3, w+dx-3, c] * g[n, h, w, c]
// with the halo read as zero, summed in float32, for NHWC x and g of one
// dtype, bf16 or float32, with C a multiple of 32 (every ConvNeXt width);
// other widths keep dwconv_wgrad.cu.
//
// Replaces the TPU kernel vision_collision_detection_tpu/ops/dwconv_pallas.py
// `_run_wgrad` (`_wgrad_kernel`). That kernel added each frame's sums into
// one [49, C] block in grid order, which a TPU may do because its grid runs
// in order. Here blocks run in parallel: each block keeps its own sums, and
// a second kernel adds the blocks' partial sums in a fixed order. No float
// atomics: two runs give the same dw bit for bit.
//
// Bound on the H100. bf16: operations on the CUDA cores, 49 float32 FMAs
// (98 flops) per input element against 4 bytes read (x and g), so at 67
// TFLOP/s the FMAs take longer than the bytes at 3.35 TB/s. float32: the
// bytes double (8 an element) and bound it, 1.6 times the FMAs' time. There
// is no sum over channels, so no operand for the tensor cores to share.
//
// Design (the dual of dwconv_hopper.cu's stencil: where the forward holds a
// slab's 49 taps in registers, this kernel holds its 49 sums):
// - A persistent grid of about one wave: a block owns one 32-channel slab
//   for its life, and the blocks of a slab split its work items evenly.
// - A work item is a band of RB rows of g across the whole frame width (W <=
//   64; wider frames take column tiles), or F whole frames where H <= 16 and
//   a frame fits. Its x band (RB + 6 rows, a 3-pixel halo on every side) and
//   its g band are copied in x's dtype by 16-byte cp.async (out-of-frame
//   pixels zero-filled by the copy's source size) into a two-deep ring in
//   shared memory, so item k+1's copies run under item k's FMAs. No float32
//   tile for bf16: its pairs are converted to float32 in registers as they
//   are read; float32 pairs are read as they are, and no value of x or g is
//   rounded.
// - A float32 pixel of a slab takes 128 bytes, twice a bf16 one, so the
//   same band takes twice the ring: `pick` plans bands as short as 2 rows
//   (4 at 56x56, 8 at 28x28; whole frames still fit at 14x14 and 7x7). The
//   halo rows then grow as (RB + 6) / RB, read again from L2, not from
//   device memory.
// - Compute: a thread owns one channel pair and so 49 float2 sums. For each
//   strip of g it is given (2 rows x CC columns of its pair, held in
//   registers) it streams the 8 x rows those g rows meet, one pixel at a
//   time; each x pair feeds up to 7 taps x 2 g rows, about 12 FMAs per
//   shared-memory load. (The forward's empty asm between rows, which
//   kept ptxas from spilling there, changes nothing here: no spills either
//   way.)
// - End: the threads that share a channel pair add their sums in shared
//   memory in slot order, the block writes partial[block, 49, slab], and
//   wgrad_hopper_sum_parts adds the blocks of a slab in block order.
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int K = 7;
constexpr int PAD = 3;
constexpr int TAPS = K * K;
constexpr int SLAB = 32;            // channels per block
constexpr int PAIRS = SLAB / 2;     // threads of a strip slot
constexpr int R = 2;                // g rows of a strip
constexpr int SMEM_MAX = 232448;    // dynamic shared memory a block may use

struct Geo {
  int N, H, W, C;
  int F, RB, TW;         // an item: frames, g rows, g columns
  int GH, GW;            // its g tile: rows (rgroups * R), columns (cgroups * CC)
  int TH, TWH;           // its x tile, halo included: rows, columns
  int rgroups, cgroups;  // strips of a frame: rows / R, columns / CC
  int groups;            // F * rgroups * cgroups
  int nct, nbands;       // column tiles, bands of a frame
  int items;             // items of one slab
  int bps;               // blocks serving one slab
  int x_bytes, stage_bytes;
};

__device__ __forceinline__ void cp_async16_zfill(unsigned dst,
                                                 const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// every group but the newest has landed
__device__ __forceinline__ void cp_async_wait_older() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// bytes of a staged pixel of a slab, and its 16-byte chunks
template <typename T>
constexpr int PX = SLAB * (int)sizeof(T);
template <typename T>
constexpr int CHUNKS = PX<T> / 16;

// A channel pair as staged: one 32-bit word of two bf16, or a float2.
template <typename T>
using Pair2 = std::conditional_t<std::is_same_v<T, bf16>, uint32_t, float2>;

__device__ __forceinline__ float2 to_float2(uint32_t v) {
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}
__device__ __forceinline__ float2 to_float2(float2 v) { return v; }

// item -> (first frame, first row, first column)
__device__ __forceinline__ void item_origin(const Geo& g, int item, int& n0,
                                            int& h0, int& w0) {
  const int ct = item % g.nct;
  const int rest = item / g.nct;
  w0 = ct * g.TW;
  h0 = (rest % g.nbands) * g.RB;
  n0 = (rest / g.nbands) * g.F;
}

// The item's x tile (halo included) and g tile in their dtype into one
// stage of the ring, a tile row a warp at a time, 16 bytes (8 bf16 or 4
// float32 channels) a lane. g pixels outside the item (past its band, its
// column tile or the frame) are zero, so the strips that cover them add
// nothing.
template <typename T>
__device__ __forceinline__ void issue_item(const Geo& g, const T* x,
                                           const T* gin, unsigned stage,
                                           int c0, int item, int warp,
                                           int lane, int nwarps) {
  constexpr int CH = CHUNKS<T>, EL = 16 / (int)sizeof(T);
  int n0, h0, w0;
  item_origin(g, item, n0, h0, w0);
  for (int row = warp; row < g.F * g.TH; row += nwarps) {
    const int f = row / g.TH;
    const int n = n0 + f, gy = h0 - PAD + (row - f * g.TH);
    const bool rv = n < g.N && gy >= 0 && gy < g.H;
    const T* src_row =
        x + ((size_t)(rv ? n : 0) * g.H + (rv ? gy : 0)) * g.W * g.C + c0;
    const unsigned dst_row = stage + (unsigned)(row * g.TWH) * PX<T>;
    for (int c = lane; c < g.TWH * CH; c += 32) {
      const int gx = w0 - PAD + c / CH;
      const bool v = rv && gx >= 0 && gx < g.W;
      cp_async16_zfill(dst_row + c * 16,
                       v ? src_row + (size_t)gx * g.C + (c % CH) * EL : x,
                       v);
    }
  }
  const unsigned gstage = stage + (unsigned)g.x_bytes;
  for (int row = warp; row < g.F * g.GH; row += nwarps) {
    const int f = row / g.GH;
    const int rr = row - f * g.GH;
    const int n = n0 + f, gy = h0 + rr;
    const bool rv = n < g.N && rr < g.RB && gy < g.H;
    const T* src_row =
        gin + ((size_t)(rv ? n : 0) * g.H + (rv ? gy : 0)) * g.W * g.C + c0;
    const unsigned dst_row = gstage + (unsigned)(row * g.GW) * PX<T>;
    for (int c = lane; c < g.GW * CH; c += 32) {
      const int col = c / CH;
      const int gx = w0 + col;
      const bool v = rv && col < g.TW && gx < g.W;
      cp_async16_zfill(dst_row + c * 16,
                       v ? src_row + (size_t)gx * g.C + (c % CH) * EL : gin,
                       v);
    }
  }
  cp_async_commit();
}

template <typename T, int CC, int SLOTS>
__global__ void __launch_bounds__(SLOTS * PAIRS, 1)
dwconv_wgrad_hopper_kernel(const T* __restrict__ x,
                           const T* __restrict__ gin,
                           float* __restrict__ partial, const Geo g) {
  using P2 = Pair2<T>;
  constexpr int NT = SLOTS * PAIRS;
  constexpr int NWARPS = NT / 32;
  constexpr int WIN = CC + K - 1;  // x columns a strip's row meets
  extern __shared__ __align__(16) unsigned char smem[];
  const unsigned smem_addr = (unsigned)__cvta_generic_to_shared(smem);

  const int nslab = g.C / SLAB;
  const int c0 = (blockIdx.x % nslab) * SLAB;
  const int first = blockIdx.x / nslab;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int p = tid % PAIRS, slot = tid / PAIRS;

  float2 acc[TAPS];
#pragma unroll
  for (int t = 0; t < TAPS; ++t) acc[t] = make_float2(0.f, 0.f);

  // the ring: items first and first + bps in flight before the loop; an
  // empty group where there is no item keeps the count of groups
  if (first < g.items)
    issue_item(g, x, gin, smem_addr, c0, first, warp, lane, NWARPS);
  else
    cp_async_commit();
  if (first + g.bps < g.items)
    issue_item(g, x, gin, smem_addr + g.stage_bytes, c0, first + g.bps, warp,
               lane, NWARPS);
  else
    cp_async_commit();

  const int x_row = g.TWH * PAIRS;  // channel pairs per x tile row
  int k = 0;
  for (int item = first; item < g.items; item += g.bps, ++k) {
    cp_async_wait_older();
    __syncthreads();  // item k's tiles have landed for every thread
    const unsigned char* st = smem + (size_t)(k & 1) * g.stage_bytes;
    const P2* xt = reinterpret_cast<const P2*>(st);
    const P2* gt = reinterpret_cast<const P2*>(st + g.x_bytes);
    for (int grp = slot; grp < g.groups; grp += SLOTS) {
      const int cg = grp % g.cgroups;
      const int rest = grp / g.cgroups;
      const int r0 = (rest % g.rgroups) * R;
      const int f = rest / g.rgroups;
      const int col0 = cg * CC;
      const P2* gb = gt + ((f * g.GH + r0) * g.GW + col0) * PAIRS + p;
      float2 gv[R][CC];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < CC; ++j)
          gv[r][j] = to_float2(gb[(r * g.GW + j) * PAIRS]);
      const P2* xb = xt + ((f * g.TH + r0) * g.TWH + col0) * PAIRS + p;
      // x row iy meets g row r through kernel row dy = iy - r, and x column
      // jj meets g column j through tap dx = jj - j; each sum takes its
      // terms in (iy, jj) order
#pragma unroll
      for (int iy = 0; iy < R + K - 1; ++iy) {
        const P2* rowp = xb + iy * x_row;
#pragma unroll
        for (int jj = 0; jj < WIN; ++jj) {
          const float2 xv = to_float2(rowp[jj * PAIRS]);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int dy = iy - r;
            if (dy < 0 || dy >= K) continue;
#pragma unroll
            for (int dx = 0; dx < K; ++dx) {
              const int j = jj - dx;
              if (j < 0 || j >= CC) continue;
              float2& a = acc[dy * K + dx];
              a.x = fmaf(xv.x, gv[r][j].x, a.x);
              a.y = fmaf(xv.y, gv[r][j].y, a.y);
            }
          }
        }
      }
    }
    __syncthreads();  // every thread is done with this stage
    const int next = item + 2 * g.bps;
    if (next < g.items)
      issue_item(g, x, gin, smem_addr + (unsigned)((k & 1) * g.stage_bytes),
                 c0, next, warp, lane, NWARPS);
    else
      cp_async_commit();
  }
  cp_async_wait_all();
  __syncthreads();

  // red[t][slot][c], over the ring's space; then thread (t, c) adds the
  // slots in order
  float2* red2 = reinterpret_cast<float2*>(smem);
#pragma unroll
  for (int t = 0; t < TAPS; ++t) red2[(t * SLOTS + slot) * PAIRS + p] = acc[t];
  __syncthreads();
  const float* red = reinterpret_cast<const float*>(smem);
  for (int i = tid; i < TAPS * SLAB; i += NT) {
    const int t = i / SLAB, c = i % SLAB;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < SLOTS; ++q) s += red[(t * SLOTS + q) * SLAB + c];
    partial[((size_t)first * TAPS + t) * g.C + c0 + c] = s;
  }
}

// dw[i] = sum over b of partial[b, i], in order b = 0, 1, ...
__global__ void wgrad_hopper_sum_parts(const float* __restrict__ partial,
                                       float* __restrict__ dw, int parts,
                                       int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int b = 0; b < parts; ++b) s += partial[(size_t)b * n + i];
  dw[i] = s;
}

// Share of the threads' slot-rounds that take a real strip: G strips on
// `slots` slots take ceil(G / slots) rounds.
double slot_share(int groups, int slots) {
  const int rounds = (groups + slots - 1) / slots;
  return (double)groups / (rounds * slots);
}

// two ring stages of an item of F frames and rb g rows, px bytes a pixel
size_t ring_bytes(const Geo& g, int F, int rb, int px) {
  const int gh = (rb + R - 1) / R * R;
  return 2 * (size_t)F * ((gh + 2 * PAD) * g.TWH + gh * g.GW) * px;
}

// The item geometry for a shape whose staged pixels take px bytes, and the
// kernel variant (CC, SLOTS).
void pick(int N, int H, int W, int C, int px, Geo& g, int& cc, int& slots) {
  g.N = N;
  g.H = H;
  g.W = W;
  g.C = C;
  cc = W % 7 == 0 ? 7 : 8;
  g.TW = W <= 64 ? W : (64 / cc) * cc;
  g.cgroups = (g.TW + cc - 1) / cc;
  g.GW = g.cgroups * cc;
  g.TWH = g.GW + 2 * PAD;
  g.nct = (W + g.TW - 1) / g.TW;
  double best = -1.0;
  if (H <= 16 && ring_bytes(g, 1, H, px) <= SMEM_MAX) {
    // whole frames, as many as fill the slots and the shared memory
    g.RB = H;
    g.rgroups = (H + R - 1) / R;
    const int per_frame = g.rgroups * g.cgroups;
    int F = per_frame >= 16 ? 1 : 16 / per_frame;
    if (F > N) F = N > 0 ? N : 1;
    while (F > 1 && ring_bytes(g, F, H, px) > SMEM_MAX) --F;
    g.F = F;
    g.groups = F * per_frame;
    for (int s : {16, 14}) {
      const double share = slot_share(g.groups, s);
      if (share > best) best = share, slots = s;
    }
  } else {
    // a band of RB rows: the largest band whose strips fill the slots and
    // whose bands fill the frame, within the shared memory; bands under 8
    // rows only where none of 8 or more fits (float32's pixels at a width
    // of 56: 4 rows)
    g.F = 1;
    g.RB = 2;
    for (int rb : {16, 14, 12, 10, 8, 6, 4, 2}) {
      if (rb < 8 && best >= 0.0) break;
      if (ring_bytes(g, 1, rb, px) > SMEM_MAX) continue;
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
    g.groups = g.rgroups * g.cgroups;
  }
  g.GH = g.rgroups * R;
  g.TH = g.GH + 2 * PAD;
  g.nbands = (H + g.RB - 1) / g.RB;
  g.items = (N + g.F - 1) / g.F * g.nbands * g.nct;
  g.x_bytes = g.F * g.TH * g.TWH * px;
  g.stage_bytes = g.x_bytes + g.F * g.GH * g.GW * px;
}

template <typename T, int CC, int SLOTS>
int launch(const T* x, const T* gin, float* partial, float* dw,
           Geo g, int max_parts, cudaStream_t stream, int* grid_out) {
  auto kernel = dwconv_wgrad_hopper_kernel<T, CC, SLOTS>;
  const size_t red = (size_t)TAPS * SLOTS * SLAB * 4;
  const size_t smem = 2 * (size_t)g.stage_bytes > red
                          ? 2 * (size_t)g.stage_bytes : red;
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
  // one wave, the same number of blocks for every slab, each with an item
  // and a row of the partial sums
  const int nslab = g.C / SLAB;
  int bps = per_sm * sms / nslab;
  if (bps > g.items) bps = g.items;
  if (bps > max_parts) bps = max_parts;
  if (bps < 1) bps = 1;
  g.bps = bps;
  if (grid_out != nullptr) {
    grid_out[0] = nslab * bps;
    grid_out[1] = (int)smem;
    return 0;
  }
  kernel<<<nslab * bps, SLOTS * PAIRS, smem, stream>>>(x, gin, partial, g);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int total = TAPS * g.C;
  wgrad_hopper_sum_parts<<<(total + 255) / 256, 256, 0, stream>>>(
      partial, dw, bps, total);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* gin, void* partial, void* dw, int n,
             int H, int W, int C, int max_parts, cudaStream_t stream,
             int* geo_out) {
  if (n < 0 || H < 1 || W < 1 || C < SLAB || C % SLAB || max_parts < 1)
    return (int)cudaErrorInvalidValue;
  Geo g;
  int cc = 8, slots = 16;
  pick(n, H, W, C, PX<T>, g, cc, slots);
  int grid[2] = {0, 0};
  int* grid_out = geo_out != nullptr ? grid : nullptr;
  if (n == 0 && grid_out == nullptr)  // no terms: every sum is 0
    return (int)cudaMemsetAsync(dw, 0, (size_t)TAPS * C * 4, stream);
  const T *xp = (const T*)x, *gp = (const T*)gin;
  float *pp = (float*)partial, *dp = (float*)dw;
  int err;
  if (cc == 7 && slots == 16)
    err = launch<T, 7, 16>(xp, gp, pp, dp, g, max_parts, stream, grid_out);
  else if (cc == 7)
    err = launch<T, 7, 14>(xp, gp, pp, dp, g, max_parts, stream, grid_out);
  else if (slots == 16)
    err = launch<T, 8, 16>(xp, gp, pp, dp, g, max_parts, stream, grid_out);
  else
    err = launch<T, 8, 14>(xp, gp, pp, dp, g, max_parts, stream, grid_out);
  if (err != 0) return err;
  if (geo_out != nullptr) {
    const int vals[10] = {cc, slots, g.F, g.RB, g.TW, g.groups, g.items,
                          grid[0], grid[1], g.nbands};
    for (int i = 0; i < 10; ++i) geo_out[i] = vals[i];
  }
  return 0;
}

int dispatch(int dtype, const void* x, const void* gin, void* partial,
             void* dw, int n, int H, int W, int C, int max_parts,
             cudaStream_t stream, int* geo_out) {
  if (dtype == 0)
    return dispatch<bf16>(x, gin, partial, dw, n, H, W, C, max_parts, stream,
                          geo_out);
  if (dtype == 1)
    return dispatch<float>(x, gin, partial, dw, n, H, W, C, max_parts,
                           stream, geo_out);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. x, g [n, H, W, C] of that dtype,
// contiguous, 16-byte aligned, C a multiple of 32; partial float32 scratch
// of at least [max_parts, 49, C]; dw float32 [49, C].
extern "C" int vcd_dwconv_wgrad_hopper(const void* x, const void* g,
                                       void* partial, void* dw, int n, int H,
                                       int W, int C, int max_parts, int dtype,
                                       void* stream) {
  return dispatch(dtype, x, g, partial, dw, n, H, W, C, max_parts,
                  (cudaStream_t)stream, nullptr);
}

// The launch the kernel would make for a shape and dtype, without
// launching: geo[10] receives CC, thread slots, frames an item, g rows an
// item, g columns an item, strips an item, items a slab, grid, dynamic
// shared bytes, bands a frame.
extern "C" int vcd_dwconv_wgrad_hopper_geometry(int n, int H, int W, int C,
                                                int max_parts, int dtype,
                                                int* geo) {
  return dispatch(dtype, nullptr, nullptr, nullptr, nullptr, n, H, W, C,
                  max_parts, nullptr, geo);
}
