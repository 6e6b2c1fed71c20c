// Hopper-only primitives (sm_90a) of the Hopper kernels (K3, K4's forward
// and backward): warpgroup matrix products (wgmma) over 128-byte-swizzled
// tiles in shared memory, mbarriers, and tensor-map (TMA) loads and stores.
//
// One tile layout serves every operand: 64 rows of 64 bf16 (128 bytes a
// row, 8 KB a tile), the tile 1024-byte aligned, the 16-byte chunk c of row
// r stored at chunk c ^ (r % 8). A tensor map with
// CU_TENSOR_MAP_SWIZZLE_128B writes exactly this; `sw128_chunk` is the same
// rule for code that fills a tile itself.
//
// The same tile is read two ways as wgmma's B operand, with one descriptor
// form (128-byte swizzle, 1024 bytes from one group of eight rows to the
// next):
// - K-major (the rows are the operand's N index, the product runs along the
//   128-byte row): the k-th step of 16 columns starts 32·k bytes in.
// - MN-major (the rows are the product's k index, the operand's N index runs
//   along the row; the instruction's tnspB bit): the k-th step of 16 rows
//   starts 2048·k bytes in.
// A operands come from registers (ldmatrix reads them out of a tile by the
// same rule) or from a tile in shared memory, read K-major like B.
//
// Head_dim 16 (K4 at vivit_tiny's width) has rows of 16 bf16, 32 bytes,
// in tiles of the 32-byte swizzle: row r at 32·r, its 16-byte chunk c at
// chunk c ^ ((r / 4) % 2), the pattern repeating every 256 bytes (8 rows),
// the tile 256-byte aligned. CU_TENSOR_MAP_SWIZZLE_32B writes it;
// `sw32_chunk` is the rule, `sw32_desc` the descriptor (32-byte swizzle,
// 256 bytes from one group of eight rows to the next). One row is one
// k-step of 16, so as a K-major B (logits over head_dim 16) a product is
// one wgmma; read MN-major (N = 16 along the row, the k index down the
// rows) the k-th step of 16 rows starts 512·k bytes in.
//
// Host side: tensor maps of bf16 operands (and of float32 ones, whose
// 128-byte rows hold 32 values), encoded through libcuda's
// cuTensorMapEncodeTiled (found with dlsym: the kernels link against the
// runtime only).
#pragma once

#include <cuda.h>
#include <dlfcn.h>

#include "mma.cuh"

namespace vcd {

constexpr int TILE_ROWS = 64;
constexpr int TILE_BYTES = TILE_ROWS * 128;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Byte offset of 16-byte chunk `c` (0-7) of row `r` in a swizzled tile.
__device__ __forceinline__ int sw128_chunk(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// wgmma matrix descriptor of a swizzled tile (or a k-step inside it) at
// shared address `addr`.
__device__ __forceinline__ uint64_t sw128_desc(unsigned addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4)  // start address / 16
         | (uint64_t)1 << 16                 // leading offset: one atom, unused
         | (uint64_t)(1024 >> 4) << 32       // stride between 8-row groups
         | (uint64_t)1 << 62;                // 128-byte swizzle
}

// Byte offset of 16-byte chunk `c` (0-1) of row `r` in a tile of the
// 32-byte swizzle.
__device__ __forceinline__ int sw32_chunk(int r, int c) {
  return r * 32 + ((c ^ ((r >> 2) & 1)) << 4);
}

// wgmma matrix descriptor of a 32-byte-swizzled tile (or a k-step inside
// it) at shared address `addr`.
__device__ __forceinline__ uint64_t sw32_desc(unsigned addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4)  // start address / 16
         | (uint64_t)1 << 16                 // leading offset: one atom, unused
         | (uint64_t)(256 >> 4) << 32        // stride between 8-row groups
         | (uint64_t)3 << 62;                // 32-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define VCD_ACC8(d, n) \
  "+f"(d[n][0]), "+f"(d[n][1]), "+f"(d[n][2]), "+f"(d[n][3])
#define VCD_ACC32(d)                                                   \
  VCD_ACC8(d, 0), VCD_ACC8(d, 1), VCD_ACC8(d, 2), VCD_ACC8(d, 3),      \
      VCD_ACC8(d, 4), VCD_ACC8(d, 5), VCD_ACC8(d, 6), VCD_ACC8(d, 7)
#define VCD_ACC32_LIST                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31}"

// Pins a warpgroup accumulator at this point of the program: the compiler
// may not move arithmetic on it across the wgmma_wait before, nor across the
// asynchronous products after.
__device__ __forceinline__ void acc_fence(float (&d)[8][4]) {
  asm volatile("" : VCD_ACC32(d)::"memory");
}
__device__ __forceinline__ void acc_fence(float (&d)[4][4]) {
  asm volatile(""
               : VCD_ACC8(d, 0), VCD_ACC8(d, 1), VCD_ACC8(d, 2),
                 VCD_ACC8(d, 3)::"memory");
}
__device__ __forceinline__ void acc_fence(float (&d)[2][4]) {
  asm volatile("" : VCD_ACC8(d, 0), VCD_ACC8(d, 1)::"memory");
}
__device__ __forceinline__ void acc_fence(float (&d)[16][4]) {
  asm volatile(""
               : VCD_ACC8(d, 0), VCD_ACC8(d, 1), VCD_ACC8(d, 2),
                 VCD_ACC8(d, 3), VCD_ACC8(d, 4), VCD_ACC8(d, 5),
                 VCD_ACC8(d, 6), VCD_ACC8(d, 7)::"memory");
  asm volatile(""
               : VCD_ACC8(d, 8), VCD_ACC8(d, 9), VCD_ACC8(d, 10),
                 VCD_ACC8(d, 11), VCD_ACC8(d, 12), VCD_ACC8(d, 13),
                 VCD_ACC8(d, 14), VCD_ACC8(d, 15)::"memory");
}

// d[64 x 64] (+)= A[64 x 16] · B[16 x 64], float32 += bf16 · bf16, started by
// the four warps of a warpgroup together and asynchronous until wgmma_wait.
// d is held like four mma.sync m16n8 tiles side by side per warp: warp w of
// the group owns rows 16w to 16w + 15, d[n] is its 16 x 8 tile of columns 8n
// to 8n + 7 (see mma_bf16). A is this warp's mma.sync A fragment in
// registers (see acc_to_a, load_a_sw128); B comes from shared memory, read
// MN-major where B_MN_MAJOR (the instruction's tnspB), else K-major. With
// `accumulate` 0 the product replaces d, whatever d held.
template <int B_MN_MAJOR>
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4],
                                         const unsigned (&a)[4],
                                         uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VCD_ACC32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : VCD_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc),
        "r"(accumulate), "n"(B_MN_MAJOR));
}

// The same with N = 16 (d[64 x 16], a warp's 16 x 16 tile as d[2][4]) and
// N = 128 (d[16][4]).
template <int B_MN_MAJOR>
__device__ __forceinline__ void wgmma_rs16(float (&d)[2][4],
                                           const unsigned (&a)[4],
                                           uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "%14;\n}\n"
      : VCD_ACC8(d, 0), VCD_ACC8(d, 1)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc),
        "r"(accumulate), "n"(B_MN_MAJOR));
}

#define VCD_ACC64(d)                                                     \
  VCD_ACC8(d, 0), VCD_ACC8(d, 1), VCD_ACC8(d, 2), VCD_ACC8(d, 3),        \
      VCD_ACC8(d, 4), VCD_ACC8(d, 5), VCD_ACC8(d, 6), VCD_ACC8(d, 7),    \
      VCD_ACC8(d, 8), VCD_ACC8(d, 9), VCD_ACC8(d, 10), VCD_ACC8(d, 11),  \
      VCD_ACC8(d, 12), VCD_ACC8(d, 13), VCD_ACC8(d, 14), VCD_ACC8(d, 15)
#define VCD_ACC64_LIST                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "     \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "     \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

template <int B_MN_MAJOR>
__device__ __forceinline__ void wgmma_rs128(float (&d)[16][4],
                                            const unsigned (&a)[4],
                                            uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " VCD_ACC64_LIST
      ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : VCD_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc),
        "r"(accumulate), "n"(B_MN_MAJOR));
}

// d[64 x 64] (+)= A[64 x 16] · B[16 x 64] with both operands K-major tiles
// in shared memory (descriptors a_desc, b_desc).
__device__ __forceinline__ void wgmma_ss64(float (&d)[8][4], uint64_t a_desc,
                                           uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VCD_ACC32_LIST
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : VCD_ACC32(d)
      : "l"(a_desc), "l"(b_desc), "r"(accumulate));
}

// The same with N = 32: d[64 x 32], a warp's 16 x 32 tile as d[4][4].
__device__ __forceinline__ void wgmma_ss32(float (&d)[4][4], uint64_t a_desc,
                                           uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : VCD_ACC8(d, 0), VCD_ACC8(d, 1), VCD_ACC8(d, 2), VCD_ACC8(d, 3)
      : "l"(a_desc), "l"(b_desc), "r"(accumulate));
}

// d (+)= A · Bᵀ over a depth of 64, A[64 x 64] as four register fragments
// (one per 16 columns) and B a swizzled tile whose 64 rows are the
// product's n index (logits = Q · Kᵀ): four k-steps, 32 bytes (2
// descriptor units) apart, the first of which overwrites d unless
// `accumulate`.
__device__ __forceinline__ void wgmma_tile_abt(float (&d)[8][4],
                                               const unsigned (&a)[4][4],
                                               uint64_t b,
                                               int accumulate = 0) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_rs<0>(d, a[ks], b + 2 * ks, ks > 0 || accumulate);
}

// d += A · B with A[64 x 64] as four register fragments and B a swizzled
// tile whose 64 rows are the product's k index (out = P · V): four k-steps,
// 2048 bytes (128 descriptor units) apart.
__device__ __forceinline__ void wgmma_tile_ab(float (&d)[8][4],
                                              const unsigned (&a)[4][4],
                                              uint64_t b) {
#pragma unroll
  for (int j = 0; j < 4; ++j) wgmma_rs<1>(d, a[j], b + 128 * j, 1);
}

// A warp's 16 rows (warp_in_group * 16 on) of a swizzled tile at shared
// address `tile` as four mma A fragments, one per 16 columns.
__device__ __forceinline__ void load_a_sw128(unsigned (&a)[4][4],
                                             unsigned tile, int warp_in_group) {
  const int lane = threadIdx.x % 32;
  const int row = warp_in_group * 16 + lane % 16;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const unsigned at = tile + sw128_chunk(row, 2 * ks + lane / 16);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(a[ks][0]), "=r"(a[ks][1]), "=r"(a[ks][2]), "=r"(a[ks][3])
        : "r"(at));
  }
}

// A warp's 16 rows (warp_in_group * 16 on) of a 32-byte-swizzled tile of
// 16 columns at shared address `tile` as one mma A fragment.
__device__ __forceinline__ void load_a_sw32(unsigned (&a)[4], unsigned tile,
                                            int warp_in_group) {
  const int lane = threadIdx.x % 32;
  const unsigned at = tile + sw32_chunk(warp_in_group * 16 + lane % 16,
                                        lane / 16);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(at));
}

// Orders this thread's generic writes to shared memory before later reads
// by the async proxy (wgmma operands, TMA stores).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier of `threads` threads (a multiple of 32) under the named barrier
// `id` (1-15; 0 is __syncthreads).
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Moves registers between the warpgroups of a block: every warp of a
// warpgroup executes the same one, in a branch it never leaves.
template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// 2^x by the special-function unit.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- mbarriers ----------------------------------------------------------

__device__ __forceinline__ void mbar_init(unsigned bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(arrivals)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect(unsigned bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// Waits until the barrier's phase with this parity has completed. A wait
// that does not end within some seconds traps, so that a load that never
// lands fails the launch instead of holding the card.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  for (int spins = 0;; ++spins) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1 << 24)) __trap();
  }
}

// ---- TMA ------------------------------------------------------------------

// One box of the 4-D tensor map `map` at coordinates (c0, c1, c2, c3),
// innermost first, into shared memory at `dst`; its bytes complete on `bar`.
__device__ __forceinline__ void tma_load_4d(unsigned dst, const void* map,
                                            unsigned bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The same for a 2-D map at (c0, c1).
__device__ __forceinline__ void tma_load_2d(unsigned dst, const void* map,
                                            unsigned bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(map), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// A box of the 2-D tensor map `map` at (c0, c1) from shared memory at
// `src`, as one bulk group of this thread; parts outside the tensor are not
// written.
__device__ __forceinline__ void tma_store_2d(const void* map, unsigned src,
                                             int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n" ::"l"(map), "r"(src), "r"(c0), "r"(c1)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until this thread's bulk groups have read their shared memory.
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Waits until this thread's bulk groups are complete.
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---- tensor maps (host) -----------------------------------------------------

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled out of libcuda, which the process already has
// loaded.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* libcuda = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return libcuda ? reinterpret_cast<EncodeTiled>(
                         dlsym(libcuda, "cuTensorMapEncodeTiled"))
                   : nullptr;
  }();
  return fn;
}

// The map of a tensor of element type `type` and `rank` dimensions,
// innermost first, with the byte strides of dimensions 1 to rank - 1 and a
// box of `box` elements: the box's innermost 128 bytes (64 bf16, 32
// float32) fill one swizzled row, elements past the tensor's end read as
// zeros.
// `swizzle`: the 128-byte swizzle, or the 32-byte one for boxes whose rows
// are 32 bytes (head_dim 16 in bf16).
inline cudaError_t make_map(
    CUtensorMap* map, CUtensorMapDataType type, const void* ptr, int rank,
    const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorSharedObjectSymbolNotFound;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(
      map, type, rank, const_cast<void*>(ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// make_map of a bf16 tensor.
inline cudaError_t make_bf16_map(
    CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
    const cuuint64_t* strides, const cuuint32_t* box,
    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, rank, dims,
                  strides, box, swizzle);
}

}  // namespace vcd
