// What K4's forward and backward kernels share: the [B, S, H, D] addressing
// by strides, the tile shape and the tile loader of the bf16 kernels.
#pragma once

#include <math_constants.h>

#include "mma.cuh"

namespace vcd {

// Element strides of a [B, S, H, D] tensor whose last axis is contiguous.
struct Strides {
  int64_t b, s, h;
};

// The bf16 kernels' tiling: 64 rows of queries or keys per block, 4 warps of
// 16 rows each, walking the other sequence axis in tiles of 64. Rows of a
// tile in shared memory carry 16 bytes of skew, so the eight rows one
// ldmatrix reads fall in distinct banks.
template <int D>
struct FlashTile {
  static constexpr int ROWS = 64, WARPS = 4, THREADS = WARPS * 32;
  static constexpr int LD = D + 8;    // bf16 row stride in shared memory
  static constexpr int KS = D / 16;   // 16-wide steps over head_dim
  static constexpr int NT = ROWS / 8; // 8-wide column tiles of a logits tile
  static constexpr int ELEMS = ROWS * LD;
  static_assert(D % 16 == 0, "head_dim in 16-wide mma steps");
};

// Rows [row0, row0 + 64) of one head's [S, D] slice -> dst [64][LD] with
// cp.async, 16 bytes a copy; rows past S are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int64_t row_stride, int row0,
                                          int S) {
  using T = FlashTile<D>;
  constexpr int VR = D / 8;
  for (int i = threadIdx.x; i < T::ROWS * VR; i += T::THREADS) {
    const int r = i / VR, v = i % VR;
    bf16* d = dst + r * T::LD + v * 8;
    if (row0 + r < S)
      cp_async16(d, src + (int64_t)(row0 + r) * row_stride + v * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Lane addressing of the two ldmatrix patterns. As the A operand, or with
// .trans as the B operand of a [k][n] row-major tile: lanes 0-15 give rows
// 0-15 at column 0, lanes 16-31 the same rows at column 8. As the B operand
// of an [n][k] row-major tile (no .trans): the four matrices are
// (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15), so
// that registers 0, 1 are b0, b1 of column tile 0 and 2, 3 those of tile 1.
struct Lanes {
  int g, tg, a_row, a_col, b_row, b_col;
  __device__ __forceinline__ Lanes() {
    const int lane = threadIdx.x % 32;
    g = lane / 4, tg = lane % 4;
    a_row = lane % 16, a_col = (lane / 16) * 8;
    b_row = (lane / 16) * 8 + lane % 8, b_col = ((lane / 8) % 2) * 8;
  }
};

// acc[16 x 64] += A[16 x D] @ Bt^T, A as D/16 fragments in registers, Bt a
// [64][LD] tile in shared memory read as [n][k] (logits = Q @ K^T).
template <int D>
__device__ __forceinline__ void mma_a_bt(float (&acc)[8][4],
                                         const unsigned (&a)[D / 16][4],
                                         const bf16* bt, const Lanes& L) {
  using T = FlashTile<D>;
#pragma unroll
  for (int ks = 0; ks < T::KS; ++ks)
#pragma unroll
    for (int np = 0; np < T::NT / 2; ++np) {
      unsigned b[4];
      ldsm_x4(b, bt + (np * 16 + L.b_row) * T::LD + ks * 16 + L.b_col);
      mma_bf16(acc[2 * np], a[ks], b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a[ks], b[2], b[3]);
    }
}

// acc[16 x D] += A[16 x 64] @ B, A as four fragments in registers, B a
// [64][LD] tile in shared memory read as [k][n] (out = P @ V).
template <int D>
__device__ __forceinline__ void mma_a_b(float (&acc)[D / 8][4],
                                        const unsigned (&a)[4][4],
                                        const bf16* b_tile, const Lanes& L) {
  using T = FlashTile<D>;
#pragma unroll
  for (int j = 0; j < T::ROWS / 16; ++j)
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      unsigned b[4];
      ldsm_x4_trans(b, b_tile + (j * 16 + L.a_row) * T::LD + dp * 16 + L.a_col);
      mma_bf16(acc[2 * dp], a[j], b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], a[j], b[2], b[3]);
    }
}

// A warp's 16 rows of a [64][LD] tile as D/16 A fragments.
template <int D>
__device__ __forceinline__ void load_a(unsigned (&a)[D / 16][4],
                                       const bf16* tile, int warp,
                                       const Lanes& L) {
  using T = FlashTile<D>;
#pragma unroll
  for (int ks = 0; ks < T::KS; ++ks)
    ldsm_x4(a[ks], tile + (warp * 16 + L.a_row) * T::LD + ks * 16 + L.a_col);
}

// A warp's 16 x D float32 accumulators -> rows of a contiguous [B, S, H, D]
// tensor of T (bf16, rounded, or float), rows past S left out.
template <int D, typename T>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[D / 8][4],
                                           int b, int h, int row0, int S, int H,
                                           const Lanes& L) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + L.g + 8 * half;
    if (row >= S) continue;
    T* p = out + (((int64_t)b * S + row) * H + h) * D + 2 * L.tg;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      Pair<T>::store(p + nt * 8,
                     make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]));
  }
}

}  // namespace vcd
