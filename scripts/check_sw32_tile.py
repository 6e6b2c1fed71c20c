#!/usr/bin/env python3
"""The 32-byte swizzle of K4's head_dim-16 kernels on one tile, on one
NVIDIA GPU: what TMA writes with ``CU_TENSOR_MAP_SWIZZLE_32B`` against
``sw32_chunk``, and the wgmma descriptors of ``sw32_desc`` in both of their
uses against ``torch.matmul``.

    python3 scripts/check_sw32_tile.py

Compiles a small test kernel (its source below, built on the port's
``ops/csrc/hopper.cuh`` and ``flash_wgmma.cuh``) into ``build/sw32_tile/``
and checks, on seeded bf16 data:

1. the bytes of a [128, 16] tile loaded by TMA through ``make_map16``
   against the same rows placed by ``sw32_chunk`` (bit-equal);
2. s = q·kᵀ [64 × 128]: q's 64 rows as A fragments (``load_a_sw32``), k's
   128 rows the K-major B operand of one m64n128k16 (``wgmma_rs128``), and
   the same over k's first 64 rows with m64n64k16 (``wgmma_rs``);
3. o = p·v [64 × 16]: p [64 × 128] as A fragments built in registers, v's
   128 rows the MN-major B operand of eight m64n16k16 k-steps
   (``wgmma_rs16``, 512 bytes a step).

Products of bf16 values summed in float32 in another order: within 1e-5 of
the largest |value| (the products are exact in float32; only the order of
16 or 128 sums differs). Exits non-zero on a mismatch or without a card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SOURCE = r"""
#include "flash_wgmma.cuh"

using namespace vcd;

__global__ void __launch_bounds__(128)
probe(const __grid_constant__ CUtensorMap map_q,
      const __grid_constant__ CUtensorMap map_k,
      const __grid_constant__ CUtensorMap map_v, const bf16* p,
      unsigned char* raw_k, float* s128, float* s64, float* o) {
  extern __shared__ unsigned char smem_raw[];
  const unsigned base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const unsigned q_t = base, k_t = base + 4096, v_t = base + 8192,
                 bar = base + 12288;
  unsigned char* gen = smem_raw + (base - smem_u32(smem_raw));
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect(bar, 2048 + 4096 + 4096);
    tma_load_4d(q_t, &map_q, bar, 0, 0, 0, 0);
    tma_load_4d(k_t, &map_k, bar, 0, 0, 0, 0);
    tma_load_4d(v_t, &map_v, bar, 0, 0, 0, 0);
  }
  mbar_wait(bar, 0);
  for (int i = threadIdx.x; i < 4096; i += 128) raw_k[i] = gen[4096 + i];
  const int warp = threadIdx.x / 32;
  const Lanes L;
  unsigned qf[4];
  load_a_sw32(qf, q_t, warp);
  float d128[16][4], d64[8][4], od[2][4];
  for (int n = 0; n < 2; ++n)
    for (int e = 0; e < 4; ++e) od[n][e] = 0.f;
  // p's A fragments: rows 16·warp + g (+8), columns 16·j + 2·tg (+1, +8,
  // +9)
  unsigned pf[8][4];
  for (int j = 0; j < 8; ++j)
    for (int i = 0; i < 4; ++i) {
      const int row = warp * 16 + L.g + 8 * (i % 2);
      const int col = 16 * j + 2 * L.tg + 8 * (i / 2);
      const bf16* at = p + row * 128 + col;
      pf[j][i] = pack_bf16(__bfloat162float(at[0]), __bfloat162float(at[1]));
    }
  wgmma_fence();
  wgmma_rs128<0>(d128, qf, sw32_desc(k_t), 0);
  wgmma_rs<0>(d64, qf, sw32_desc(k_t), 0);
  for (int j = 0; j < 8; ++j)
    wgmma_rs16<1>(od, pf[j], sw32_desc(v_t) + 32 * j, 1);
  wgmma_commit();
  wgmma_wait<0>();
  acc_fence(d128);
  acc_fence(d64);
  acc_fence(od);
  for (int half = 0; half < 2; ++half) {
    const int row = warp * 16 + L.g + 8 * half;
    for (int nt = 0; nt < 16; ++nt)
      for (int c = 0; c < 2; ++c) {
        const int col = nt * 8 + 2 * L.tg + c;
        s128[row * 128 + col] = d128[nt][2 * half + c];
        if (nt < 8) s64[row * 64 + col] = d64[nt][2 * half + c];
        if (nt < 2) o[row * 16 + col] = od[nt][2 * half + c];
      }
  }
}

extern "C" int run(const void* q, const void* k, const void* v,
                   const void* p, void* raw_k, void* s128, void* s64,
                   void* o) {
  CUtensorMap mq, mk, mv;
  const Strides st{128 * 16, 16, 128 * 16};  // [1, 128, 1, 16]
  cudaError_t err;
  if ((err = make_map16(&mq, q, st, 1, 128, 1, 64)) != cudaSuccess ||
      (err = make_map16(&mk, k, st, 1, 128, 1, 128)) != cudaSuccess ||
      (err = make_map16(&mv, v, st, 1, 128, 1, 128)) != cudaSuccess)
    return (int)err;
  const int dynamic = 12288 + 64 + 1024;
  if ((err = cudaFuncSetAttribute(probe,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  dynamic)) != cudaSuccess)
    return (int)err;
  probe<<<1, 128, dynamic>>>(mq, mk, mv, (const bf16*)p,
                             (unsigned char*)raw_k, (float*)s128,
                             (float*)s64, (float*)o);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)cudaDeviceSynchronize();
}
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("check_sw32_tile: no CUDA device is available", file=sys.stderr)
        return 1
    out_dir = os.path.join(ROOT, "build", "sw32_tile")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "probe.cu")
    with open(src, "w") as f:
        f.write(SOURCE)
    csrc = os.path.join(ROOT, "vision_collision_detection_tpu_torch", "ops",
                        "csrc")
    lib_path = os.path.join(out_dir, "libprobe.so")
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "nvcc")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-I", csrc, "-o", lib_path, src, "-ldl"], check=True)
    lib = ctypes.CDLL(lib_path)
    lib.run.argtypes = [ctypes.c_void_p] * 8
    lib.run.restype = ctypes.c_int

    g = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    q, k, v = (torch.randn(128, 16, generator=g).to(dev, torch.bfloat16)
               for _ in range(3))
    p = torch.rand(64, 128, generator=g).to(dev, torch.bfloat16)
    raw = torch.zeros(4096, dtype=torch.uint8, device=dev)
    s128 = torch.zeros(64, 128, device=dev)
    s64 = torch.zeros(64, 64, device=dev)
    o = torch.zeros(64, 16, device=dev)
    err = lib.run(q.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(),
                  raw.data_ptr(), s128.data_ptr(), s64.data_ptr(),
                  o.data_ptr())
    if err:
        print(f"check_sw32_tile: CUDA error {err}", file=sys.stderr)
        return 1

    # 1. the tile's bytes: row r at 32·r, chunk c at c ^ ((r / 4) % 2)
    k_bytes = k.view(torch.uint8).view(128, 2, 16).cpu()
    want = torch.empty(128, 2, 16, dtype=torch.uint8)
    for r in range(128):
        for c in range(2):
            want[r, c ^ ((r >> 2) & 1)] = k_bytes[r, c]
    got = raw.cpu().view(128, 2, 16)
    failed = []
    print(f"[sw32] TMA tile bytes equal to sw32_chunk's placement: "
          f"{bool(torch.equal(got, want))}")
    if not torch.equal(got, want):
        failed.append("tile bytes")
    qf, kf, vf, pf = (t.float() for t in (q, k, v, p))
    for name, val, ref in (
            ("q·kᵀ m64n128k16 (K-major)", s128, qf[:64] @ kf.T),
            ("q·kᵀ m64n64k16 (K-major)", s64, qf[:64] @ kf[:64].T),
            ("p·v m64n16k16 x8 (MN-major)", o, pf @ vf)):
        err = float((val - ref).abs().max())
        tol = float(ref.abs().max()) * 1e-5
        print(f"[sw32] {name}: max |Δ| {err:.3e} (tol {tol:.3e})")
        if not err <= tol:
            failed.append(name)
    if failed:
        print(f"check_sw32_tile: mismatch in {failed}", file=sys.stderr)
        return 1
    print("[sw32] ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
