"""Build and load the port's CUDA kernels (``ops/csrc``).

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes``. The build runs at
first use and is keyed by a hash of the sources and flags, under
``build/torch_kernels/<hash>/`` at the root of the checkout (``build/`` is
git-ignored). Each source compiles in its own ``nvcc`` process, all started
together, then one link makes the library.

Every C entry returns ``cudaGetLastError()`` after its launch; ``check``
raises on anything but 0. Nothing here is touched when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
LIB_NAME = "libvcd_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# the Hopper kernels look libcuda's tensor-map encoder up with dlsym
LINK_FLAGS = ["-ldl"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_int64)  # host array of element strides
# C entry → argument types (pointers and the stream as void*).
_SIGNATURES = {
    "vcd_dequant_pad": [_P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _I,
                        _P],
    "vcd_dwconv7x7": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "vcd_dwconv7x7_hopper": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "vcd_dwconv7x7_hopper_geometry": [_I, _I, _I, _I, _I,
                                      ctypes.POINTER(ctypes.c_int)],
    "vcd_dwconv_wgrad": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "vcd_dwconv_wgrad_hopper": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "vcd_dwconv_wgrad_hopper_geometry": [_I, _I, _I, _I, _I, _I,
                                         ctypes.POINTER(ctypes.c_int)],
    "vcd_convnext_mlp": [_P] * 10 + [_I, _I, _I, _I, _P],
    "vcd_convnext_mlp_train": [_P] * 13 + [_I, _I, _I, _I, _P],
    "vcd_convnext_mlp_wgmma": [_P] * 13 + [_I, _I, _I, _I, _P],
    "vcd_convnext_mlp_wide": [_P] * 14 + [_I] * 5 + [_P],
    "vcd_flash_fwd": [_P] * 5 + [_STRIDES, _I, _I, _I, _I, _F, _I, _P],
    "vcd_flash_fwd_wgmma": [_P] * 5 + [_STRIDES, _I, _I, _I, _F, _P],
    "vcd_flash_fwd_wgmma_d16": [_P] * 5 + [_STRIDES, _I, _I, _I, _F, _P],
    "vcd_flash_fwd_f32": [_P] * 3 + [_I, _I, _I, _F, _P],
    "vcd_flash_fwd_f32_d16": [_P] * 3 + [_I, _I, _I, _F, _P],
    "vcd_flash_split_f32": [_P] * 4 + [_STRIDES, _P, _I, _I, _I, _I, _P],
    "vcd_flash_bwd_dkv": [_P] * 8 + [_STRIDES, _I, _I, _I, _I, _F, _I, _P],
    "vcd_flash_bwd_dq": [_P] * 7 + [_STRIDES, _I, _I, _I, _I, _F, _I, _P],
    "vcd_flash_bwd_dkv_wgmma": [_P] * 8 + [_STRIDES, _I, _I, _I, _F, _P],
    "vcd_flash_bwd_dq_wgmma": [_P] * 7 + [_STRIDES, _I, _I, _I, _F, _P],
    "vcd_flash_bwd_dkv_wgmma_d16": [_P] * 8 + [_STRIDES, _I, _I, _I, _F, _P],
    "vcd_flash_bwd_dq_wgmma_d16": [_P] * 7 + [_STRIDES, _I, _I, _I, _F, _P],
    "vcd_flash_bwd_dkv_f32": [_P] * 5 + [_I, _I, _I, _F, _P],
    "vcd_flash_bwd_dq_f32": [_P] * 4 + [_I, _I, _I, _F, _P],
    "vcd_flash_bwd_dkv_f32_d16": [_P] * 5 + [_I, _I, _I, _F, _P],
    "vcd_flash_bwd_dq_f32_d16": [_P] * 4 + [_I, _I, _I, _F, _P],
    "vcd_flash_bwd_di": [_P] * 3 + [_STRIDES, _I, _I, _I, _I, _I, _P],
    "vcd_train_preprocess": [_P] * 4 + [_I] * 8 + [_F] * 7 + [_I, _P],
}

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); the "
            "port's CUDA kernels are built from source at first use")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for path in cu + cuh:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this source hash has no library yet; return
    the library's path. A failed compile raises with nvcc's output."""
    final = BUILD_ROOT / source_hash()
    lib_path = final / LIB_NAME
    if lib_path.exists():
        return lib_path
    tmp = BUILD_ROOT / f"{final.name}.tmp{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    nvcc = _nvcc()
    cu, _ = _sources()
    procs = []
    for src in cu:
        obj = tmp / (src.stem + ".o")
        log = open(tmp / (src.stem + ".log"), "w")
        procs.append((src, log, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)],
            stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for src, log, proc in procs:
        proc.wait()
        log.close()
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        text = "\n".join((tmp / (Path(n).stem + ".log")).read_text()
                         for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{text}")
    subprocess.run(
        [nvcc, "-shared", "-o", str(tmp / LIB_NAME),
         *[str(tmp / (s.stem + ".o")) for s in cu], *LINK_FLAGS],
        check=True, capture_output=True, text=True)
    try:
        os.replace(tmp, final)
    except OSError:  # another process finished the same build first
        shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.vcd_error_string.argtypes = [ctypes.c_int]
        handle.vcd_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        msg = lib().vcd_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def sm_count(device) -> int:
    """The card's streaming multiprocessors (grids are sized from it)."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def require_cuda(t, name: str, align: int = 1) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor whose data starts on
    an ``align``-byte boundary (the kernels' vector loads need it)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must start on a {align}-byte boundary")
