"""Build ``libvcd_media.so``, the port's FFmpeg decode / probe / encode
library, from ``media/csrc/vcd_media.cpp``.

    python -m vision_collision_detection_tpu_torch.media.build

The library is built at first use into ``build/media/<hash>/`` at the root
of the checkout (``build/`` is git-ignored), keyed by a hash of the source,
the compile command and the CPU's feature flags: ``-march=native`` makes
the library host-specific, so a checkout copied to another machine builds
anew. g++ writes a temporary file in that directory, which is renamed into
place, so a process that builds beside another never loads half a library.
A failed build raises ``MediaBuildError``; nothing falls back.
"""

from __future__ import annotations

import hashlib
import os
import platform
import subprocess
import sys
import threading
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "vcd_media.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "media"
LIB_NAME = "libvcd_media.so"

INCLUDE_DIRS = ["/usr/include/x86_64-linux-gnu"]  # FFmpeg's headers (Debian)
LIBS = ["avformat", "avcodec", "avutil", "swscale"]
FLAGS = ["-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC",
         "-std=c++17", "-Wall"]


class MediaBuildError(RuntimeError):
    """The media library could not be built or loaded: FFmpeg's headers or
    libraries (libavformat, libavcodec, libavutil, libswscale) or g++ were
    not found, or the source is missing."""


def _cpu_flags() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return " ".join(sorted(line.split(":", 1)[1].split()))
    except OSError:
        pass
    return platform.processor()


def library_path() -> Path:
    """Where this source, command and CPU's library lives (built or not)."""
    try:
        source = SOURCE.read_bytes()
    except OSError as e:
        raise MediaBuildError(f"media library source missing: {e}") from e
    h = hashlib.sha256(source)
    h.update(" ".join(FLAGS + INCLUDE_DIRS + LIBS).encode())
    h.update(_cpu_flags().encode())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build(verbose: bool = False) -> Path:
    """Compile the library unless it exists; return its path."""
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{LIB_NAME}.tmp{os.getpid()}.{threading.get_ident()}")
    cmd = (["g++"] + FLAGS + [f"-I{d}" for d in INCLUDE_DIRS]
           + [str(SOURCE), "-o", str(tmp)] + [f"-l{name}" for name in LIBS])
    if verbose:
        print(" ".join(cmd))
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise MediaBuildError(f"g++ not found: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise MediaBuildError(
            "libvcd_media build failed; FFmpeg's headers and libraries "
            f"(lib{', lib'.join(LIBS)}) were not found or did not "
            f"compile:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


if __name__ == "__main__":
    print(f"built {build(verbose=True)}")
    sys.exit(0)
