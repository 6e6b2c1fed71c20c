"""ctypes bindings of the port's media library (``media/csrc``): probe,
random-access decode, batch decode and encode.

Counterpart of ``vision_collision_detection_tpu/media/decoder.py``, with the
same C signatures and the same frames:

    probe(path)                          → VideoInfo
    decode_frames(path, indices, ...)    → uint8 [N, H, W, 3], EOF-padded with
                                           the last decoded frame
    decode_batch(paths, indices, ...)    → uint8 [B, T, h, w, 3], ok [B]
    encode_video(path, frames, fps)      → MP4 writer (and ``VideoWriter``)

The library is built and loaded at the first call, never at import
(``media/build.py``); if it cannot be, ``MediaBuildError`` says so. That is
not a ``MediaError``: a clip that does not decode is a ``MediaError``, a
decoder that does not exist is not a broken clip. ctypes calls release the
GIL, so threads decode in parallel.

One change from the JAX package: ``decode_frames`` with ``target_size=None``
decodes at full size whatever ``lowres`` asks (there is no canvas that a
reduced frame could be shown to cover, and the buffer is sized from the
probe); the JAX package filled that buffer with reduced frames.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import threading
from typing import Sequence

import numpy as np

from vision_collision_detection_tpu_torch.media import build as _build
from vision_collision_detection_tpu_torch.media.build import MediaBuildError


class _Probe(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_int),
        ("height", ctypes.c_int),
        ("fps", ctypes.c_double),
        ("num_frames", ctypes.c_long),
        ("duration", ctypes.c_double),
    ]


_lib = None
_lib_lock = threading.Lock()


def _get_lib():
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                path = _build.build()
                try:
                    lib = ctypes.CDLL(str(path))
                except OSError as e:
                    raise MediaBuildError(
                        f"cannot load {path} (FFmpeg's shared libraries "
                        f"missing?): {e}") from e
                lib.vcd_probe.argtypes = [ctypes.c_char_p, ctypes.POINTER(_Probe)]
                lib.vcd_probe.restype = ctypes.c_int
                lib.vcd_decode3.argtypes = [
                    ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_long),
                    ctypes.c_long,
                    ctypes.c_int,
                    ctypes.c_int,
                    ctypes.c_int,
                    ctypes.c_int,  # fast_resize: -1 global / 0 / 1
                    ctypes.c_int,  # lowres: -1 global / 0..3 (clamped in C)
                    ctypes.POINTER(ctypes.c_ubyte),
                ]
                lib.vcd_decode3.restype = ctypes.c_long
                lib.vcd_decode_batch3.argtypes = [
                    ctypes.POINTER(ctypes.c_char_p),
                    ctypes.c_long,
                    ctypes.POINTER(ctypes.c_long),
                    ctypes.c_long,
                    ctypes.c_int,
                    ctypes.c_int,
                    ctypes.c_int,
                    ctypes.c_int,  # fast_resize: -1 global / 0 / 1
                    ctypes.c_int,  # lowres: -1 global / 0..3 (clamped in C)
                    ctypes.c_int,
                    ctypes.POINTER(ctypes.c_ubyte),
                    ctypes.POINTER(ctypes.c_long),
                ]
                lib.vcd_decode_batch3.restype = ctypes.c_long
                lib.vcd_encode.argtypes = [
                    ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_ubyte),
                    ctypes.c_long,
                    ctypes.c_int,
                    ctypes.c_int,
                    ctypes.c_double,
                ]
                lib.vcd_encode.restype = ctypes.c_int
                lib.vcd_encode_open.argtypes = [
                    ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_double,
                ]
                lib.vcd_encode_open.restype = ctypes.c_void_p
                lib.vcd_encode_open2.argtypes = [
                    ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_double, ctypes.c_char_p, ctypes.c_int,
                    ctypes.c_int, ctypes.c_double, ctypes.c_char_p,
                ]
                lib.vcd_encode_open2.restype = ctypes.c_void_p
                lib.vcd_set_skip_unneeded.argtypes = [ctypes.c_int]
                lib.vcd_set_fast_resize.argtypes = [ctypes.c_int]
                lib.vcd_get_fast_resize.restype = ctypes.c_int
                lib.vcd_set_lowres.argtypes = [ctypes.c_int]
                lib.vcd_get_lowres.restype = ctypes.c_int
                lib.vcd_set_fast_decode.argtypes = [ctypes.c_int]
                lib.vcd_get_fast_decode.restype = ctypes.c_int
                lib.vcd_encode_append.argtypes = [
                    ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte),
                    ctypes.c_long,
                ]
                lib.vcd_encode_append.restype = ctypes.c_int
                lib.vcd_encode_close.argtypes = [ctypes.c_void_p]
                lib.vcd_encode_close.restype = ctypes.c_int
                lib.vcd_last_error.restype = ctypes.c_char_p
                lib.vcd_profile_enable.argtypes = [ctypes.c_int]
                lib.vcd_profile_reset.argtypes = []
                lib.vcd_profile_get.argtypes = [
                    ctypes.POINTER(ctypes.c_longlong),
                    ctypes.c_int,
                ]
                lib.vcd_set_log_level.argtypes = [ctypes.c_int]
                # Default libav to errors-only: x264 prints a ~20-line
                # info banner per encoder open, which would drown
                # training logs. VCD_AV_LOG overrides (e.g. 32=info).
                lib.vcd_set_log_level(int(os.environ.get("VCD_AV_LOG", 16)))
                _lib = lib
    return _lib


class MediaError(RuntimeError):
    pass


def _last_error() -> str:
    return _get_lib().vcd_last_error().decode(errors="replace")


@dataclasses.dataclass(frozen=True)
class VideoInfo:
    width: int
    height: int
    fps: float
    num_frames: int
    duration: float


def probe(path: str) -> VideoInfo:
    lib = _get_lib()
    info = _Probe()
    if lib.vcd_probe(path.encode(), ctypes.byref(info)) != 0:
        raise MediaError(f"probe failed: {_last_error()}")
    return VideoInfo(
        width=info.width, height=info.height, fps=info.fps,
        num_frames=int(info.num_frames), duration=info.duration,
    )


def decode_frames(
    path: str,
    indices: Sequence[int],
    target_size=None,
    letterbox: bool = True,
    pad_to_count: bool = True,
    fast_resize: bool | None = None,
    lowres: int | None = None,
) -> np.ndarray:
    """Decode `indices` (ascending) → uint8 [len(indices), H, W, 3].

    ``target_size`` may be an int (square) or an ``(h, w)`` tuple; with
    letterbox=True, frames come back aspect-preserving-scaled with centered
    black padding inside that canvas on the host (swscale), so the device
    sees fixed shapes. A rectangular canvas matching the content aspect lets
    callers ship only content rows and pad to square on-device (transfer
    optimization). Frames past EOF are padded with the last decoded frame;
    raises MediaError if nothing decodes.

    ``fast_resize`` is passed PER CALL into the C library (None → the
    process-global default set by :func:`set_fast_resize`), so concurrent
    decodes with different modes are thread-safe — no global toggling.

    ``lowres`` (None → process-global default, else 0..3) requests
    reduced-resolution decode at 1/2^k size; the C side clamps it per clip
    to the codec's capability (H.264 → 0, i.e. a transparent full-res
    fallback) and so the decoded frame always still covers the letterbox
    content box (the resample never upscales). With ``target_size=None`` it
    is 0. See :func:`set_lowres`.
    """
    lib = _get_lib()
    idx = np.ascontiguousarray(np.asarray(indices, dtype=np.int64))
    n = len(idx)
    if n == 0:
        raise ValueError("empty indices")
    if target_size is not None:
        if isinstance(target_size, (tuple, list)):
            h, w = int(target_size[0]), int(target_size[1])
        else:
            h = w = int(target_size)
    else:
        info = probe(path)
        h, w = info.height, info.width
        letterbox = False
        lowres = 0  # full-size frames fill a buffer of the probed size
    out = np.empty((n, h, w, 3), dtype=np.uint8)
    got = lib.vcd_decode3(
        path.encode(),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        n,
        w if target_size is not None else 0,
        h if target_size is not None else 0,
        1 if letterbox else 0,
        -1 if fast_resize is None else (1 if fast_resize else 0),
        -1 if lowres is None else int(lowres),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
    )
    if got < 0:
        raise MediaError(f"decode failed for {path}: {_last_error()}")
    if got == 0:
        raise MediaError(f"no frames decoded from {path}")
    if got < n:
        if not pad_to_count:
            return out[:got]
        out[got:] = out[got - 1]  # reference pad-with-last-frame policy
    return out


def decode_batch(
    paths: Sequence[str],
    indices: np.ndarray,
    target_size,
    letterbox: bool = True,
    num_threads: int = 0,
    fast_resize: bool | None = None,
    lowres: int | None = None,
):
    """Decode a whole batch natively: the C++ thread pool fills one
    contiguous uint8 buffer with zero Python in the loop.

    indices: int64 [B, T] (ascending per row). target_size: int or (h, w).
    → (frames uint8 [B, T, h, w, 3], ok bool [B]); failed clips are zeroed
    with ok=False (the zero-fallback policy applied natively).
    ``fast_resize`` and ``lowres`` are per-call (None → process-global
    defaults), thread-safe under concurrent batches with different modes.
    """
    lib = _get_lib()
    idx = np.ascontiguousarray(np.asarray(indices, dtype=np.int64))
    if idx.ndim != 2:
        raise ValueError(f"indices must be [B, T], got {idx.shape}")
    b, t = idx.shape
    if len(paths) != b:
        raise ValueError("paths/indices length mismatch")
    if isinstance(target_size, (tuple, list)):
        h, w = int(target_size[0]), int(target_size[1])
    else:
        h = w = int(target_size)
    out = np.empty((b, t, h, w, 3), dtype=np.uint8)
    written = np.empty((b,), dtype=np.int64)
    c_paths = (ctypes.c_char_p * b)(*[p.encode() for p in paths])
    rc = lib.vcd_decode_batch3(
        c_paths, b,
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), t,
        w, h, 1 if letterbox else 0,
        -1 if fast_resize is None else (1 if fast_resize else 0),
        -1 if lowres is None else int(lowres),
        int(num_threads),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        written.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
    )
    if rc != 0:
        raise MediaError(f"batch decode failed: {_last_error()}")
    return out, written > 0


def profile_decode(enable: bool = True) -> None:
    """Toggle the C library's decode-stage profiler (thread-safe ns
    accumulators over the hot path; ~zero overhead when off)."""
    lib = _get_lib()
    if enable:
        lib.vcd_profile_reset()
    lib.vcd_profile_enable(1 if enable else 0)


def decode_profile() -> dict:
    """Read the accumulated per-stage decode costs since the last
    ``profile_decode(True)``.

    Returns seconds per stage — demux+libav decode, swscale YUV→RGB,
    AA resize, copy/pad — plus frame/seek counts."""
    lib = _get_lib()
    buf = (ctypes.c_longlong * 10)()
    lib.vcd_profile_get(buf, 10)
    return {
        "decode_s": buf[0] / 1e9,
        "yuv_to_rgb_s": buf[1] / 1e9,
        "resize_s": buf[2] / 1e9,
        "copy_pad_s": buf[3] / 1e9,
        "open_s": buf[4] / 1e9,
        "frames_decoded": int(buf[5]),
        "frames_converted": int(buf[6]),
        "seeks": int(buf[7]),
        "frames_skipped_by_seek": int(buf[8]),
        "frames_skipped_nonref": int(buf[9]),
    }


def set_skip_unneeded(on: bool) -> None:
    """Toggle decode-side dropping of unneeded NON-REFERENCE frames (on by
    default). Frames returned to the caller are bit-identical either way —
    only disposable frames outside the wanted index set are dropped; the
    toggle exists for tests and A/B decode-cost measurement."""
    _get_lib().vcd_set_skip_unneeded(1 if on else 0)


def set_fast_resize(on: bool) -> None:
    """Set the process-global DEFAULT for the planar-YUV fast resize path
    (off by default). Kept as a test/diagnostic hook only — callers such
    as the datasets pass ``fast_resize`` per call into
    decode_frames/decode_batch, which overrides this default and is
    thread-safe under concurrent decodes with different modes.

    When on, 4:2:0 frames are AA-resampled plane-by-plane at decoded
    resolution (chroma straight from its half-res plane) and converted
    YUV→RGB once at target resolution — ~2× cheaper per converted frame
    than the exact convert-then-resize path, at the cost of exact
    bit-parity with torchvision's resize (the difference is chroma
    interpolation order + one dropped uint8 quantization). Non-4:2:0
    frames and portrait-bar letterboxing fall back to the exact path
    automatically."""
    _get_lib().vcd_set_fast_resize(1 if on else 0)


def get_fast_resize() -> bool:
    return bool(_get_lib().vcd_get_fast_resize())


def set_lowres(level: int) -> None:
    """Set the process-global DEFAULT reduced-resolution decode level (0 =
    full resolution, the default). Kept as a test/diagnostic hook only —
    production callers pass ``lowres`` per call into
    decode_frames/decode_batch, which overrides this default and is
    thread-safe under concurrent decodes with different levels.

    Level k asks libavcodec to decode mpeg4/mjpeg/mpeg2 streams directly at
    1/2^k resolution (the IDCT runs on a cropped coefficient block) — a
    large cut to the dominant libavcodec share of decode cost when the
    model input (224 px) sits far below source resolution (720p+). The C
    side clamps the level per clip to the codec's capability (H.264 → 0,
    a transparent full-res fallback) and to the largest level whose decoded
    frame still covers the letterbox content box, so the AA resample always
    downsamples. NOT bit-exact vs full-res decode (the DCT-domain crop is a
    different low-pass than the AA triangle filter)."""
    _get_lib().vcd_set_lowres(int(level))


def get_lowres() -> int:
    return int(_get_lib().vcd_get_lowres())


def set_fast_decode(on: bool) -> None:
    """Toggle ``AV_CODEC_FLAG2_FAST`` on subsequently opened decoders (off
    by default). The flag permits non-spec-compliant codec speedups; it is
    an A/B knob. Applies per decoder open, so in-flight decodes are
    unaffected."""
    _get_lib().vcd_set_fast_decode(1 if on else 0)


def get_fast_decode() -> bool:
    return bool(_get_lib().vcd_get_fast_decode())


def encode_video(path: str, frames: np.ndarray, fps: float = 10.0,
                 codec: str = "mpeg4", gop: int = 12,
                 bframes: int | None = None, crf: float | None = None,
                 preset: str | None = None) -> None:
    """frames uint8 [N, H, W, 3] → MP4 (yuv420p).

    Default codec is mpeg4 (bit-rate mode, no B-frames — the cheap synthetic
    fixture path). ``codec="libx264"`` with ``bframes``/``crf``/``preset``
    produces dashcam-representative H.264 with disposable B-frames that the
    decoder's non-ref skip can drop for sparse sampling."""
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"expected [N,H,W,3] uint8, got {frames.shape}")
    n, h, w, _ = frames.shape
    with VideoWriter(path, w=w, h=h, fps=fps, codec=codec, gop=gop,
                     bframes=bframes, crf=crf, preset=preset) as vw:
        vw.append(frames)


class VideoWriter:
    """Streaming MP4 writer: append frame chunks with bounded memory
    (arbitrarily long videos — the one-shot ``encode_video`` needs the
    whole array resident). Context-manager friendly:

        with VideoWriter(path, w=1280, h=720, fps=10.0) as vw:
            for chunk in frame_chunks:   # uint8 [n, H, W, 3]
                vw.append(chunk)
    """

    def __init__(self, path: str, w: int, h: int, fps: float = 10.0,
                 codec: str = "mpeg4", gop: int = 12,
                 bframes: int | None = None, crf: float | None = None,
                 preset: str | None = None):
        self._lib = _get_lib()
        self._handle = self._lib.vcd_encode_open2(
            path.encode(), int(w), int(h), float(fps), codec.encode(),
            int(gop), -1 if bframes is None else int(bframes),
            -1.0 if crf is None else float(crf),
            preset.encode() if preset else None)
        if not self._handle:
            raise MediaError(f"encoder open failed for {path}: "
                             f"{_last_error()}")
        self.path = path
        self.w, self.h = int(w), int(h)
        self.frames_written = 0

    def append(self, frames: np.ndarray) -> None:
        if self._handle is None:
            raise MediaError("writer already closed")
        frames = np.ascontiguousarray(frames, dtype=np.uint8)
        if frames.ndim == 3:
            frames = frames[None]
        if frames.shape[1:] != (self.h, self.w, 3):
            raise ValueError(
                f"expected [n,{self.h},{self.w},3], got {frames.shape}")
        rc = self._lib.vcd_encode_append(
            self._handle,
            frames.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            frames.shape[0],
        )
        if rc != 0:
            raise MediaError(f"encode append failed: {_last_error()}")
        self.frames_written += frames.shape[0]

    def close(self) -> None:
        if self._handle is not None:
            rc = self._lib.vcd_encode_close(self._handle)
            self._handle = None
            if rc != 0:
                raise MediaError(f"encoder close failed: {_last_error()}")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
