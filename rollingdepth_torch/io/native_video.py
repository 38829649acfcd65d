"""ctypes bindings for the native C++ video decoder/encoder + a prefetching
host->device frame loader.

A copy of ``rollingdepth_tpu/io/native_video.py``: it binds the same C++
library, ``native/rolling_video.cc`` on libavformat/libavcodec/libswscale
(multithreaded decode, aspect-preserving max-edge resize, [-1, 1] float or
uint8 frames, and the codec fallback chain for encoding), built with
``native/Makefile`` at first use, under a file lock, so that processes
starting together never load a half-written library.  Where the build or
the load fails (no ffmpeg development libraries), ``available()`` is False
and ``io/video.py`` decodes with OpenCV instead.  ``PrefetchingFrameLoader`` uploads with
``Tensor.to(device)`` to an explicit torch device.
"""

from __future__ import annotations

import ctypes
import fcntl
import logging
import os
import queue
import subprocess
import threading
from typing import Iterator, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "librolling_video.so")
_lib = None
_lib_tried = False


def _build_library() -> bool:
    """``make`` under an exclusive ``fcntl`` lock on ``native/.build.lock``:
    processes that start together build once, and none of them loads a
    library another is still writing."""
    try:
        with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            subprocess.run(
                ["make", "-C", _NATIVE_DIR], check=True, capture_output=True, timeout=120
            )
        return True
    except Exception as e:  # noqa: BLE001
        logger.debug("native video build failed: %s", e)
        return False


def load_library():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    if os.path.isdir(_NATIVE_DIR):
        _build_library()  # a no-op when the library is built; waits for a build in progress
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as e:
        logger.warning("cannot load native video library: %s", e)
        return None
    lib.rv_decode.restype = ctypes.c_void_p
    lib.rv_decode.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    for name in ("rv_num_frames", "rv_height", "rv_width", "rv_orig_height", "rv_orig_width"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.rv_fps.restype = ctypes.c_double
    lib.rv_fps.argtypes = [ctypes.c_void_p]
    lib.rv_error.restype = ctypes.c_char_p
    lib.rv_error.argtypes = [ctypes.c_void_p]
    lib.rv_copy_frames.restype = None
    lib.rv_copy_frames.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
    lib.rv_copy_frames_u8.restype = None
    lib.rv_copy_frames_u8.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
    lib.rv_free.argtypes = [ctypes.c_void_p]
    lib.rv_probe_fps.restype = ctypes.c_double
    lib.rv_probe_fps.argtypes = [ctypes.c_char_p]
    lib.rv_encoder_open.restype = ctypes.c_void_p
    lib.rv_encoder_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_char_p,
    ]
    lib.rv_encoder_error.restype = ctypes.c_char_p
    lib.rv_encoder_error.argtypes = [ctypes.c_void_p]
    lib.rv_encoder_write.restype = ctypes.c_int
    lib.rv_encoder_write.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
    lib.rv_encoder_close.restype = ctypes.c_int
    lib.rv_encoder_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    return load_library() is not None


def decode_video(
    path, start_frame: int = 0, frame_count: int = 0, max_edge: int = 0,
    dtype: str = "float32",
) -> Tuple[np.ndarray, Tuple[int, int], float]:
    """Decode -> (frames, original (H, W), fps).

    dtype="float32": [N, 3, H, W] in [-1, 1].
    dtype="uint8":   [N, 3, H, W] RGB bytes, 4x smaller for the
    host->device hop; normalization then happens on the device."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native video library unavailable")
    h = lib.rv_decode(str(path).encode(), start_frame, frame_count, max_edge)
    try:
        err = lib.rv_error(h).decode()
        if err:
            raise RuntimeError(f"native decode failed for {path}: {err}")
        n, hh, ww = lib.rv_num_frames(h), lib.rv_height(h), lib.rv_width(h)
        if dtype == "uint8":
            raw = np.empty((n, hh, ww, 3), np.uint8)
            lib.rv_copy_frames_u8(h, raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
            out = np.ascontiguousarray(raw.transpose(0, 3, 1, 2))
        else:
            out = np.empty((n, 3, hh, ww), np.float32)
            lib.rv_copy_frames(h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        orig = (lib.rv_orig_height(h), lib.rv_orig_width(h))
        fps = lib.rv_fps(h)
        return out, orig, fps
    finally:
        lib.rv_free(h)


def encode_video(frames: np.ndarray, path, fps: float = 30.0, codec: str = "") -> None:
    """uint8 [N, H, W, 3] RGB -> video file via the native encoder."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native video library unavailable")
    if frames.dtype != np.uint8 or frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"expected uint8 [n,h,w,3], got {frames.dtype} {frames.shape}")
    n, h, w, _ = frames.shape
    enc = lib.rv_encoder_open(str(path).encode(), w, h, float(fps), codec.encode())
    try:
        err = lib.rv_encoder_error(enc).decode()
        if err:
            raise RuntimeError(f"native encode failed for {path}: {err}")
        frames = np.ascontiguousarray(frames)
        for i in range(n):
            rc = lib.rv_encoder_write(enc, frames[i].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
            if rc != 0:
                raise RuntimeError(f"frame {i} encode failed")
    finally:
        lib.rv_encoder_close(enc)


def probe_fps(path) -> float:
    lib = load_library()
    if lib is None:
        raise RuntimeError("native video library unavailable")
    return float(lib.rv_probe_fps(str(path).encode()))


class PrefetchingFrameLoader:
    """Background decode + host->device transfer pipeline.

    Double-buffered: while the device computes on clip k, the native decoder
    works on clip k+1 on a host thread and the decoded frames, [N, H, W, 3]
    in [-1, 1], are uploaded to ``device`` (``Tensor.to``) ahead of use.
    ``device`` None means the card (``utils/device.py``).
    """

    def __init__(self, paths, max_edge: int = 0, frame_count: int = 0,
                 device=None, depth: int = 2):
        from ..utils.device import resolve_device

        self._paths = list(paths)
        self._max_edge = max_edge
        self._frame_count = frame_count
        self._device = resolve_device(device)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Stop the background worker and release queued clip buffers.

        Without this, an abandoned iterator (early break, error) would leave
        the worker decoding and uploading every remaining clip, then parked
        on the bounded queue pinning up to depth+1 decoded clips in host and
        device memory."""
        self._stop.set()
        try:  # unblock a worker parked on the full queue
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def _worker(self):
        import torch

        for path in self._paths:
            if self._stop.is_set():
                break
            try:
                frames, orig, fps = decode_video(
                    path, 0, self._frame_count, self._max_edge
                )
                arr = torch.from_numpy(np.ascontiguousarray(frames.transpose(0, 2, 3, 1))).to(self._device)
                self._put((path, arr, orig, fps, None))
            except Exception as e:  # noqa: BLE001
                self._put((path, None, None, None, e))
        self._put(None)

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return
            except queue.Full:
                continue

    def __iter__(self) -> Iterator:
        try:
            while True:
                item = self._q.get()
                if item is None:
                    return
                path, arr, orig, fps, err = item
                if err is not None:
                    raise err
                yield path, arr, orig, fps
        finally:
            self.close()
