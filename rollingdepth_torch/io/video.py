"""Host-side video decode and encode.

A copy of ``rollingdepth_tpu/io/video.py`` (no framework in it), with
OpenCV imported inside the functions that use it: the port imports where
``cv2`` is absent, and a function that needs it raises an ImportError that
says so.  Decoding prefers the native C++ decoder (``io/native_video.py``,
multithreaded libavcodec, ``native/rolling_video.cc``) and falls back to
OpenCV:
- ``load_video_frames``: decode, aspect-preserving resize to a max edge,
  [N, 3, H, W] as uint8 or [-1, 1] floats;
- ``write_video_from_numpy``: uint8 [n, h, w, 3] -> mp4 with a codec
  fallback chain (avc1 -> mp4v -> MJPG -> XVID);
- ``get_video_fps``, ``concatenate_videos_horizontally``, ``enumerate_videos``.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

VIDEO_EXTENSIONS = (".mp4", ".avi", ".mov", ".mkv", ".webm", ".m4v")


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "rollingdepth_torch.io.video needs OpenCV (the cv2 module) to decode, resize or encode "
            "video here, and it is not installed"
        ) from e
    return cv2


def _resample_flags(cv2) -> dict:
    return {
        "BILINEAR": cv2.INTER_LINEAR,
        "BICUBIC": cv2.INTER_CUBIC,
        "NEAREST_EXACT": cv2.INTER_NEAREST_EXACT,
        "NEAREST": cv2.INTER_NEAREST,
    }


def resize_max_res(
    img: np.ndarray,  # [H, W, C] uint8 or float
    max_edge_resolution: int,
    resample_method: str = "BILINEAR",
) -> np.ndarray:
    """Aspect-preserving resize so max(H, W) <= max_edge.

    For BILINEAR downscale, INTER_AREA approximates an antialiased resize;
    other methods map to their cv2 equivalents.
    """
    h, w = img.shape[:2]
    scale = min(max_edge_resolution / w, max_edge_resolution / h)
    new_w, new_h = int(w * scale), int(h * scale)
    if (new_w, new_h) == (w, h):
        return img
    cv2 = _cv2()
    if resample_method == "BILINEAR":
        interp = cv2.INTER_AREA if scale < 1.0 else cv2.INTER_LINEAR
    else:
        interp = _resample_flags(cv2).get(resample_method, cv2.INTER_LINEAR)
    return cv2.resize(img, (new_w, new_h), interpolation=interp)


def load_video_frames(
    input_path,
    start_frame: int = 0,
    frame_count: int = 0,
    processing_res: int = 0,
    resample_method: str = "BILINEAR",
    verbose: bool = False,
    dtype: str = "float32",
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Decode frames -> [N, 3, H, W] + original (H, W).

    dtype="float32": [-1, 1] floats.  dtype="uint8": raw bytes, which the
    pipeline normalises on the device.  Prefers the native C++ decoder and
    falls back to OpenCV."""
    assert start_frame >= 0
    path = str(input_path)
    if (
        os.path.splitext(path)[1].lower() in VIDEO_EXTENSIONS
        and resample_method == "BILINEAR"  # native path is bilinear-only
    ):
        from . import native_video

        if native_video.available():
            try:
                frames, orig, _fps = native_video.decode_video(
                    path, start_frame, frame_count, processing_res, dtype=dtype
                )
                return frames, orig
            except RuntimeError as e:
                logger.warning("native decode failed (%s); falling back to OpenCV", e)
    cv2 = _cv2()
    if os.path.splitext(path)[1].lower() in (".png", ".jpg", ".jpeg", ".bmp"):
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise RuntimeError(f"Cannot read image {path}")
        img = img[:, :, ::-1]
        frames_iter = [img]
        original_res = img.shape[:2]
    else:
        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise RuntimeError(f"Cannot open video {path}")
        frames_iter = _cv2_frames(cap)
        original_res = None

    end_before = start_frame + frame_count if frame_count > 0 else float("inf")
    out: List[np.ndarray] = []
    for i, frame in enumerate(frames_iter):
        if i < start_frame:
            continue
        if i >= end_before:
            break
        if original_res is None:
            original_res = frame.shape[:2]
        if processing_res > 0:
            frame = resize_max_res(frame, processing_res, resample_method)
        if dtype == "uint8":
            out.append(np.ascontiguousarray(frame.transpose(2, 0, 1)))
        else:
            f = frame.astype(np.float32) / 255.0 * 2.0 - 1.0
            out.append(f.transpose(2, 0, 1))

    if not out:
        raise RuntimeError(f"No frame is loaded from {path}")
    return np.stack(out), tuple(original_res)  # type: ignore


def _cv2_frames(cap):
    try:
        while True:
            ret, bgr = cap.read()
            if not ret:
                break
            yield bgr[:, :, ::-1]
    finally:
        cap.release()


def write_video_from_numpy(
    frames: np.ndarray,  # [n, h, w, 3] uint8 RGB
    output_path,
    fps: float = 30,
    codec: Optional[str] = None,
    crf: int = 23,  # accepted for API parity (cv2 has no crf control)
    preset: str = "medium",
    verbose: bool = False,
) -> None:
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"Expected shape [n, height, width, 3], got {frames.shape}")
    if frames.dtype != np.uint8:
        raise ValueError(f"Expected dtype uint8, got {frames.dtype}")
    from . import native_video

    if native_video.available():
        try:
            native_video.encode_video(frames, output_path, fps=fps, codec=codec or "")
            return
        except RuntimeError as e:
            logger.warning("native encode failed (%s); falling back to OpenCV", e)
    cv2 = _cv2()
    n, h, w, _ = frames.shape
    codecs = [codec] if codec else ["avc1", "mp4v", "MJPG", "XVID"]
    writer = None
    for c in codecs:
        writer = cv2.VideoWriter(str(output_path), cv2.VideoWriter_fourcc(*c), fps, (w, h))
        if writer.isOpened():
            if verbose:
                logger.info("Using codec: %s", c)
            break
        writer.release()
        writer = None
    if writer is None:
        raise ValueError(f"No working codec found. Tried: {codecs}")
    try:
        for i in range(n):
            writer.write(frames[i][:, :, ::-1])  # RGB -> BGR
    finally:
        writer.release()


def get_video_fps(video_path) -> float:
    from . import native_video

    if native_video.available():
        try:
            fps = native_video.probe_fps(video_path)
            if fps > 0:
                return fps
        except RuntimeError:
            pass
    cv2 = _cv2()
    cap = cv2.VideoCapture(str(video_path))
    fps = cap.get(cv2.CAP_PROP_FPS)
    cap.release()
    return float(fps)


def concatenate_videos_horizontally(
    video1: np.ndarray,  # [N, 3, H, W]
    video2: np.ndarray,
    gap: int = 0,
    gap_color: Optional[Sequence[int]] = None,
) -> np.ndarray:
    """Side-by-side compositing: video2 is resized to video1's spatial size
    and concatenated along width."""
    cv2 = _cv2()
    n, c, h1, w1 = video1.shape
    v2 = np.stack(
        [
            cv2.resize(f.transpose(1, 2, 0), (w1, h1), interpolation=cv2.INTER_AREA).transpose(2, 0, 1)
            for f in video2
        ]
    )
    parts = [video1]
    if gap > 0:
        color = np.asarray(gap_color if gap_color is not None else [0, 0, 0])
        gap_block = np.ones((n, c, h1, gap), dtype=video1.dtype) * color.reshape(1, 3, 1, 1)
        parts.append(gap_block.astype(video1.dtype))
    parts.append(v2)
    return np.concatenate(parts, axis=3)


def enumerate_videos(input_path) -> List[str]:
    """CLI input expansion: file | .txt list | directory."""
    path = str(input_path)
    if os.path.isdir(path):
        out = [
            os.path.join(path, f)
            for f in sorted(os.listdir(path))
            if f.lower().endswith(VIDEO_EXTENSIONS)
        ]
        if not out:
            raise ValueError(f"No video found in {path}")
        return out
    if path.endswith(".txt"):
        with open(path) as f:
            return [line.strip() for line in f if line.strip()]
    return [path]
