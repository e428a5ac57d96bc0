"""Frame-directory and video-file I/O (a copy of the JAX package's
``media/video_io.py``): read sorted frames from a directory as RGB uint8,
write frames + optional mp4, decode a video file (OpenCV, imported at
use)."""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def list_frames(frames_dir) -> List[Path]:
    frames_dir = Path(frames_dir)
    paths = sorted(p for p in frames_dir.glob("*") if p.suffix.lower() in _IMAGE_EXTS)
    if not paths:
        raise FileNotFoundError(f"No frames found in {frames_dir}")
    return paths


def read_frame(path, size_hw: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """One frame -> RGB uint8 [H, W, 3]; bilinear resize if size given."""
    import cv2

    img = cv2.imread(str(path))
    if img is None:
        raise RuntimeError(f"Failed to read {path}")
    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if size_hw is not None and img.shape[:2] != tuple(size_hw):
        H, W = size_hw
        img = cv2.resize(img, (W, H), interpolation=cv2.INTER_LINEAR)
    return img


def load_frames_dir(
    frames_dir, size_hw: Optional[Tuple[int, int]] = None
) -> np.ndarray:
    """All frames in a dir -> [T, H, W, 3] uint8."""
    return np.stack([read_frame(p, size_hw) for p in list_frames(frames_dir)], axis=0)


def write_frames(
    frames_uint8: np.ndarray, out_dir, mp4_path=None, fps: int = 16
) -> None:
    """frames [T, H, W, 3] RGB uint8 -> frame_%06d.jpg files (+ optional mp4)."""
    import cv2

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    T, H, W, _ = frames_uint8.shape
    for t in range(T):
        cv2.imwrite(
            str(out_dir / f"frame_{t:06d}.jpg"),
            cv2.cvtColor(frames_uint8[t], cv2.COLOR_RGB2BGR),
        )
    if mp4_path:
        Path(mp4_path).parent.mkdir(parents=True, exist_ok=True)
        vw = cv2.VideoWriter(
            str(mp4_path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (W, H)
        )
        for t in range(T):
            vw.write(cv2.cvtColor(frames_uint8[t], cv2.COLOR_RGB2BGR))
        vw.release()


def read_video_file(path, size_hw: Optional[Tuple[int, int]] = None) -> Tuple[np.ndarray, float]:
    """Decode a video file -> ([T, H, W, 3] uint8 RGB, src_fps)."""
    import cv2

    cap = cv2.VideoCapture(str(path))
    if not cap.isOpened():
        raise RuntimeError(f"Failed to open video {path}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 0.0
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        if size_hw is not None and frame.shape[:2] != tuple(size_hw):
            H, W = size_hw
            frame = cv2.resize(frame, (W, H), interpolation=cv2.INTER_LINEAR)
        frames.append(frame)
    cap.release()
    if not frames:
        raise RuntimeError(f"No frames decoded from {path}")
    return np.stack(frames, axis=0), float(fps)
