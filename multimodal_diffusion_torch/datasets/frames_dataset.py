"""Video-only frames dataset (host-side numpy; counterpart of the JAX
package's ``datasets/frames_dataset.py``).

Iterates frame-clip directories (as ``scripts/extract_frames.py`` writes
them) without paired audio, from a manifest or a directory of ``clip_*``
subdirectories. Items are {"video": [3, T, H, W] float32 in [0, 1] (uint8
[T, H, W, 3] under ``device_preprocess``), "audio": None}, so they flow
through the same collate (missing-modality masks) as AV items. Frames decode
through the native loader when it is available, else through PIL.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

from .av_manifest import AVManifestDataset


class FramesDataset(AVManifestDataset):
    def __init__(
        self,
        source,  # manifest json OR a directory containing clip_* subdirs
        clip_seconds: float = 3.0,
        fps: int = 16,
        size_hw: Tuple[int, int] = (128, 128),
        channels: int = 3,
        **_ignored,
    ):
        src = Path(source)
        if src.is_dir():
            clip_dirs = sorted(p for p in src.iterdir()
                               if p.is_dir() and list(p.glob("frame_*.*")))
            if not clip_dirs:
                # maybe a root of per-video dirs with clips/ inside
                clip_dirs = sorted(src.glob("**/clip_*"))
            self.items = [{"video_frames_dir": str(p), "audio_wav_path": ""}
                          for p in clip_dirs]
            self.clip_seconds = float(clip_seconds)
            self.fps = int(fps)
            self.sr = 16000
            self.size_hw = (int(size_hw[0]), int(size_hw[1]))
            self.channels = int(channels)
            self.manifest_path = src
            self.T = int(round(self.fps * self.clip_seconds))
            self.L = 0
            self.device_preprocess = bool(_ignored.get("device_preprocess", False))
            from . import native_loader

            self._native = native_loader if native_loader.available() else None
        else:
            super().__init__(src, clip_seconds, fps, 16000, size_hw, channels)
        if not self.items:
            raise FileNotFoundError(f"no frame clips under {source}")

    def __getitem__(self, idx: int) -> Dict:
        item = self.items[idx]
        return {
            "video": self._load_frames(Path(item["video_frames_dir"])),
            "audio": None,
            "fps": self.fps,
            "video_frames_dir": item["video_frames_dir"],
        }
