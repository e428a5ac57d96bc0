"""Manifest-driven AV clip dataset (host-side numpy; counterpart of the JAX
package's ``datasets/av_manifest.py``).

Parity with the reference `avdiff/datasets/av_manifest.py`:
  * manifest schema {"clips": [{video_frames_dir, audio_wav_path, fps, sr,
    clip_seconds}]} (av_manifest.py:27-49)
  * frames: <=T sorted `frame_*.*` files, bilinear resize to (H, W),
    repeat-last-frame pad, [3, T, H, W] float32 in [0,1] (87-108)
  * audio: WAV -> mono -> resample to sr -> crop / zero-pad to L,
    [1, L] float32 (110-128)
  * AVClipsDataset root-prefix path resolution (149-193)

Frames decode through the native loader (``datasets/native_loader.py``)
when it builds and loads, else through PIL; which one is printed once per
dataset. PIL and the native library are imported only here and only when a
dataset is opened, so the records path needs neither.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..media.audio_io import read_wav, resample


class AVManifestDataset:
    def __init__(
        self,
        manifest_path,
        clip_seconds: float = 3.0,
        fps: int = 16,
        sr: int = 16000,
        size_hw: Tuple[int, int] = (128, 128),
        channels: int = 3,
        use_native: bool = True,
        device_preprocess: bool = False,
    ):
        # device_preprocess: ship uint8 [T, H, W, 3] frames (4x fewer
        # host->device bytes); the train step casts, normalizes and
        # transposes on the device
        self.device_preprocess = bool(device_preprocess)
        self.manifest_path = Path(manifest_path)
        self.clip_seconds = float(clip_seconds)
        self.fps = int(fps)
        self.sr = int(sr)
        self.size_hw = (int(size_hw[0]), int(size_hw[1]))
        self.channels = int(channels)
        with open(self.manifest_path, "r") as f:
            self.items: List[Dict] = json.load(f)["clips"]
        self.T = int(round(self.fps * self.clip_seconds))
        self.L = int(round(self.sr * self.clip_seconds))
        # native C++ fast path (JPEG decode + resize + normalize + layout in
        # one call, threaded across frames) with automatic fallback
        self._native = None
        if use_native:
            try:
                from . import native_loader

                if native_loader.available():
                    self._native = native_loader
            except Exception:
                self._native = None
        decoder = "native (native/avloader.cpp)" if self._native is not None else "PIL"
        print(f"[av_manifest] {self.manifest_path.name}: {len(self.items)} clips; "
              f"frames decoded by {decoder}", flush=True)

    def __len__(self) -> int:
        return len(self.items)

    # ------------------------------------------------------------------

    @staticmethod
    def _sorted_frames(dir_path: Path) -> List[Path]:
        frames = sorted(dir_path.glob("frame_*.*"))
        if not frames:
            raise FileNotFoundError(f"No frames found under {dir_path}")
        return frames

    def _load_frames(self, frames_dir: Path) -> np.ndarray:
        H, W = self.size_hw
        frames = self._sorted_frames(frames_dir)
        pick = frames[: min(len(frames), self.T)]
        if len(pick) < self.T:
            pick = pick + [frames[-1]] * (self.T - len(pick))
        native_ok = self._native is not None and all(
            p.suffix.lower() in (".jpg", ".jpeg") for p in pick
        )
        if native_ok:
            try:
                if self.device_preprocess:
                    return self._native.decode_clip_u8(pick, H, W)
                return self._native.decode_clip(pick, H, W)
            except Exception:
                pass  # fall through to the PIL path
        from PIL import Image

        imgs = []
        for p in pick:
            im = Image.open(p).convert("RGB")
            if im.size != (W, H):
                im = im.resize((W, H), Image.BILINEAR)
            imgs.append(np.asarray(im, dtype=np.uint8))
        arr = np.stack(imgs, axis=0)  # [T, H, W, 3] uint8
        if self.device_preprocess:
            return arr
        arr = arr.astype(np.float32) / 255.0
        return np.transpose(arr, (3, 0, 1, 2))  # [3,T,H,W]

    def _load_wav(self, wav_path: Path) -> np.ndarray:
        y = None
        if self._native is not None and wav_path.suffix.lower() == ".wav":
            try:
                y_native, src_sr = self._native.read_wav_mono(wav_path)
                y = y_native if src_sr == self.sr else resample(y_native, src_sr, self.sr)
            except Exception:
                y = None
        if y is None:
            y, _ = read_wav(wav_path, sr=self.sr, mono=True)
        if y.shape[0] < self.L:
            y = np.concatenate([y, np.zeros(self.L - y.shape[0], np.float32)])
        elif y.shape[0] > self.L:
            y = y[: self.L]
        return y.reshape(1, -1)

    # ------------------------------------------------------------------

    def __getitem__(self, idx: int) -> Dict:
        item = self.items[idx]
        vdir = Path(item["video_frames_dir"])
        apath = Path(item["audio_wav_path"])
        return {
            "video": self._load_frames(vdir),
            "audio": self._load_wav(apath),
            "fps": self.fps,
            "sr": self.sr,
            "video_frames_dir": str(vdir),
            "audio_wav_path": str(apath),
        }


class AVClipsDataset(AVManifestDataset):
    """Root-prefix path resolution wrapper (reference av_manifest.py:149-193);
    swallows unexpected kwargs for config compatibility."""

    def __init__(
        self,
        manifest_path,
        clip_seconds: float = 3.0,
        fps: int = 16,
        sr: int = 16000,
        size_hw: Tuple[int, int] = (128, 128),
        channels: int = 3,
        video_root: Optional[str] = None,
        audio_root: Optional[str] = None,
        use_native: bool = True,
        device_preprocess: bool = False,
        **_ignored,
    ):
        super().__init__(manifest_path, clip_seconds, fps, sr, size_hw,
                         channels, use_native=use_native,
                         device_preprocess=device_preprocess)
        video_root = Path(video_root) if video_root else None
        audio_root = Path(audio_root) if audio_root else None
        for it in self.items:
            vdir = Path(it["video_frames_dir"])
            apath = Path(it["audio_wav_path"])
            if not vdir.exists() and video_root is not None:
                cand = video_root / vdir
                if cand.exists():
                    it["video_frames_dir"] = str(cand)
            if not apath.exists() and audio_root is not None:
                cand = audio_root / apath
                if cand.exists():
                    it["audio_wav_path"] = str(cand)
