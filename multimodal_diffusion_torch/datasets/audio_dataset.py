"""Audio-only waveform dataset (host-side numpy; counterpart of the JAX
package's ``datasets/audio_dataset.py``).

Iterates a directory tree of audio files (or a manifest) and returns
fixed-length mono clips {"video": None, "audio": [1, L] float32}, compatible
with the shared collate's missing-modality masks. Reads through the port's
``media/audio_io.read_wav`` (resampled to ``sr``, cropped or zero-padded to
``clip_seconds``).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

import numpy as np

from ..media.audio_io import read_wav

AUDIO_EXTS = {".wav", ".flac", ".ogg"}


class AudioDataset:
    def __init__(
        self,
        source,  # manifest json with {"clips": [{audio_wav_path}]} OR a dir
        clip_seconds: float = 3.0,
        sr: int = 16000,
        hop_seconds: float | None = None,
        **_ignored,
    ):
        self.sr = int(sr)
        self.clip_seconds = float(clip_seconds)
        self.L = int(round(self.sr * self.clip_seconds))
        src = Path(source)
        if src.is_dir():
            self.paths: List[Path] = sorted(
                p for p in src.rglob("*") if p.suffix.lower() in AUDIO_EXTS)
        else:
            clips = json.loads(src.read_text())["clips"]
            self.paths = [Path(c["audio_wav_path"]) for c in clips]
        if not self.paths:
            raise FileNotFoundError(f"no audio under {source}")

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int) -> Dict:
        y, _ = read_wav(self.paths[idx], sr=self.sr, mono=True)
        if y.shape[0] < self.L:
            y = np.concatenate([y, np.zeros(self.L - y.shape[0], np.float32)])
        else:
            y = y[: self.L]
        return {
            "video": None,
            "audio": y.reshape(1, -1),
            "sr": self.sr,
            "audio_wav_path": str(self.paths[idx]),
        }
