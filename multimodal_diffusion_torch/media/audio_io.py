"""WAV read/write and polyphase resampling for the sampling CLI (a copy of
the JAX package's ``media/audio_io.py`` wav helpers; scipy, no librosa)."""

from __future__ import annotations

import math
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


# ---------------------------------------------------------------------------
# wav read / write
# ---------------------------------------------------------------------------


def read_wav(path, sr: Optional[int] = None, mono: bool = True) -> Tuple[np.ndarray, int]:
    """Read a WAV; returns (float32 waveform in [-1, 1], sample_rate).

    If `sr` is given and differs from the file rate, resamples (polyphase).
    Multi-channel is averaged to mono when mono=True (librosa.load parity).
    """
    file_sr, data = wavfile.read(str(path))
    if data.dtype == np.int16:
        y = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        y = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        y = (data.astype(np.float32) - 128.0) / 128.0
    else:
        y = data.astype(np.float32)
    if y.ndim == 2 and mono:
        y = y.mean(axis=1)
    if sr is not None and int(file_sr) != int(sr):
        y = resample(y, int(file_sr), int(sr))
        file_sr = int(sr)
    return np.ascontiguousarray(y, dtype=np.float32), int(file_sr)


def write_wav(path, wav: np.ndarray, sr: int) -> None:
    """Write float32 [-1, 1] (or int16) to a 16-bit PCM WAV."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    wav = np.asarray(wav)
    if wav.dtype != np.int16:
        wav = np.clip(wav, -1.0, 1.0)
        wav = (wav * 32767.0).astype(np.int16)
    wavfile.write(str(path), int(sr), wav)


def resample(y: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase rational resampling."""
    if orig_sr == target_sr:
        return y.astype(np.float32)
    g = math.gcd(int(orig_sr), int(target_sr))
    return resample_poly(y, target_sr // g, orig_sr // g).astype(np.float32)
