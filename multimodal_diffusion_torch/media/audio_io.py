"""Audio I/O and DSP without librosa or soundfile (a copy of the JAX
package's ``media/audio_io.py``; numpy and scipy):

  * WAV read/write via scipy.io.wavfile (int16/int24->float32 normalization,
    stereo->mono averaging like librosa.load(mono=True))
  * polyphase resampling via scipy.signal.resample_poly
  * STFT magnitude, mel filterbank (Slaney-style), log-mel and MFCC (DCT-II
    orthonormal) for the eval metrics (``eval/``); inverse STFT,
    Griffin-Lim, the inverse mel projection and RMS loudness normalization
"""

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


# ---------------------------------------------------------------------------
# spectral features (numpy)
# ---------------------------------------------------------------------------


def stft_mag(
    y: np.ndarray, n_fft: int = 1024, hop: int = 256, win: Optional[np.ndarray] = None
) -> np.ndarray:
    """Magnitude STFT [freqs, frames] with centered Hann framing."""
    if win is None:
        win = np.hanning(n_fft).astype(np.float32)
    pad = n_fft // 2
    y = np.pad(y.astype(np.float32), (pad, pad), mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = y[idx] * win[None, :]
    return np.abs(np.fft.rfft(frames, axis=1)).T.astype(np.float32)


def hz_to_mel(f: np.ndarray | float) -> np.ndarray:
    """Slaney mel scale (librosa default, htk=False)."""
    f = np.asarray(f, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels
    )


def mel_to_hz(m: np.ndarray | float) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_filterbank(
    sr: int, n_fft: int, n_mels: int = 80, fmin: float = 0.0, fmax: Optional[float] = None
) -> np.ndarray:
    """Triangular mel filterbank [n_mels, n_fft//2+1] with Slaney norm."""
    fmax = fmax if fmax is not None else sr / 2.0
    fft_freqs = np.linspace(0, sr / 2.0, n_fft // 2 + 1)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    fb = np.zeros((n_mels, len(fft_freqs)), dtype=np.float32)
    for i in range(n_mels):
        lo, ctr, hi = hz_pts[i], hz_pts[i + 1], hz_pts[i + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-10)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
        enorm = 2.0 / (hi - lo)  # Slaney area normalization
        fb[i] *= enorm
    return fb


def logmel(
    y: np.ndarray,
    sr: int,
    n_fft: int = 1024,
    hop: int = 256,
    n_mels: int = 80,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    eps: float = 1e-5,
) -> np.ndarray:
    """log(mel-power + eps): [n_mels, frames]."""
    mag = stft_mag(y, n_fft=n_fft, hop=hop)
    fb = mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    return np.log(fb @ (mag**2) + eps).astype(np.float32)


def mfcc(
    y: np.ndarray, sr: int, n_mfcc: int = 13, n_fft: int = 1024, hop: int = 256,
    n_mels: int = 40,
) -> np.ndarray:
    """MFCCs via DCT-II (orthonormal) over log-mel: [n_mfcc, frames]."""
    from scipy.fft import dct

    lm = logmel(y, sr, n_fft=n_fft, hop=hop, n_mels=n_mels)
    return dct(lm, type=2, axis=0, norm="ortho")[:n_mfcc].astype(np.float32)


def istft(spec: np.ndarray, n_fft: int = 1024, hop: int = 256,
          length: Optional[int] = None) -> np.ndarray:
    """Inverse STFT (complex [freqs, frames] -> waveform) with Hann OLA."""
    win = np.hanning(n_fft).astype(np.float32)
    frames = np.fft.irfft(spec.T, n=n_fft, axis=1).astype(np.float32)  # [T, n_fft]
    n_frames = frames.shape[0]
    out_len = n_fft + hop * (n_frames - 1)
    y = np.zeros(out_len, np.float32)
    norm = np.zeros(out_len, np.float32)
    for i in range(n_frames):
        a = i * hop
        y[a : a + n_fft] += frames[i] * win
        norm[a : a + n_fft] += win**2
    y = y / np.maximum(norm, 1e-8)
    pad = n_fft // 2
    y = y[pad:-pad] if out_len > 2 * pad else y
    if length is not None:
        y = y[:length] if len(y) >= length else np.pad(y, (0, length - len(y)))
    return y


def griffin_lim(mag: np.ndarray, n_fft: int = 1024, hop: int = 256,
                n_iter: int = 32, length: Optional[int] = None,
                seed: int = 0) -> np.ndarray:
    """Griffin-Lim phase reconstruction from a magnitude STFT
    [freqs, frames] -> waveform (text->audio mel decode path,
    BASELINE config #4)."""
    rng = np.random.default_rng(seed)
    angles = np.exp(2j * np.pi * rng.random(mag.shape))
    spec = mag.astype(np.complex128) * angles
    y = istft(spec, n_fft, hop, length)
    for _ in range(n_iter):
        re = stft_mag_complex(y, n_fft, hop)
        angles = re / np.maximum(np.abs(re), 1e-16)
        spec = mag * angles
        y = istft(spec, n_fft, hop, length)
    return y.astype(np.float32)


def stft_mag_complex(y: np.ndarray, n_fft: int = 1024, hop: int = 256) -> np.ndarray:
    """Complex STFT [freqs, frames] (centered Hann, matches stft_mag)."""
    win = np.hanning(n_fft).astype(np.float32)
    pad = n_fft // 2
    y = np.pad(y.astype(np.float32), (pad, pad), mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    return np.fft.rfft(y[idx] * win[None, :], axis=1).T


def mel_to_stft_mag(mel_power: np.ndarray, sr: int, n_fft: int,
                    n_mels: int = 80, fmin: float = 0.0,
                    fmax: Optional[float] = None) -> np.ndarray:
    """Approximate inverse mel projection (NNLS-lite: pseudo-inverse with
    clipping) for the mel -> Griffin-Lim vocoder path."""
    fb = mel_filterbank(sr, n_fft, n_mels, fmin, fmax)  # [M, F]
    inv = np.linalg.pinv(fb)  # [F, M]
    power = np.clip(inv @ mel_power, 0.0, None)
    return np.sqrt(power).astype(np.float32)


def rms_normalize(y: np.ndarray, target_dbfs: float = -23.0) -> np.ndarray:
    """Loudness normalization to a target dBFS RMS."""
    rms = np.sqrt(np.mean(np.square(y), dtype=np.float64))
    if rms < 1e-10:
        return y.astype(np.float32)
    gain = 10.0 ** (target_dbfs / 20.0) / rms
    return np.clip(y * gain, -1.0, 1.0).astype(np.float32)
