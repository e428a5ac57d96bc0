"""Audio quality metrics (reference vs estimate).

A numpy/scipy copy of the JAX package's ``eval/audio_quality.py``, held
equal to it by ``tests/test_torch_stream_eval.py``.

Parity with the reference `avdiff/models/eval/audio_quality.py`:
  * snr_like (50-57): 10 log10(||ref||^2 / ||ref - est||^2)
  * logmel_l1 (59-71): mean |log-mel difference| (fmin 20, power 2, +1e-6)
  * spectral_convergence (73-82): ||S_est - S_ref||_F / ||S_ref||_F
  * mcd (84-110): 6.14185 * mean per-frame RMSE over MFCC c1.., optional DTW
  * pesq / stoi hooks (114-137) when those optional packages exist

librosa is replaced by media/audio_io (numpy STFT/mel/MFCC) plus a local DTW.
The optional back ends (pesq, pystoi) give None where they are absent.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np

from ..media.audio_io import logmel, mfcc, read_wav, stft_mag

try:  # optional
    from pesq import pesq as _pesq  # type: ignore
except Exception:
    _pesq = None

try:  # optional
    from pystoi import stoi as _stoi  # type: ignore
except Exception:
    _stoi = None


def snr_like(ref: np.ndarray, est: np.ndarray) -> float:
    L = min(len(ref), len(est))
    ref, est = ref[:L].astype(np.float32), est[:L].astype(np.float32)
    num = np.sum(ref**2) + 1e-10
    den = np.sum((ref - est) ** 2) + 1e-10
    return float(10.0 * np.log10(num / den))


def logmel_default(w: np.ndarray, sr: int, n_mels: int = 64,
                   n_fft: int = 1024, hop_length: int = 256) -> np.ndarray:
    """THE canonical log-mel of every metric in this module.  Callers that
    cache mels (tools/eval_av_quality.py precomputes them because its
    retrieval metric is O(n^2) comparisons) must use this same function so
    cached-path numbers stay bit-identical to logmel_l1."""
    return logmel(np.asarray(w, np.float32).reshape(-1), sr, n_fft=n_fft,
                  hop=hop_length, n_mels=n_mels, fmin=20.0, fmax=sr / 2,
                  eps=1e-6)


def l1_from_logmels(A: np.ndarray, B: np.ndarray) -> float:
    """logmel_l1's distance over precomputed mels (common-prefix frames)."""
    T = min(A.shape[1], B.shape[1])
    return float(np.mean(np.abs(A[:, :T] - B[:, :T])))


def logmel_l1(ref: np.ndarray, est: np.ndarray, sr: int, n_mels: int = 64,
              n_fft: int = 1024, hop_length: int = 256) -> float:
    A = logmel_default(ref, sr, n_mels=n_mels, n_fft=n_fft,
                       hop_length=hop_length)
    B = logmel_default(est, sr, n_mels=n_mels, n_fft=n_fft,
                       hop_length=hop_length)
    return l1_from_logmels(A, B)


def spectral_convergence(ref: np.ndarray, est: np.ndarray, sr: int,
                         n_fft: int = 1024, hop_length: int = 256) -> float:
    S_ref = stft_mag(ref, n_fft=n_fft, hop=hop_length)
    S_est = stft_mag(est, n_fft=n_fft, hop=hop_length)
    T = min(S_ref.shape[1], S_est.shape[1])
    num = np.linalg.norm(S_est[:, :T] - S_ref[:, :T], ord="fro")
    den = np.linalg.norm(S_ref[:, :T], ord="fro") + 1e-10
    return float(num / den)


def dtw_path(X: np.ndarray, Y: np.ndarray) -> np.ndarray:
    """Classic DTW (euclidean, steps {(1,0),(0,1),(1,1)}), returns the
    warping path [(i, j)] ascending (librosa.sequence.dtw equivalent for the
    MCD use case)."""
    Tx, Ty = X.shape[0], Y.shape[0]
    cost = np.sqrt(((X[:, None, :] - Y[None, :, :]) ** 2).sum(-1))  # [Tx, Ty]
    D = np.full((Tx + 1, Ty + 1), np.inf, dtype=np.float64)
    D[0, 0] = 0.0
    for i in range(1, Tx + 1):
        row_prev = D[i - 1]
        row = D[i]
        for j in range(1, Ty + 1):
            row[j] = cost[i - 1, j - 1] + min(
                row_prev[j], row[j - 1], row_prev[j - 1]
            )
    # backtrack
    path = [(Tx - 1, Ty - 1)]
    i, j = Tx, Ty
    while i > 1 or j > 1:
        steps = [(i - 1, j), (i, j - 1), (i - 1, j - 1)]
        vals = [D[a, b] for a, b in steps]
        i, j = steps[int(np.argmin(vals))]
        path.append((i - 1, j - 1))
    return np.asarray(path[::-1], dtype=np.int64)


def mcd(ref: np.ndarray, est: np.ndarray, sr: int, n_mfcc: int = 13,
        hop_length: int = 256, use_dtw: bool = True) -> float:
    """Mel Cepstral Distortion (dB, lower better): 6.14185 * mean frame RMSE
    over c1..c_{n_mfcc-1}, with optional DTW frame alignment."""
    R = mfcc(ref, sr, n_mfcc=n_mfcc, hop=hop_length)[1:, :].T  # [Tr, K-1]
    E = mfcc(est, sr, n_mfcc=n_mfcc, hop=hop_length)[1:, :].T
    if use_dtw:
        pairs = dtw_path(R, E)
        Rs, Es = R[pairs[:, 0]], E[pairs[:, 1]]
    else:
        T = min(R.shape[0], E.shape[0])
        Rs, Es = R[:T], E[:T]
    rmse = np.sqrt(np.sum((Rs - Es) ** 2, axis=1) + 1e-9)
    mcd_const = 10.0 / np.log(10.0) * np.sqrt(2.0)  # ~6.14185
    return float(mcd_const * np.mean(rmse))


def pesq_score(ref: np.ndarray, est: np.ndarray, sr: int) -> Optional[float]:
    if _pesq is None or sr not in (8000, 16000):
        return None
    try:
        return float(_pesq(sr, ref, est, "wb" if sr == 16000 else "nb"))
    except Exception:
        return None


def stoi_score(ref: np.ndarray, est: np.ndarray, sr: int) -> Optional[float]:
    if _stoi is None:
        return None
    try:
        return float(_stoi(ref, est, sr, extended=False))
    except Exception:
        return None


def evaluate_pair(ref_wav: str, est_wav: str, sr: int = 16000) -> Dict[str, Optional[float]]:
    ref, _ = read_wav(ref_wav, sr=sr)
    est, _ = read_wav(est_wav, sr=sr)
    return {
        "snr": snr_like(ref, est),
        "logmel_l1": logmel_l1(ref, est, sr=sr),
        "spec_conv": spectral_convergence(ref, est, sr=sr),
        "mcd": mcd(ref, est, sr=sr),
        "pesq": pesq_score(ref, est, sr=sr),
        "stoi": stoi_score(ref, est, sr=sr),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Audio quality metrics for a reference vs estimate."
    )
    ap.add_argument("--ref", type=str, required=True)
    ap.add_argument("--est", type=str, required=True)
    ap.add_argument("--sr", type=int, default=16000)
    args = ap.parse_args(argv)
    for k, v in evaluate_pair(args.ref, args.est, sr=args.sr).items():
        print(f"{k:10s}: {('%.4f' % v) if v is not None else 'N/A'}")


if __name__ == "__main__":
    main()
