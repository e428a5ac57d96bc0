"""A/V sync proxy metric: lag + correlation between the video motion envelope
and the audio loudness envelope.

A numpy/scipy copy of the JAX package's ``eval/av_sync.py``, held
equal to it by ``tests/test_torch_stream_eval.py``.

Parity with the reference `avdiff/models/eval/av_sync.py`:
  * video_motion_envelope (av_sync.py:97-136): frame-diff (mean |delta|) or
    Farneback optical-flow magnitude; env[0] copied from env[1]; z-scored.
  * audio_rms_envelope (139-159): per-video-frame RMS windows, z-scored.
  * best_lag_and_corr (164-192): normalized cross-correlation over
    [-max_lag, +max_lag].  Implemented as one np.correlate sweep plus a
    per-lag overlap-length normalization [(len-1)*sx*sy, matching the
    reference's convention]; equivalence with a brute-force per-lag loop
    is covered by the JAX package's tests/test_eval.py.

CLI:
  python -m multimodal_diffusion_torch.eval.av_sync --frames DIR --audio a.wav \
      --sr 16000 --fps 16 [--max-lag 1.0] [--method diff|flow]
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..media.audio_io import read_wav
from ..media.video_io import load_frames_dir, read_video_file


def video_motion_envelope(
    frames: np.ndarray, method: str = "diff", flow_mag_clip: Optional[float] = None
) -> np.ndarray:
    """[T, H, W, 3] uint8 -> z-scored per-frame motion energy [T]."""
    T = frames.shape[0]
    if T < 2:
        return np.zeros((T,), dtype=np.float32)
    gray = frames.astype(np.float32).mean(axis=3)  # [T, H, W]

    if method == "diff":
        env = np.abs(gray[1:] - gray[:-1]).reshape(T - 1, -1).mean(axis=1)
    elif method == "flow":
        import cv2

        vals = []
        for t in range(1, T):
            flow = cv2.calcOpticalFlowFarneback(
                gray[t - 1].astype(np.uint8), gray[t].astype(np.uint8), None,
                pyr_scale=0.5, levels=3, winsize=15, iterations=3,
                poly_n=5, poly_sigma=1.2, flags=0,
            )
            mag = np.sqrt(flow[..., 0] ** 2 + flow[..., 1] ** 2)
            if flow_mag_clip:
                mag = np.clip(mag, 0, flow_mag_clip)
            vals.append(mag.mean())
        env = np.asarray(vals, dtype=np.float32)
    else:
        raise ValueError("Unknown method for video_motion_envelope")

    env = np.concatenate([env[:1], env], axis=0)  # pad first frame
    return ((env - env.mean()) / (env.std() + 1e-8)).astype(np.float32)


def audio_rms_envelope(wav: np.ndarray, sr: int, fps: float) -> np.ndarray:
    """Per-video-frame RMS (window = hop = 1/fps s), z-scored."""
    if fps <= 0:
        raise ValueError("fps must be > 0")
    win = max(1, int(round(sr / fps)))
    n = 1 + (len(wav) - win) // win if len(wav) >= win else 1
    env = np.empty((n,), dtype=np.float32)
    for i in range(n):
        seg = wav[i * win : min(len(wav), (i + 1) * win)]
        env[i] = np.sqrt((seg**2).mean() + 1e-10)
    return ((env - env.mean()) / (env.std() + 1e-8)).astype(np.float32)


def best_lag_and_corr(x: np.ndarray, y: np.ndarray, max_lag: int) -> Tuple[int, float]:
    """(lag, corr): positive lag = y delayed relative to x; normalized xcorr.

    Single vectorized sweep: ``np.correlate(y, x, "full")[L-1+lag]`` equals
    the per-lag overlap dot product ``sum_m x[m] * y[m+lag]``, which is then
    normalized by ``(overlap_len - 1) * std(x) * std(y)`` (stds over the
    full aligned window, the reference's convention).  Lags whose overlap
    is shorter than 3 samples are excluded; if no admissible lag scores
    above -1.0 the fallback is (0, -1.0).
    """
    L = min(len(x), len(y))
    x = np.asarray(x[:L], dtype=np.float64)
    y = np.asarray(y[:L], dtype=np.float64)
    x = x - x.mean()
    y = y - y.mean()
    denom_scale = (x.std() + 1e-8) * (y.std() + 1e-8)

    lags = np.arange(-max_lag, max_lag + 1)
    # full cross-correlation; index L-1+lag picks sum_m x[m] * y[m+lag]
    dots = np.correlate(y, x, mode="full")[np.clip(L - 1 + lags, 0, 2 * L - 2)]
    overlap = L - np.abs(lags)
    corrs = np.where(
        overlap >= 3,
        dots / (np.maximum(overlap - 1, 1) * denom_scale),
        -np.inf,
    )
    k = int(np.argmax(corrs))
    if not np.isfinite(corrs[k]) or corrs[k] <= -1.0:
        return 0, -1.0
    return int(lags[k]), float(corrs[k])


def estimate_av_sync(
    frames: np.ndarray,
    wav: np.ndarray,
    sr: int,
    fps: float,
    max_lag_seconds: float = 1.0,
    method: str = "diff",
) -> Tuple[float, float]:
    """Returns (lag_seconds, correlation).  Positive lag: delay audio to
    align with video."""
    v_env = video_motion_envelope(frames, method=method)
    a_env = audio_rms_envelope(wav, sr=sr, fps=fps)
    T = min(len(v_env), len(a_env))
    lag_frames, corr = best_lag_and_corr(
        v_env[:T], a_env[:T], max_lag=int(round(max_lag_seconds * fps))
    )
    return lag_frames / float(fps), float(corr)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="A/V sync proxy (motion vs loudness envelope)."
    )
    ap.add_argument("--frames", type=Path, default=None)
    ap.add_argument("--video", type=Path, default=None)
    ap.add_argument("--fps", type=float, default=0.0,
                    help="FPS (required with --frames)")
    ap.add_argument("--audio", type=Path, required=True)
    ap.add_argument("--sr", type=int, default=16000)
    ap.add_argument("--max-lag", type=float, default=1.0)
    ap.add_argument("--method", type=str, default="diff", choices=["diff", "flow"])
    args = ap.parse_args(argv)

    if args.frames is not None:
        frames = load_frames_dir(args.frames)
        fps = args.fps
        if fps <= 0:
            raise SystemExit("Please provide --fps when using --frames.")
    elif args.video is not None:
        frames, fps = read_video_file(args.video)
    else:
        raise SystemExit("Provide either --frames or --video")

    wav, _ = read_wav(args.audio, sr=args.sr)
    lag_s, corr = estimate_av_sync(frames, wav, sr=args.sr, fps=fps,
                                   max_lag_seconds=args.max_lag,
                                   method=args.method)
    print(f"av_sync lag_s={lag_s:+.3f} corr={corr:.3f} "
          f"(positive lag => delay the audio to align)")


if __name__ == "__main__":
    main()
