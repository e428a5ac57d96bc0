"""Video quality metrics: PSNR / SSIM / LPIPS + temporal flicker.

A numpy/scipy copy of the JAX package's ``eval/video_metrics.py``, held
equal to it by ``tests/test_torch_stream_eval.py``.

Parity with the reference `avdiff/models/eval/video_metrics.py`:
  * per-frame PSNR + SSIM with means (74-86) — scikit-image isn't in this
    image, so both are implemented in numpy: PSNR is the standard
    10 log10(1/MSE); SSIM follows Wang et al. 2004 with skimage's default
    parameterization for floats (7x7 uniform window, C1=(0.01 L)^2,
    C2=(0.03 L)^2, channel-averaged).
  * LPIPS mean when the optional `lpips` package exists (88-109), NaN
    otherwise; the network runs on CUDA unless the caller asks for the CPU
    (``--lpips-device cpu``), and raises when CUDA is asked for and absent.
  * temporal_flicker (111-120): mean |frame[t] - frame[t-1]|, no-reference.

CLI:
  python -m multimodal_diffusion_torch.eval.video_metrics --ref DIR --est DIR
  python -m multimodal_diffusion_torch.eval.video_metrics --est DIR   # flicker
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from ..media.video_io import load_frames_dir
from ..utils.io import resolve_device

try:  # optional
    import lpips as lpips_lib  # type: ignore
except Exception:
    lpips_lib = None


def _to_float01(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float32)
    return x / 255.0 if x.max() > 1.5 else x


def psnr(ref: np.ndarray, est: np.ndarray, data_range: float = 1.0) -> float:
    mse = np.mean((ref.astype(np.float64) - est.astype(np.float64)) ** 2)
    if mse <= 0:
        return float("inf")
    return float(10.0 * np.log10((data_range**2) / mse))


def _uniform_filter2d(x: np.ndarray, size: int) -> np.ndarray:
    """Uniform filter matching scipy.ndimage.uniform_filter(mode='reflect')
    numerics, computed with an integral image over a symmetric-padded input
    (no scipy dependency)."""
    lo = size // 2
    hi = size - 1 - lo
    p = np.pad(x.astype(np.float64), ((lo, hi), (lo, hi)), mode="symmetric")
    ii = np.zeros((p.shape[0] + 1, p.shape[1] + 1), dtype=np.float64)
    np.cumsum(p, axis=0, out=p)
    np.cumsum(p, axis=1, out=p)
    ii[1:, 1:] = p
    s = (ii[size:, size:] - ii[:-size, size:]
         - ii[size:, :-size] + ii[:-size, :-size])
    return s / float(size * size)


def ssim(ref: np.ndarray, est: np.ndarray, data_range: float = 1.0,
         win_size: int = 7) -> float:
    """Mean SSIM over channels, skimage-default parameterization
    (uniform window, K1=0.01, K2=0.03, sample covariance normalization)."""
    ref = ref.astype(np.float64)
    est = est.astype(np.float64)
    if ref.ndim == 2:
        ref, est = ref[..., None], est[..., None]
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    NP = win_size**2
    cov_norm = NP / (NP - 1)  # sample covariance (skimage use_sample_covariance)
    vals = []
    pad = (win_size - 1) // 2
    for c in range(ref.shape[2]):
        x, y = ref[..., c], est[..., c]
        ux = _uniform_filter2d(x, win_size)
        uy = _uniform_filter2d(y, win_size)
        uxx = _uniform_filter2d(x * x, win_size)
        uyy = _uniform_filter2d(y * y, win_size)
        uxy = _uniform_filter2d(x * y, win_size)
        vx = cov_norm * (uxx - ux * ux)
        vy = cov_norm * (uyy - uy * uy)
        vxy = cov_norm * (uxy - ux * uy)
        S = ((2 * ux * uy + C1) * (2 * vxy + C2)) / (
            (ux**2 + uy**2 + C1) * (vx + vy + C2)
        )
        # crop the window radius like skimage before averaging
        vals.append(S[pad:-pad, pad:-pad].mean() if pad > 0 else S.mean())
    return float(np.mean(vals))


def _lpips_model(device: str = "cuda"):
    """The LPIPS network on `device` (raises when CUDA is asked for and
    absent: no CPU fallback), or None without the optional lpips package."""
    dev = resolve_device(device)
    if lpips_lib is None:
        return None
    model = lpips_lib.LPIPS(net="alex").to(dev)
    model.eval()
    return model


def _lpips_pair(model, ref: np.ndarray, est: np.ndarray) -> float:
    if model is None:
        return float("nan")
    t_ref = torch.from_numpy(ref).permute(2, 0, 1).unsqueeze(0) * 2 - 1
    t_est = torch.from_numpy(est).permute(2, 0, 1).unsqueeze(0) * 2 - 1
    dev = next(model.parameters()).device
    with torch.no_grad():
        d = model(t_ref.to(dev).float(), t_est.to(dev).float())
    return float(d.squeeze().item())


def temporal_flicker(frames: np.ndarray) -> float:
    """Mean |frame[t] - frame[t-1]| in [0,1]; higher = more flicker."""
    x = _to_float01(frames)
    if x.shape[0] < 2:
        return 0.0
    return float(np.abs(x[1:] - x[:-1]).mean(axis=(1, 2, 3)).mean())


def evaluate_video_pair(ref_dir: Path, est_dir: Path,
                        lpips_device: str = "cuda") -> Dict[str, float]:
    ref = _to_float01(load_frames_dir(ref_dir))
    est = _to_float01(load_frames_dir(est_dir))
    T = min(ref.shape[0], est.shape[0])
    ref, est = ref[:T], est[:T]
    psnrs = [psnr(ref[t], est[t]) for t in range(T)]
    ssims = [ssim(ref[t], est[t]) for t in range(T)]
    model = _lpips_model(lpips_device)
    lpips_vals = [_lpips_pair(model, ref[t], est[t]) for t in range(T)]
    return {
        "psnr_mean": float(np.nanmean(psnrs)),
        "ssim_mean": float(np.nanmean(ssims)),
        "lpips_mean": float(np.nanmean(lpips_vals)),
        "flicker_est": temporal_flicker(est),
        "frames_compared": float(T),
    }


def evaluate_video_only(est_dir: Path) -> Dict[str, float]:
    est = _to_float01(load_frames_dir(est_dir))
    return {"flicker_est": temporal_flicker(est), "num_frames": float(est.shape[0])}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Video metrics (PSNR/SSIM/LPIPS + flicker)."
    )
    ap.add_argument("--ref", type=Path, default=None)
    ap.add_argument("--est", type=Path, required=True)
    ap.add_argument("--lpips-device", type=str, default="cuda")
    args = ap.parse_args(argv)
    scores = (
        evaluate_video_pair(args.ref, args.est, lpips_device=args.lpips_device)
        if args.ref is not None
        else evaluate_video_only(args.est)
    )
    for k, v in scores.items():
        print(f"{k:14s}: {v:.4f}")


if __name__ == "__main__":
    main()
