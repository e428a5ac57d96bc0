"""Latent-scale / latent-collapse probe of a trained A<->V checkpoint's
encoders (counterpart of the repo root's ``tools/latent_probe.py``):

    python -m multimodal_diffusion_torch.tools.latent_probe \
        --config configs/mvp.yaml overlay.yaml [--n 8] [--ema] [--device cpu] \
        [--out probe.json]

Encodes the manifest's held-out tail (the slice ``eval_av_quality`` takes)
with the VideoVAE and the audio codec, nothing else (no sampling, so it is
deterministic), and reports for each latent:

  * rms_per_sample   mean / min / max per-clip rms(z): ~1.0 by construction
                     with model.latent_rmsnorm
  * std_global       the std of every latent value
  * across_clip_std  the std across clips, averaged over positions: ~0 when
                     the encoder maps every clip to one latent
  * pairwise_cos     mean and max |cosine| between different clips'
                     flattened latents: ~1.0 under collapse

The video is centre-cropped in time to a multiple of the VAE's t_down, as
there. Runs on CUDA unless ``--device cpu``; raises without CUDA otherwise.
"""

from __future__ import annotations

import argparse
import json
import sys
from itertools import combinations
from pathlib import Path

import numpy as np
import torch

from ..infer.sample_clip import build_components
from ..utils.io import load_config, resolve_device
from .eval_av_quality import held_out_indices, manifest_dataset


def _stats(z: np.ndarray) -> dict:
    """z: [n_clips, ...] latent batch -> collapse diagnostics."""
    n = z.shape[0]
    flat = z.reshape(n, -1).astype(np.float64)
    rms = np.sqrt((flat ** 2).mean(axis=1))
    across = flat.std(axis=0).mean()
    cosines = []
    for i, j in combinations(range(n), 2):
        a, b = flat[i], flat[j]
        denom = np.linalg.norm(a) * np.linalg.norm(b)
        if denom > 0:
            cosines.append(abs(float(a @ b) / denom))
    return {
        "rms_per_sample_mean": float(rms.mean()),
        "rms_per_sample_min": float(rms.min()),
        "rms_per_sample_max": float(rms.max()),
        "std_global": float(flat.std()),
        "across_clip_std": float(across),
        "pairwise_cos_mean": float(np.mean(cosines)) if cosines else None,
        "pairwise_cos_max": float(np.max(cosines)) if cosines else None,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", type=str, nargs="+", required=True)
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--ema", action="store_true")
    ap.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)

    device = resolve_device("cpu" if (args.device or "").lower() == "cpu" else "cuda")
    cfg = load_config(*args.config)
    ds = manifest_dataset(cfg)
    n = min(args.n, len(ds))
    if n < 2:
        sys.exit("need >= 2 clips for collapse diagnostics")
    idxs = held_out_indices(len(ds), n, spread=False)

    model = build_components(cfg, device=device, use_ema=args.ema)
    frames = np.stack([np.asarray(ds[i]["video"]) for i in idxs])
    wavs = np.stack([np.asarray(ds[i]["audio"]).reshape(-1) for i in idxs])

    with torch.inference_mode():
        x = torch.from_numpy(frames).to(device, torch.float32).permute(0, 4, 1, 2, 3) / 255.0
        t_div = int(model.cfg.vae.t_down)
        T_crop = (x.shape[2] // t_div) * t_div
        if T_crop != x.shape[2]:
            s0 = (x.shape[2] - T_crop) // 2
            x = x[:, :, s0:s0 + T_crop]
        z_v = model.encode_video(x).float().cpu().numpy()
        z_a = model.encode_audio(
            torch.from_numpy(wavs).to(device, torch.float32)[:, None, :]).float().cpu().numpy()

    report = {
        "n_clips": n,
        "ema": bool(args.ema),
        "latent_rmsnorm": bool((cfg.get("model", {}) or {}).get("latent_rmsnorm", False)),
        "z_video": _stats(z_v),
        "z_audio": _stats(z_a),
    }
    print(json.dumps(report, indent=2))
    if args.out:
        args.out.write_text(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
