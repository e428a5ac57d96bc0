"""Model FLOPs of the MMDiT denoiser, counted from the configuration.

``mmdit_forward_flops`` is the program's own analytic count
(``utils/profiling.py::flops_mmdit_forward``), copied here so that the
yardstick stays fixed: the dense matrix products of one sample's forward
pass, per layer qkv 2*N*d*3d, scores and values 4*N^2*d, output projection
2*N*d*d and the two MLP products 4*N*d*(ratio*d). Norms, softmax, the
embeddings, the heads, the VAE and the codec are left out, so a share of the
peak built on it is a floor.
"""

from __future__ import annotations

from typing import Dict


def mmdit_forward_flops(n_tokens: int, d_model: int, n_layers: int,
                        mlp_ratio: float = 4.0) -> float:
    N, d = n_tokens, d_model
    per_layer = (2 * N * d * 3 * d + 4 * N * N * d + 2 * N * d * d
                 + 4 * N * d * int(mlp_ratio * d))
    return float(n_layers * per_layer)


def core_tokens(cfg: Dict) -> Dict[str, int]:
    """Tokens the core runs per sample, by stream, before any padding:
    video tubes, audio chunks and (conditioning.mouth_crop) mouth tubes."""
    vid, aud, tok = cfg["video"], cfg["audio"], cfg["tokenizer"]
    fps, secs = int(vid["fps"]), float(cfg["data"]["clip_seconds"])
    T = int(round(secs * fps))
    H, W = (int(x) for x in vid["size"])
    td, sd = int(vid["latent"]["t_down"]), int(vid["latent"]["s_down"])
    tube = tok["video"]["tube"]
    nv = (T // td // int(tube["t"])) * (H // sd // int(tube["h"])) * (W // sd // int(tube["w"]))
    length, stride = int(tok["audio"]["chunk"]["length"]), int(tok["audio"]["chunk"]["stride"])
    fa = int(aud["latent"]["frames_per_clip"])
    na = (fa - length) // stride + 1 if fa >= length else 1
    mouth = (cfg.get("conditioning", {}) or {}).get("mouth_crop", {}) or {}
    nm = 0
    if mouth.get("enabled", False):
        h0, h1, w0, w1 = (int(x) for x in mouth["box"])
        mt = mouth.get("tube", {}) or {}
        nm = (T // int(mt.get("t", 2))) * ((h1 - h0) // int(mt.get("h", 8))) * (
            (w1 - w0) // int(mt.get("w", 8)))
    return {"video": nv, "audio": na, "mouth": nm, "total": nv + na + nm}


def denoiser_forward_flops(cfg: Dict) -> float:
    """One sample's denoiser forward at the tokens the core runs."""
    core = cfg["model"]["core"]
    return mmdit_forward_flops(core_tokens(cfg)["total"], int(core["d_model"]),
                               int(core["n_layers"]), float(core.get("mlp_ratio", 4.0)))
