"""Tiny versions of the benchmark's configurations for CPU tests: every
width and length cut, every path (patch or conv VAE, mouth stream,
x0 or eps prediction) kept."""

import copy
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def frozen(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())["config"]


def tiny(name: str, precision: str = "fp32", steps: int = 3) -> dict:
    cfg = copy.deepcopy(frozen(name))
    cfg["mixed_precision"] = precision
    cfg["data"]["clip_seconds"] = 0.5
    cfg["audio"]["latent"]["frames_per_clip"] = 25
    cfg["audio"]["codec"]["hidden"] = 8
    cfg["tokenizer"]["width"] = 64
    core = cfg["model"]["core"]
    core.update(d_model=64, n_layers=2, n_heads=2)
    for m in ("video", "audio"):
        cfg["model"]["heads"][m]["hidden_dim"] = 32
        cfg["diffusion"][m]["sampler_steps"] = steps
    enc = cfg["video"].setdefault("encoder", {})
    enc.update(base=8, hidden=16 if cfg["video"].get("arch") == "patch" else 0)
    cfg["video"].setdefault("decoder", {})["base"] = 8
    if not enc["hidden"]:
        del enc["hidden"]
    return cfg
