"""Config loading, the built-in mvp+v2a and specificity8 configs, and
device/dtype helpers.

``load_config``/``deep_update``/``expand_env`` are copies of the JAX
package's ``utils/io.py`` (the port imports nothing from that package).
PyYAML is imported only inside ``load_yaml``: a machine without it can
still run the port from ``MVP_V2A_CONFIG`` or ``SPECIFICITY8_CONFIG``.
"""

from __future__ import annotations

import copy
import json
import os
import re
from pathlib import Path
from typing import Any, Dict, Tuple, Union

import torch

PathLike = Union[str, os.PathLike]

_ENV_RE = re.compile(r"\$\{([A-Za-z_][A-Za-z0-9_]*)(?::-([^}]*))?\}")


def load_json(path: PathLike) -> Any:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def load_yaml(path: PathLike) -> Dict[str, Any]:
    import yaml

    with open(path, "r", encoding="utf-8") as f:
        return yaml.safe_load(f) or {}


def deep_update(base: Dict[str, Any], upd: Dict[str, Any]) -> Dict[str, Any]:
    """Recursively merge `upd` into `base` (mutates and returns `base`)."""
    for k, v in upd.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            deep_update(base[k], v)
        else:
            base[k] = v
    return base


def expand_env(obj: Any) -> Any:
    """Expand ``${VAR}`` and ``${VAR:-default}`` in every string leaf."""
    if isinstance(obj, str):
        def sub(m: re.Match) -> str:
            var, default = m.group(1), m.group(2)
            return os.environ.get(var, default if default is not None else m.group(0))
        return _ENV_RE.sub(sub, obj)
    if isinstance(obj, dict):
        return {k: expand_env(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [expand_env(v) for v in obj]
    return obj


def load_config(*paths: PathLike, expand: bool = True) -> Dict[str, Any]:
    """Load + deep-merge YAML/JSON configs, left->right precedence, then
    expand environment templating."""
    cfg: Dict[str, Any] = {}
    for p in paths:
        p = Path(p)
        if not p.exists():
            raise FileNotFoundError(p)
        if p.suffix.lower() in {".yaml", ".yml"}:
            part = load_yaml(p)
        elif p.suffix.lower() == ".json":
            part = load_json(p)
        else:
            raise ValueError(f"Unsupported config format: {p}")
        deep_update(cfg, part or {})
    if expand:
        cfg = expand_env(cfg)
    return cfg


# ``configs/mvp.yaml`` and the overlays ``configs/v2a.yaml`` (with OUTPUT_DIR
# and CHECKPOINT_DIR unset) and ``configs/specificity8.yaml``, kept here as
# dicts: the workloads run without PyYAML. ``MVP_V2A_CONFIG`` and
# ``SPECIFICITY8_CONFIG`` are the merged trees ``load_config`` gives.
_MVP_CONFIG: Dict[str, Any] = {
    "experiment": "av_mvp_tpu",
    "seed": 42,
    "device": "tpu",
    "mixed_precision": "bf16",
    "paths": {"video_root": "data/video",
              "audio_root": "data/audio",
              "out_root": "runs/av_mvp",
              "ckpt_dir": "runs/av_mvp/checkpoints",
              "log_dir": "runs/av_mvp/logs",
              "samples_dir": "runs/av_mvp/samples"},
    "data": {"train_split_glob": "data/GRID/clips.json",
             "val_split_glob": "data/GRID/clips.json",
             "clip_seconds": 3.0,
             "hop_seconds": 1.0,
             "num_workers": 4,
             "pin_memory": False,
             "prefetch_factor": 2,
             "batch_size": 8,
             "device_preprocess": True,
             "grad_accum_steps": 1},
    "video": {"fps": 16,
              "size": [128, 128],
              "latent": {"channels": 8, "t_down": 4, "s_down": 8}},
    "audio": {"sr": 16000,
              "representation": "codec",
              "codec": {"hop_samples": 320, "hidden": 64, "smooth_kernel": 7},
              "latent": {"channels": 8, "frames_per_clip": 150}},
    "tokenizer": {"width": 512,
                  "video": {"tube": {"t": 2, "h": 4, "w": 4}},
                  "audio": {"chunk": {"length": 4, "stride": 4}}},
    "embeddings": {"use_modality_embed": True,
                   "posenc": {"video": "learned_3d", "audio": "learned_1d"},
                   "timestep_embed": "sinusoidal",
                   "timestep_dim": 256},
    "model": {"core": {"d_model": 512,
                       "n_layers": 8,
                       "n_heads": 8,
                       "mlp_ratio": 4.0,
                       "dropout": 0.1,
                       "attn_dropout": 0.0,
                       "norm": "rmsnorm",
                       "rope": False,
                       "token_dropout": 0.0,
                       "gelu_exact": True},
              "heads": {"video": {"out_dim": 256,
                                  "hidden_dim": 512,
                                  "num_layers": 2,
                                  "dropout": 0.1,
                                  "activation": "gelu"},
                        "audio": {"out_dim": 32,
                                  "hidden_dim": 512,
                                  "num_layers": 2,
                                  "dropout": 0.1,
                                  "activation": "gelu"}}},
    "diffusion": {"video": {"steps": 1000,
                            "sampler_steps": 25,
                            "schedule": "cosine",
                            "min_beta": 0.0001,
                            "max_beta": 0.02},
                  "audio": {"steps": 1000,
                            "sampler_steps": 25,
                            "schedule": "cosine",
                            "min_beta": 0.0001,
                            "max_beta": 0.02}},
    "training": {"any2any_targets": {"video": 0.5, "audio": 0.5},
                 "cfg_drop_prob": 0.1,
                 "align_loss_weight": 0.0,
                 "optimizer": {"name": "adamw",
                               "lr": 0.0003,
                               "weight_decay": 0.05,
                               "betas": [0.9, 0.95],
                               "eps": 1e-08},
                 "scheduler": {"name": "cosine", "warmup_steps": 1000},
                 "max_steps": 200000,
                 "val_every": 1000,
                 "log_every": 50,
                 "ckpt_every": 5000,
                 "grad_clip_norm": 1.0,
                 "ema": {"use_ema": True, "decay": 0.999}},
    "sampling": {"ddim_eta": 0.0,
                 "guidance_scale": {"video": 3.0, "audio": 3.0},
                 "prompt_modality": "video"},
    "streaming": {"enabled": True,
                  "window_seconds": 3.0,
                  "hop_seconds": 1.0,
                  "crossfade_seconds": 0.25},
    "parallel": {"data": -1, "model": 1, "remat_core": False},
}

_V2A_OVERLAY: Dict[str, Any] = {
    "experiment": "av_infer_v2a",
    "paths": {"samples_dir": "runs/v2a/samples",
              "ckpt_path": "runs/av_mvp/checkpoints/latest"},
    "sampling": {"prompt_modality": "video",
                 "ddim_eta": 0.0,
                 "guidance_scale": {"audio": 3.5, "video": 0.0}},
    "diffusion": {"audio": {"sampler_steps": 60}, "video": {"sampler_steps": 50}},
    "streaming": {"enabled": False, "crossfade_seconds": 0.0},
    "io": {"input_frames_dir": "", "output_audio_path": "", "sr": 16000},
}

# the flagship: d=1024, 16 layers, 8 heads of 128, the patch VideoVAE, x0
# audio, 288 mouth-crop tokens (N = 96 + 37 + 288 = 421), reconstruction
# every 8th step, bf16 Adam moments
_SPECIFICITY8_OVERLAY: Dict[str, Any] = {
    "experiment": "av_specificity8",
    "paths": {"out_root": "runs/specificity8",
              "ckpt_dir": "runs/specificity8/checkpoints",
              "log_dir": "runs/specificity8/logs",
              "samples_dir": "runs/specificity8/samples"},
    "data": {"train_split_glob": "data/GRID/clips_4spk.json",
             "val_split_glob": "data/GRID/clips_4spk_val.json",
             "records_dir": "data/records_4spk",
             "device_resident": True,
             "resident_max_clips": 3072,
             "batch_size": 8},
    "video": {"arch": "patch", "encoder": {"hidden": 128}},
    "tokenizer": {"width": 1024},
    "model": {"latent_rmsnorm": True,
              "encoder_stopgrad": True,
              "core": {"d_model": 1024, "n_layers": 16, "n_heads": 8},
              "heads": {"video": {"hidden_dim": 1024}, "audio": {"hidden_dim": 1024}}},
    "diffusion": {"audio": {"param": "x0"}},
    "conditioning": {"mouth_crop": {"enabled": True,
                                    "box": [72, 104, 36, 84],
                                    "tube": {"t": 1, "h": 16, "w": 16}}},
    "training": {"any2any_targets": {"video": 0.3, "audio": 0.7},
                 "align_loss_weight": 0.1,
                 "sync_loss_weight": 0.2,
                 "sync_tau": 0.1,
                 "clean_cond_prob": 0.5,
                 "recon_loss_weight": 1.0,
                 "recon_every": 8,
                 "optimizer": {"mv_dtype": "bf16"},
                 "max_steps": 100000,
                 "log_every": 100,
                 "ckpt_every": 5000,
                 "ckpt_async": False,
                 "val_every": 0,
                 "scheduler": {"warmup_steps": 1000}},
}

MVP_V2A_CONFIG: Dict[str, Any] = deep_update(copy.deepcopy(_MVP_CONFIG), _V2A_OVERLAY)
SPECIFICITY8_CONFIG: Dict[str, Any] = deep_update(copy.deepcopy(_MVP_CONFIG),
                                                  _SPECIFICITY8_OVERLAY)


def mvp_v2a_config() -> Dict[str, Any]:
    """A fresh deep copy of MVP_V2A_CONFIG (callers may mutate it)."""
    return copy.deepcopy(MVP_V2A_CONFIG)


def specificity8_config() -> Dict[str, Any]:
    """A fresh deep copy of SPECIFICITY8_CONFIG (callers may mutate it)."""
    return copy.deepcopy(SPECIFICITY8_CONFIG)


# the mvp tree shrunk for dry runs (the JAX package's __graft_entry__._shrunk_cfg):
# d=64, 2 layers, 4 heads, 32x32 video, 1 s clips at 8 kHz, fp32
_SHRUNK_OVERLAY: Dict[str, Any] = {
    "mixed_precision": "fp32",
    "data": {"clip_seconds": 1.0, "batch_size": 2},
    "video": {"fps": 8, "size": [32, 32]},
    "audio": {"sr": 8000, "codec": {"hop_samples": 160, "hidden": 16},
              "latent": {"frames_per_clip": 50}},
    "tokenizer": {"width": 64, "video": {"tube": {"t": 2, "h": 1, "w": 1}},
                  "audio": {"chunk": {"length": 4, "stride": 4}}},
    "embeddings": {"timestep_dim": 64},
    "model": {"core": {"d_model": 64, "n_layers": 2, "n_heads": 4, "mlp_ratio": 2.0,
                       "dropout": 0.0},
              "heads": {"video": {"out_dim": 16, "hidden_dim": 64},
                        "audio": {"out_dim": 32, "hidden_dim": 64}}},
    "training": {"scheduler": {"warmup_steps": 2}},
}


def shrunk_config() -> Dict[str, Any]:
    """configs/mvp.yaml at the dry-run sizes (a fresh copy)."""
    return deep_update(copy.deepcopy(_MVP_CONFIG), copy.deepcopy(_SHRUNK_OVERLAY))


def builtin_config(name: str) -> Dict[str, Any]:
    """A fresh copy of a built-in config by name: "mvp" (mvp + v2a) or
    "specificity8" (mvp + specificity8)."""
    if name == "mvp":
        return mvp_v2a_config()
    if name == "specificity8":
        return specificity8_config()
    raise ValueError(f"config must be mvp|specificity8, got {name!r}")


def resolve_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for the
    CPU. Raises when CUDA is asked for and absent (no silent CPU run)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def compute_dtype_from_config(cfg: Dict) -> torch.dtype:
    """`mixed_precision` -> compute dtype (parameters always stay fp32)."""
    mp = str(cfg.get("mixed_precision", "fp32")).lower()
    if mp in {"bf16", "bfloat16", "fp16", "float16"}:
        return torch.bfloat16
    return torch.float32


def latent_shapes_from_config(cfg: Dict, batch_size: int) -> Dict[str, Tuple[int, ...]]:
    """Static pixel/waveform and latent shapes of one clip batch."""
    T = int(round(cfg["data"]["clip_seconds"] * cfg["video"]["fps"]))
    H, W = (int(x) for x in cfg["video"]["size"])
    L = int(round(cfg["data"]["clip_seconds"] * cfg["audio"]["sr"]))
    vl = cfg["video"]["latent"]
    al = cfg["audio"]["latent"]
    Cv, td, sd = int(vl["channels"]), int(vl["t_down"]), int(vl["s_down"])
    Ca, Fa = int(al["channels"]), int(al["frames_per_clip"])
    return {
        "video": (batch_size, 3, T, H, W),
        "audio": (batch_size, 1, L),
        "z_video": (batch_size, Cv, T // td, H // sd, W // sd),
        "z_audio": (batch_size, Ca, Fa),
    }
