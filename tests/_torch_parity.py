"""Shared helpers for the port's parity tests: the shrunk mvp config, the JAX
model with initialized params, and the port's model on the same weights."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax.core import meta

from multimodal_diffusion_torch.models.diffusion import (
    AVDiffusionConfig as TorchConfig,
    AVDiffusionModel as TorchModel,
)
from multimodal_diffusion_torch.utils.convert import load_jax_params
from multimodal_diffusion_tpu.models.diffusion import (
    AVDiffusionConfig as JaxConfig,
    AVDiffusionModel as JaxModel,
)
from multimodal_diffusion_tpu.train.trainer import latent_shapes_from_config


def shrunk_cfg(sampler_steps: int = 4) -> dict:
    """The mvp key tree at the dry-run sizes (d=64, 2 layers, 4 heads, 32x32
    video, 1 s clips), fp32, with `sampler_steps` DDIM steps."""
    from __graft_entry__ import _shrunk_cfg

    cfg = _shrunk_cfg()
    for mod in ("video", "audio"):
        cfg["diffusion"][mod]["sampler_steps"] = sampler_steps
    return cfg


def jax_model_and_params(cfg: dict, seed: int = 0):
    """The JAX AVDiffusionModel and its params (numpy leaves), perturbed so
    biases and norm scales are not their trivial zeros/ones."""
    model = JaxModel(JaxConfig.from_config(cfg, dtype=jnp.float32))
    s = latent_shapes_from_config(cfg, 1)
    T = int(cfg["diffusion"]["video"]["steps"])
    variables = model.init(
        {"params": jax.random.PRNGKey(seed)},
        jnp.zeros(s["video"]), jnp.zeros(s["audio"]),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32),
        jnp.zeros(s["z_video"]), jnp.zeros(s["z_audio"]),
        jnp.ones((T,)), jnp.ones((T,)))
    return model, perturb(variables["params"], seed)


def perturb(params, seed: int = 0):
    """Unbox a flax params tree and add N(0, 0.05) to every leaf (numpy), so
    zero biases and unit scales take part in the comparison."""
    rng = np.random.default_rng(seed + 1)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + rng.normal(0.0, 0.05, np.shape(a)).astype(np.float32), meta.unbox(params))


def torch_model(cfg: dict, params) -> TorchModel:
    model = TorchModel(TorchConfig.from_config(cfg, dtype=torch.float32))
    return load_jax_params(model, params).eval()


def t2n(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().cpu().numpy()


def shrunk_flagship_cfg(sampler_steps: int = 4) -> dict:
    """The shrunk config with the flagship's (specificity8) options on: the
    patch VideoVAE, per-sample latent RMS norm, encoder stop-gradient, x0
    audio, a mouth-crop stream (a 12x16 box in the 32x32 frame, 1x4x8 pixel
    tubes: 6 tokens a frame, 48 a clip), video tubes of one latent frame (two
    time chunks, so the video-source sync loss has negatives), alignment,
    sync and reconstruction losses, clean conditioning, recon_every 2, bf16
    Adam moments."""
    from multimodal_diffusion_tpu.utils.io import deep_update

    cfg = shrunk_cfg(sampler_steps)
    deep_update(cfg, {
        "video": {"arch": "patch", "encoder": {"hidden": 16}},
        "tokenizer": {"video": {"tube": {"t": 1, "h": 1, "w": 1}}},
        "model": {"latent_rmsnorm": True, "encoder_stopgrad": True,
                  "heads": {"video": {"out_dim": 8}}},
        "diffusion": {"audio": {"param": "x0"}},
        "conditioning": {"mouth_crop": {"enabled": True, "box": [16, 28, 8, 24],
                                        "tube": {"t": 1, "h": 4, "w": 8}}},
        "training": {"any2any_targets": {"video": 0.3, "audio": 0.7},
                     "align_loss_weight": 0.1, "sync_loss_weight": 0.2, "sync_tau": 0.1,
                     "clean_cond_prob": 0.5, "recon_loss_weight": 1.0, "recon_every": 2,
                     "optimizer": {"mv_dtype": "bf16"}},
    })
    return cfg
