"""Shared helpers for the port's parity tests: the shrunk mvp config, the JAX
model with initialized params, and the port's model on the same weights."""

from __future__ import annotations

import ctypes
import subprocess
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
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


def jax_model_and_params(cfg: dict, seed: int = 0, jit: bool = False):
    """The JAX AVDiffusionModel and its params (numpy leaves), perturbed so
    biases and norm scales are not their trivial zeros/ones. `jit` compiles
    the init (about half the time of the eager one; its draws differ from
    the eager ones in the last bits)."""
    model = JaxModel(JaxConfig.from_config(cfg, dtype=jnp.float32))
    s = latent_shapes_from_config(cfg, 1)
    T = int(cfg["diffusion"]["video"]["steps"])
    args = (jnp.zeros(s["video"]), jnp.zeros(s["audio"]),
            jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32),
            jnp.zeros(s["z_video"]), jnp.zeros(s["z_audio"]),
            jnp.ones((T,)), jnp.ones((T,)))
    init = (jax.jit(lambda key: model.init({"params": key}, *args)) if jit
            else lambda key: model.init({"params": key}, *args))
    return model, perturb(init(jax.random.PRNGKey(seed))["params"], seed)


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


_LAYOUT_FNS = {}


def jax_layout_loss_and_grads(cfg: dict, params, batch: dict, draws: dict,
                              target_is_video: float, layout: dict):
    """The JAX package's train loss (deterministic) and its gradients on a
    mesh of the first devices laid out as `layout` (make_mesh axes, plus
    parallel keys such as context_flash): the model built with that mesh,
    the params placed by infer_param_shardings, the batch and draws by
    shard_batch. Returns (loss, grads as the port's state_dict). One
    compiled program per config and layout serves both targets."""
    import json

    from multimodal_diffusion_torch.utils.convert import jax_params_to_state_dict
    from multimodal_diffusion_tpu.ops import schedule as JS
    from multimodal_diffusion_tpu.parallel.mesh import make_mesh
    from multimodal_diffusion_tpu.parallel.sharding import infer_param_shardings, shard_batch
    from multimodal_diffusion_tpu.train import losses as JL

    key = json.dumps([cfg, layout], sort_keys=True, default=str)
    if key not in _LAYOUT_FNS:
        axes = {k: int(v) for k, v in layout.items() if k in ("data", "model", "context",
                                                              "pipe")}
        axes.setdefault("data", 1)
        mesh = make_mesh(**axes, devices=jax.devices()[:int(np.prod(list(axes.values())))])
        jcfg = {**cfg, "parallel": {**(cfg.get("parallel") or {}), **layout}}
        model = JaxModel(JaxConfig.from_config(jcfg, dtype=jnp.float32, mesh=mesh))
        s = latent_shapes_from_config(cfg, 1)
        T = int(cfg["diffusion"]["video"]["steps"])
        boxed = model.init(
            {"params": jax.random.PRNGKey(0)},
            jnp.zeros(s["video"]), jnp.zeros(s["audio"]),
            jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32),
            jnp.zeros(s["z_video"]), jnp.zeros(s["z_audio"]),
            jnp.ones((T,)), jnp.ones((T,)))["params"]
        dv = cfg["diffusion"]["video"]
        _, abar = JS.alphas_cumprod_from_betas(JS.make_beta_schedule(
            T, dv["schedule"], float(dv["min_beta"]), float(dv["max_beta"])))

        def loss_fn(p, b, w):
            out = model.apply({"params": p}, b["video"], b["audio"], b["t_v"], b["t_a"],
                              b["noise_v"], b["noise_a"], jnp.asarray(abar),
                              jnp.asarray(abar), b["keep_v"], b["keep_a"],
                              deterministic=True)
            return JL.mse_targets_only(out["eps_v"], out["eps_a"], out["eps_true_v"],
                                       out["eps_true_a"], w, b["has_video"], b["has_audio"])

        _LAYOUT_FNS[key] = (mesh, infer_param_shardings(mesh, boxed),
                            jax.jit(jax.value_and_grad(loss_fn)))
    mesh, shardings, fn = _LAYOUT_FNS[key]
    w = float(target_is_video)
    keep_nt = 1.0 - (draws["cfg_u"] < float(cfg["training"].get("cfg_drop_prob", 0.1)))
    b = shard_batch(mesh, {**{k: batch[k] for k in ("video", "audio", "has_video",
                                                    "has_audio")},
                           **{k: draws[k] for k in ("t_v", "t_a", "noise_v", "noise_a")},
                           "keep_v": (w + (1 - w) * keep_nt).astype(np.float32),
                           "keep_a": (w * keep_nt + (1 - w)).astype(np.float32)})
    loss, grads = fn(jax.device_put(params, shardings), b, jnp.float32(w))
    return float(loss), jax_params_to_state_dict(jax.device_get(grads))


def have_jpeglib() -> bool:
    """Whether g++ and libjpeg's header are there (the native loader's
    build needs both)."""
    try:
        r = subprocess.run(["g++", "-fsyntax-only", "-x", "c++", "-"],
                           input="#include <cstdio>\n#include <jpeglib.h>\n",
                           capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return False
    return r.returncode == 0


def _loads_whole(path: Path, timeout_s: float = 120.0) -> bool:
    """Wait until the library at `path` keeps its size for 0.2 s and loads."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if path.exists():
            size = path.stat().st_size
            time.sleep(0.2)
            if path.exists() and path.stat().st_size == size:
                try:
                    ctypes.CDLL(str(path))
                    return True
                except OSError:
                    pass
        time.sleep(0.2)
    return False


@pytest.fixture
def native_loaders():
    """Both packages' native JPEG loaders, whole and loaded, before a test
    compares their decodes: under the port's build lock the JAX library is
    made with its own rule (``make -C native``), the test waits until it
    loads (another process may still be writing it in place), and a JAX
    loader that latched "unavailable" in this process on a half-written
    file tries again. Where libjpeg's header exists both must be available.
    Returns (the port's module, the JAX package's module)."""
    from multimodal_diffusion_torch.datasets import native_loader as TN
    from multimodal_diffusion_tpu.datasets import native_loader as JN

    if have_jpeglib():
        with TN.build_lock():
            subprocess.run(["make", "-C", str(JN._NATIVE_DIR)], capture_output=True,
                           text=True, timeout=120)
            _loads_whole(JN._SO_PATH)
        with JN._lock:
            if JN._lib is None:
                JN._tried = False
        assert TN.available() and JN.available()
    return TN, JN
