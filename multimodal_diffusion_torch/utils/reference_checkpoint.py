"""The reference implementation's own checkpoints (``.pt``) into the port.

The reference trainer saves one dict ``{step, core, head, adapt_v, adapt_a,
vid_vae, aud_codec, opt, ema}`` of torch state_dicts. The JAX package reads
it through ``tools/port_reference_checkpoint.py`` (which imports JAX); this
module carries that tool's numpy layout rules, composed with
``utils/convert.py::jax_params_to_state_dict``, so the same file loads into
the port's ``AVDiffusionModel``:

    Linear   [out, in]             -> flax kernel [in, out]
    Conv1d   [out, in, k]          -> flax kernel [k, in, out]
    Conv3d   [out, in, kt, kh, kw] -> flax kernel [kt, kh, kw, in, out]
    MultiheadAttention in_proj [3d, d] -> the fused qkv kernel [d, 3d]
    LayerNorm / GroupNorm weight, bias -> scale, bias

and back to the port's layout. The embedding tables the reference does not
have (modality and position) are zeros, exact no-ops, shaped by the port
model's own ``state_dict``. ``use_ema`` takes the reference's ``ema`` dict
for the core. The file is read with ``torch.load(weights_only=True)``; its
optimizer state (``opt``) is skipped.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .convert import jax_params_to_state_dict


def _lin(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    out = {"kernel": np.ascontiguousarray(sd[f"{prefix}.weight"].T)}
    if f"{prefix}.bias" in sd:
        out["bias"] = sd[f"{prefix}.bias"]
    return out


def _conv(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    w = sd[f"{prefix}.weight"]
    axes = tuple(range(2, w.ndim)) + (1, 0)  # torch [out, in, *k] -> flax [*k, in, out]
    out = {"kernel": np.ascontiguousarray(np.transpose(w, axes))}
    if f"{prefix}.bias" in sd:
        out["bias"] = sd[f"{prefix}.bias"]
    return out


def _norm(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _rms(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": sd[f"{prefix}.scale"]}


def port_core(sd: Dict[str, np.ndarray], n_layers: int, norm: str = "rmsnorm") -> Dict[str, Any]:
    """The reference MMDiT's state_dict -> the JAX core subtree."""
    norm_name = "RMSNorm" if norm.lower() == "rmsnorm" else "LayerNorm"
    norm_map = _rms if norm.lower() == "rmsnorm" else _norm
    core: Dict[str, Any] = {}
    for i in range(n_layers):
        blk = f"blocks.{i}"
        qkv = {"kernel": np.ascontiguousarray(sd[f"{blk}.attn.mha.in_proj_weight"].T)}
        if f"{blk}.attn.mha.in_proj_bias" in sd:
            qkv["bias"] = sd[f"{blk}.attn.mha.in_proj_bias"]
        core[f"block_{i}"] = {
            f"{norm_name}_0": norm_map(sd, f"{blk}.norm1"),
            f"{norm_name}_1": norm_map(sd, f"{blk}.norm2"),
            "attn": {"qkv": qkv, "out": _lin(sd, f"{blk}.attn.mha.out_proj")},
            "mlp": {"fc1": _lin(sd, f"{blk}.mlp.fc1"), "fc2": _lin(sd, f"{blk}.mlp.fc2")},
        }
    core[f"{norm_name}_0"] = norm_map(sd, "final_norm")
    return core


def port_head(sd: Dict[str, np.ndarray], num_shared_layers: int = 2,
              modalities=("video", "audio")) -> Dict[str, Any]:
    """The reference MultiModalNoiseHead -> the JAX head subtree (its shared
    blocks are Sequential(Linear, LayerNorm, act, Dropout): shared.{i}.0 and
    shared.{i}.1)."""
    head: Dict[str, Any] = {}
    for m in modalities:
        head[f"input_proj_{m}"] = _lin(sd, f"input_proj.{m}")
        head[f"out_proj_{m}"] = _lin(sd, f"out_proj.{m}")
    for i in range(num_shared_layers):
        head[f"shared_{i}"] = {"dense": _lin(sd, f"shared.{i}.0"),
                               "LayerNorm_0": _norm(sd, f"shared.{i}.1")}
    return head


def port_adapter(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    return {"proj": _lin(sd, "proj")}


def port_vid_vae(sd: Dict[str, np.ndarray], enc_blocks: int = 2, dec_blocks: int = 2,
                 variational: bool = False) -> Dict[str, Any]:
    """The reference VideoVAE -> the JAX vid_vae subtree (blocks are
    Sequential(Conv3d, GELU, GroupNorm): enc_net.{i}.0 and enc_net.{i}.2)."""
    vae: Dict[str, Any] = {}
    for i in range(enc_blocks):
        vae[f"enc_{i}"] = {"Conv_0": _conv(sd, f"enc_net.{i}.0"),
                           "GroupNorm_0": _norm(sd, f"enc_net.{i}.2")}
    for i in range(dec_blocks):
        vae[f"dec_{i}"] = {"Conv_0": _conv(sd, f"dec_net.{i}.0"),
                           "GroupNorm_0": _norm(sd, f"dec_net.{i}.2")}
    if variational:
        vae["to_mu"] = _conv(sd, "to_mu")
        vae["to_logv"] = _conv(sd, "to_logv")
    else:
        vae["to_lat"] = _conv(sd, "to_lat")
    vae["from_lat"] = _conv(sd, "from_lat")
    vae["to_img"] = _conv(sd, "to_img")
    return vae


def port_aud_codec(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """The reference AudioCodec -> the JAX aud_codec subtree (`pre` is two
    Sequential(Conv1d, GELU): pre.{0,1}.0; `smooth` is Sequential(Conv, GELU,
    Conv, GELU, Conv): smooth.{0,2,4})."""
    return {
        "pre0": _conv(sd, "pre.0.0"),
        "pre1": _conv(sd, "pre.1.0"),
        "to_lat": _conv(sd, "to_lat"),
        "from_lat": _conv(sd, "from_lat"),
        "smooth0": _conv(sd, "smooth.0"),
        "smooth1": _conv(sd, "smooth.2"),
        "smooth2": _conv(sd, "smooth.4"),
    }


def port_reference_state(ref_state: Dict[str, Dict[str, np.ndarray]], cfg: Dict,
                         use_ema: bool = False) -> Dict[str, Any]:
    """The reference checkpoint's dicts (numpy) -> the JAX params tree,
    without the embedding tables the reference does not have."""
    core_cfg = cfg["model"]["core"]
    if use_ema and "ema" not in ref_state:
        raise KeyError("the reference checkpoint holds no 'ema' state")
    core_sd = ref_state["ema"] if use_ema else ref_state["core"]
    video_cfg = cfg["video"]
    return {
        "core": port_core(core_sd, int(core_cfg["n_layers"]), str(core_cfg.get("norm", "rmsnorm"))),
        "head": port_head(ref_state["head"]),
        "adapt_v": port_adapter(ref_state["adapt_v"]),
        "adapt_a": port_adapter(ref_state["adapt_a"]),
        "vid_vae": port_vid_vae(ref_state["vid_vae"],
                                int(video_cfg.get("encoder", {}).get("blocks", 2)),
                                int(video_cfg.get("decoder", {}).get("blocks", 2)),
                                bool(video_cfg.get("variational", False))),
        "aud_codec": port_aud_codec(ref_state["aud_codec"]),
    }


def read_reference_checkpoint(path) -> Tuple[int, Dict[str, Dict[str, np.ndarray]]]:
    """(step, {name: state_dict as numpy}) of a reference ``.pt``, without
    its optimizer state."""
    raw = torch.load(Path(path), map_location="cpu", weights_only=True)
    state = {k: {kk: vv.numpy() for kk, vv in v.items()}
             for k, v in raw.items() if isinstance(v, dict) and k != "opt"}
    return int(raw.get("step", 0)), state


def reference_state_dict(path, cfg: Dict, model: torch.nn.Module, use_ema: bool = False
                         ) -> Tuple[int, Dict[str, torch.Tensor]]:
    """(step, the port's state_dict) of a reference ``.pt`` for `model`
    (built from `cfg`): the reference's weights, and zeros for `model`'s
    embedding tables."""
    step, ref_state = read_reference_checkpoint(path)
    sd = jax_params_to_state_dict(port_reference_state(ref_state, cfg, use_ema))
    for key, t in model.state_dict().items():
        if key.startswith("embed."):
            sd[key] = torch.zeros(t.shape, dtype=torch.float32)
    return step, sd
