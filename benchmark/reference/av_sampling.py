"""Plain PyTorch reference of the audio-video latent diffusion model's
video-to-audio sampling, written from the model's equations and kept apart
from the program under test: it imports nothing of it.

Everything runs in float32 with TF32 off, token by token as the equations
say: no kernels, no fused ops, no cache, dense softmax attention. Weights are
a mapping from parameter name to tensor, made by the benchmark (``weights.py``)
and handed to both sides; this module only reads them, upcast to float32.

The model (configs/mvp.yaml's key tree):

  frames [B, T, H, W, 3] uint8 -> x = frames / 255, [B, 3, T, H, W]
  video VAE encoder -> z_v [B, Cv, T/td, H/sd, W/sd]  (per-sample RMS
      normalised when model.latent_rmsnorm)
  tube tokens of z_v, audio-chunk tokens of the noisy audio latent z_a, and
      (conditioning.mouth_crop) tube tokens of the raw mouth box, each
      projected to width d, plus modality, positional and sinusoidal
      timestep embeddings, times the classifier-free-guidance keep mask
  MMDiT: pre-norm blocks x + attn(rms(x)); x + mlp(rms(x)); final rms
  heads: Dense -> (Dense -> LayerNorm -> GELU) x L -> Dense, per modality
  DDIM (eta 0) over round(linspace(T-1, -1, S+1)), batched CFG:
      eps = eps_null + g (eps_cond - eps_null); param eps | x0 | v
  audio codec decoder -> waveform [B, Fa * hop]
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Weights = Mapping[str, torch.Tensor]


class Fp8Weights(dict):
    """The same weights, read by a reference that computes every matrix
    product and convolution with its operands rounded to float8 e4m3
    (``fp8``): the precision below the bf16 a configuration states."""

    low = True


def _low(W: Weights) -> bool:
    return getattr(W, "low", False)


# ---------------------------------------------------------------------------
# the configuration's derived sizes
# ---------------------------------------------------------------------------


def sizes(cfg: Dict) -> Dict:
    """Every size the model and the sampler need, read from the config."""
    vid, aud, tok = cfg["video"], cfg["audio"], cfg["tokenizer"]
    core, heads = cfg["model"]["core"], cfg["model"]["heads"]
    enc = vid.get("encoder", {}) or {}
    mouth = ((cfg.get("conditioning", {}) or {}).get("mouth_crop", {}) or {})
    fps, sr, secs = int(vid["fps"]), int(aud["sr"]), float(cfg["data"]["clip_seconds"])
    H, W = (int(x) for x in vid["size"])
    td, sd = int(vid["latent"]["t_down"]), int(vid["latent"]["s_down"])
    arch = str(vid.get("arch", enc.get("arch", "conv")))
    tube = tok["video"]["tube"]
    chunk = tok["audio"]["chunk"]
    mtube = mouth.get("tube", {}) or {}
    s = {
        "T": int(round(secs * fps)), "H": H, "W": W, "L": int(round(secs * sr)),
        "Cv": int(vid["latent"]["channels"]), "td": td, "sd": sd, "arch": arch,
        "enc_base": int(enc.get("base", 64)), "enc_blocks": int(enc.get("blocks", 2)),
        "dec_base": int((vid.get("decoder", {}) or {}).get("base", 64)),
        "dec_blocks": int((vid.get("decoder", {}) or {}).get("blocks", 2)),
        "patch_hidden": int(enc.get("hidden", 0)) or 2 * int(enc.get("base", 64)),
        "Ca": int(aud["latent"]["channels"]), "Fa": int(aud["latent"]["frames_per_clip"]),
        "hop": int(aud["codec"]["hop_samples"]), "codec_hidden": int(aud["codec"]["hidden"]),
        "smooth_k": max(3, int(aud["codec"]["smooth_kernel"])),
        "d": int(tok["width"]), "tube": (int(tube["t"]), int(tube["h"]), int(tube["w"])),
        "chunk": (int(chunk["length"]), int(chunk["stride"])),
        "layers": int(core["n_layers"]), "heads": int(core["n_heads"]),
        "mlp": int(int(core["d_model"]) * float(core.get("mlp_ratio", 4.0))),
        "gelu_exact": bool(core.get("gelu_exact", True)),
        "head_hidden": int(heads["audio"]["hidden_dim"]),
        "head_layers": int(heads["audio"].get("num_layers", 2)),
        "out_v": int(heads["video"]["out_dim"]), "out_a": int(heads["audio"]["out_dim"]),
        "latent_rmsnorm": bool(cfg["model"].get("latent_rmsnorm", False)),
        "mouth": bool(mouth.get("enabled", False)),
        "mouth_box": tuple(int(x) for x in mouth.get("box", (64, 112, 32, 96))),
        "mouth_tube": (int(mtube.get("t", 2)), int(mtube.get("h", 8)), int(mtube.get("w", 8))),
    }
    if str(core.get("norm", "rmsnorm")).lower() != "rmsnorm" or core.get("rope", False):
        raise ValueError("the reference covers the rmsnorm core without RoPE")
    if int(core["d_model"]) != s["d"]:
        raise ValueError("tokenizer.width must equal model.core.d_model")
    return s


def param_shapes(cfg: Dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of the model, by name, with its shape: the layout the
    benchmark draws weights for and loads into the program by name."""
    s = sizes(cfg)
    d, out = s["d"], {}

    def dense(name, d_in, d_out):
        out[f"{name}.weight"] = (d_out, d_in)
        out[f"{name}.bias"] = (d_out,)

    def conv(name, c_in, c_out, k, dims):
        out[f"{name}.weight"] = (c_out, c_in) + (k,) * dims
        out[f"{name}.bias"] = (c_out,)

    def norm(name, c, bias=True):
        out[f"{name}.weight"] = (c,)
        if bias:
            out[f"{name}.bias"] = (c,)

    td, sd, Cv = s["td"], s["sd"], s["Cv"]
    patch_dim = td * sd * sd * 3
    if s["arch"] == "patch":
        hid = s["patch_hidden"]
        dense("vid_vae.patch_embed", patch_dim, hid)
        norm("vid_vae.patch_norm", hid)
        enc_w = dec_w = enc_in = hid
    else:
        enc_w, dec_w, enc_in = s["enc_base"], s["dec_base"], 3
    for i in range(s["enc_blocks"]):
        conv(f"vid_vae.enc.{i}.conv", enc_in if i == 0 else enc_w, enc_w, 3, 3)
        norm(f"vid_vae.enc.{i}.norm", enc_w)
    conv("vid_vae.to_lat", enc_w if s["enc_blocks"] else enc_in, Cv, 1, 3)
    conv("vid_vae.from_lat", Cv, dec_w, 1, 3)
    for i in range(s["dec_blocks"]):
        conv(f"vid_vae.dec.{i}.conv", dec_w, dec_w, 3, 3)
        norm(f"vid_vae.dec.{i}.norm", dec_w)
    if s["arch"] == "patch":
        dense("vid_vae.unpatch_proj", dec_w, patch_dim)
    else:
        conv("vid_vae.to_img", dec_w, 3, 1, 3)

    ch, Ca, k = s["codec_hidden"], s["Ca"], s["smooth_k"]
    conv("aud_codec.pre0", 1, ch, 9, 1)
    conv("aud_codec.pre1", ch, ch, 9, 1)
    conv("aud_codec.to_lat", ch, Ca, 1, 1)
    conv("aud_codec.from_lat", Ca, ch, 1, 1)
    conv("aud_codec.smooth0", ch, ch, k, 1)
    conv("aud_codec.smooth1", ch, ch, k, 1)
    conv("aud_codec.smooth2", ch, 1, k, 1)

    t, h, w = s["tube"]
    dense("adapt_v.proj", Cv * t * h * w, d)
    dense("adapt_a.proj", Ca * s["chunk"][0], d)
    if s["mouth"]:
        mt, mh, mw = s["mouth_tube"]
        dense("adapt_m.proj", 3 * mt * mh * mw, d)
    out["embed.modality.table"] = (3 if s["mouth"] else 2, d)
    for ax in ("t", "h", "w"):
        out[f"embed.pos_v.{ax}_table"] = (256, d)
    out["embed.pos_a.table"] = (4096, d)
    if s["mouth"]:
        for ax in ("t", "h", "w"):
            out[f"embed.pos_m.{ax}_table"] = (256, d)
    for i in range(s["layers"]):
        p = f"core.blocks.{i}"
        norm(f"{p}.norm1", d, bias=False)
        dense(f"{p}.attn.qkv", d, 3 * d)
        dense(f"{p}.attn.out", d, d)
        norm(f"{p}.norm2", d, bias=False)
        dense(f"{p}.mlp.fc1", d, s["mlp"])
        dense(f"{p}.mlp.fc2", s["mlp"], d)
    norm("core.norm", d, bias=False)
    hh = s["head_hidden"]
    dense("head.input_proj_video", d, hh)
    dense("head.input_proj_audio", d, hh)
    for i in range(s["head_layers"]):
        dense(f"head.shared.{i}.dense", hh, hh)
        norm(f"head.shared.{i}.norm", hh)
    dense("head.out_proj_video", hh, s["out_v"])
    dense("head.out_proj_audio", hh, s["out_a"])
    return out


def is_norm_scale(name: str) -> bool:
    """A normalisation layer's scale (RMSNorm, LayerNorm or GroupNorm)."""
    parts = name.split(".")
    return parts[-1] == "weight" and "norm" in parts[-2]


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _w(W: Weights, name: str) -> torch.Tensor:
    return W[name].float()


def dense(W: Weights, name: str, x: torch.Tensor) -> torch.Tensor:
    w = _w(W, f"{name}.weight")
    if _low(W):
        x, w = fp8(x), fp8(w)
    return x @ w.t() + _w(W, f"{name}.bias")


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale (its absmax to the
    format's largest value, 448), back in float32."""
    scale = x.abs().amax().clamp(min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def conv(W: Weights, name: str, x: torch.Tensor) -> torch.Tensor:
    """A 'same'-padded convolution."""
    w, b = _w(W, f"{name}.weight"), _w(W, f"{name}.bias")
    if _low(W):
        x, w = fp8(x), fp8(w)
    pad = w.shape[-1] // 2
    if w.ndim == 5:
        return F.conv3d(x, w, b, padding=pad)
    return F.conv1d(x, w, b, padding=pad)


def gelu(x: torch.Tensor, exact: bool = True) -> torch.Tensor:
    if exact:
        return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def layer_norm(W: Weights, name: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * _w(W, f"{name}.weight") + _w(W, f"{name}.bias")


def group_norm(W: Weights, name: str, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    B, C = x.shape[:2]
    g = min(8, C)
    xg = x.reshape(B, g, -1)
    mu = xg.mean(dim=-1, keepdim=True)
    var = ((xg - mu) ** 2).mean(dim=-1, keepdim=True)
    y = ((xg - mu) / torch.sqrt(var + eps)).reshape(x.shape)
    shape = (1, C) + (1,) * (x.ndim - 2)
    return y * _w(W, f"{name}.weight").reshape(shape) + _w(W, f"{name}.bias").reshape(shape)


def rms_norm(W: Weights, name: str, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """weight * x / (sqrt(mean(x^2) + 1e-12) + eps)."""
    rms = torch.sqrt((x * x).mean(dim=-1, keepdim=True) + 1e-12)
    return _w(W, f"{name}.weight") * x / (rms + eps)


def tube_tokens(z: torch.Tensor, t: int, h: int, w: int) -> torch.Tensor:
    """[B, C, T, H, W] -> [B, (T/t)(H/h)(W/w), C*t*h*w]: tokens t-major then
    h then w, each token's features ordered (C, t, h, w)."""
    B, C, T, H, W_ = z.shape
    z = z.reshape(B, C, T // t, t, H // h, h, W_ // w, w).permute(0, 2, 4, 6, 1, 3, 5, 7)
    return z.reshape(B, (T // t) * (H // h) * (W_ // w), C * t * h * w)


def chunk_tokens(z: torch.Tensor, length: int, stride: int) -> torch.Tensor:
    """[B, C, F] -> [B, N, C*length], N = (F - length) // stride + 1, each
    token's features ordered (C, l)."""
    B, C, F_ = z.shape
    n = (F_ - length) // stride + 1
    idx = torch.arange(n, device=z.device)[:, None] * stride + torch.arange(length, device=z.device)
    win = z[:, :, idx]  # [B, C, N, l]
    return win.permute(0, 2, 1, 3).reshape(B, n, C * length)


def chunk_latent(tok: torch.Tensor, C: int, length: int, stride: int, F_: int) -> torch.Tensor:
    """Inverse of chunk_tokens by overlap-add, each frame the mean of the
    windows that hold it; frames no window holds are zero."""
    B, n, _ = tok.shape
    win = tok.reshape(B, n, C, length).permute(0, 2, 1, 3)  # [B, C, N, l]
    total = torch.zeros(B, C, F_, dtype=tok.dtype, device=tok.device)
    count = torch.zeros(F_, dtype=tok.dtype, device=tok.device)
    for i in range(n):
        lo = i * stride
        hi = min(lo + length, F_)
        total[:, :, lo:hi] += win[:, :, i, :hi - lo]
        count[lo:hi] += 1.0
    return total / torch.clamp(count, min=1.0)


# ---------------------------------------------------------------------------
# the model's parts
# ---------------------------------------------------------------------------


def encode_video(W: Weights, s: Dict, x: torch.Tensor) -> torch.Tensor:
    """x [B, 3, T, H, W] in [0, 1] -> the clean video latent."""
    td, sd = s["td"], s["sd"]
    if s["arch"] == "patch":
        B, C, T, H, W_ = x.shape
        p = x.reshape(B, C, T // td, td, H // sd, sd, W_ // sd, sd)
        p = p.permute(0, 2, 4, 6, 3, 5, 7, 1).reshape(B, T // td, H // sd, W_ // sd, -1)
        h = gelu(layer_norm(W, "vid_vae.patch_norm", dense(W, "vid_vae.patch_embed", p), 1e-6))
        h = h.permute(0, 4, 1, 2, 3)
        for i in range(s["enc_blocks"]):
            h = group_norm(W, f"vid_vae.enc.{i}.norm", gelu(conv(W, f"vid_vae.enc.{i}.conv", h)))
    else:
        h = x
        for i in range(s["enc_blocks"]):
            h = group_norm(W, f"vid_vae.enc.{i}.norm", gelu(conv(W, f"vid_vae.enc.{i}.conv", h)))
        h = F.avg_pool3d(h, kernel_size=(td, sd, sd))
    return latent_norm(s, conv(W, "vid_vae.to_lat", h))


def latent_norm(s: Dict, z: torch.Tensor) -> torch.Tensor:
    """Per-sample RMS normalisation when model.latent_rmsnorm."""
    if not s["latent_rmsnorm"]:
        return z
    return z / torch.sqrt((z * z).mean(dim=tuple(range(1, z.ndim)), keepdim=True) + 1e-8)


def decode_audio(W: Weights, s: Dict, z: torch.Tensor) -> torch.Tensor:
    """z [B, Ca, Fa] -> waveform [B, Fa * hop] in [-1, 1]."""
    h = conv(W, "aud_codec.from_lat", z)
    h = torch.repeat_interleave(h, s["hop"], dim=-1)
    h = gelu(conv(W, "aud_codec.smooth0", h))
    h = gelu(conv(W, "aud_codec.smooth1", h))
    return torch.tanh(conv(W, "aud_codec.smooth2", h))[:, 0]


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """[B] -> [B, dim]: cos then sin of t * exp(-ln(10000) i / (dim/2))."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                         device=t.device) / half)
    ang = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(ang), torch.sin(ang)], dim=1)
    return F.pad(emb, (0, dim % 2))


def pos3d(W: Weights, prefix: str, grid: Tuple[int, int, int]) -> torch.Tensor:
    Tt, Hh, Ww = grid
    pe = (_w(W, f"{prefix}.t_table")[:Tt, None, None]
          + _w(W, f"{prefix}.h_table")[None, :Hh, None]
          + _w(W, f"{prefix}.w_table")[None, None, :Ww])
    return pe.reshape(Tt * Hh * Ww, -1)


def attention(W: Weights, prefix: str, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    B, N, d = x.shape
    qkv = dense(W, f"{prefix}.qkv", x).reshape(B, N, 3, n_heads, d // n_heads)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # [B, H, N, Dh]
    if _low(W):
        q, k, v = fp8(q), fp8(k), fp8(v)
    probs = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d // n_heads), dim=-1)
    out = (fp8(probs) if _low(W) else probs) @ v
    return dense(W, f"{prefix}.out", out.transpose(1, 2).reshape(B, N, d))


def core(W: Weights, s: Dict, x: torch.Tensor) -> torch.Tensor:
    for i in range(s["layers"]):
        p = f"core.blocks.{i}"
        x = x + attention(W, f"{p}.attn", rms_norm(W, f"{p}.norm1", x), s["heads"])
        h = gelu(dense(W, f"{p}.mlp.fc1", rms_norm(W, f"{p}.norm2", x)), s["gelu_exact"])
        x = x + dense(W, f"{p}.mlp.fc2", h)
    return rms_norm(W, "core.norm", x)


def head(W: Weights, s: Dict, modality: str, h: torch.Tensor) -> torch.Tensor:
    h = dense(W, f"head.input_proj_{modality}", h)
    for i in range(s["head_layers"]):
        h = gelu(layer_norm(W, f"head.shared.{i}.norm", dense(W, f"head.shared.{i}.dense", h),
                            1e-5))
    return dense(W, f"head.out_proj_{modality}", h)


def denoise(W: Weights, s: Dict, target: str, tok_v, tok_a, t_v, t_a, grid, keep_v, keep_a,
            tok_m=None, keep_m=None, mgrid=None) -> torch.Tensor:
    """The `target` head's prediction over the joint sequence [video; audio;
    mouth]."""
    tab = _w(W, "embed.modality.table")
    d = s["d"]
    xv = dense(W, "adapt_v.proj", tok_v) + tab[0] + pos3d(W, "embed.pos_v", grid)
    xa = dense(W, "adapt_a.proj", tok_a) + tab[1] + _w(W, "embed.pos_a.table")[:tok_a.shape[1]]
    xv = (xv + timestep_embedding(t_v, d)[:, None]) * keep_v[:, None, None]
    xa = (xa + timestep_embedding(t_a, d)[:, None]) * keep_a[:, None, None]
    parts = [xv, xa]
    if tok_m is not None:
        xm = dense(W, "adapt_m.proj", tok_m) + tab[2] + pos3d(W, "embed.pos_m", mgrid)
        xm = (xm + timestep_embedding(torch.zeros_like(t_v), d)[:, None]) * keep_m[:, None, None]
        parts.append(xm)
    h = core(W, s, torch.cat(parts, dim=1))
    nv, na = tok_v.shape[1], tok_a.shape[1]
    if target == "audio":
        return head(W, s, "audio", h[:, nv:nv + na])
    return head(W, s, "video", h[:, :nv])


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------


def alpha_bar(dc: Dict) -> np.ndarray:
    """Cumulative product of 1 - beta for the config's schedule (float32),
    cosine (Nichol and Dhariwal, s = 0.008) or linear; betas clipped to
    [1e-8, 0.999]."""
    steps, kind = int(dc["steps"]), str(dc["schedule"]).lower()
    if kind == "cosine":
        s = 0.008
        t = np.linspace(0.0, steps, steps + 1, dtype=np.float32)
        f = np.cos(((t / steps + s) / (1.0 + s)) * math.pi / 2.0) ** 2
        betas = (1.0 - (f / f[0])[1:] / (f / f[0])[:-1]).astype(np.float32)
    elif kind == "linear":
        betas = np.linspace(float(dc["min_beta"]), float(dc["max_beta"]), steps,
                            dtype=np.float32)
    else:
        raise ValueError(f"the reference covers cosine and linear schedules, not {kind!r}")
    betas = np.clip(betas, 1e-8, 0.999).astype(np.float32)
    return np.cumprod(1.0 - betas, axis=0).astype(np.float32)


def ddim_schedule(train_steps: int, sample_steps: int) -> np.ndarray:
    return np.round(np.linspace(train_steps - 1, -1, sample_steps + 1)).astype(np.int32)


def ddim_update(x: torch.Tensor, pred: torch.Tensor, a_t: float, a_prev: float,
                param: str) -> torch.Tensor:
    """One deterministic DDIM step x_t -> x_prev from the model's prediction
    under `param`."""
    sa, so = math.sqrt(a_t), math.sqrt(max(1.0 - a_t, 0.0))
    if param == "eps":
        x0, eps = (x - so * pred) / max(sa, 1e-8), pred
    elif param == "x0":
        x0 = pred
        eps = (x - sa * x0) / max(so, 1e-4)
    elif param == "v":
        x0, eps = sa * x - so * pred, so * x + sa * pred
    else:
        raise ValueError(f"unknown param {param!r}")
    return math.sqrt(a_prev) * x0 + math.sqrt(max(1.0 - a_prev, 0.0)) * eps


class Prompt:
    """What the sampler derives once from a batch of video prompts: the
    video tokens, the mouth tokens, the CFG keep masks and the schedule."""

    def __init__(self, W: Weights, cfg: Dict, frames_u8: torch.Tensor):
        if cfg["sampling"].get("sampler", "ddim") != "ddim" or float(
                cfg["sampling"].get("ddim_eta", 0.0)) != 0.0:
            raise ValueError("the reference covers deterministic DDIM (eta 0)")
        if float(cfg["sampling"].get("cfg_rescale", 0.0)) or float(
                cfg["sampling"].get("sync_guidance_scale", 0.0)):
            raise ValueError("the reference covers plain classifier-free guidance")
        s = self.s = sizes(cfg)
        dev = self.device = frames_u8.device
        x = frames_u8.float().permute(0, 4, 1, 2, 3) / 255.0  # [B, 3, T, H, W]
        B, T = x.shape[0], x.shape[2]
        self.B = B
        if T % s["td"] or (s["mouth"] and T % s["mouth_tube"][0]):
            raise ValueError("the reference takes clips whose frame count the tubes divide")
        z_v = encode_video(W, s, x)
        t, h, w = s["tube"]
        self.tok_v2 = torch.cat([tube_tokens(z_v, t, h, w)] * 2)
        self.grid = (z_v.shape[2] // t, z_v.shape[3] // h, z_v.shape[4] // w)
        self.tok_m = self.mgrid = None
        ones, zeros = torch.ones(B, device=dev), torch.zeros(B, device=dev)
        self.keep_p = torch.cat([ones, zeros])  # conditional half, then the null half
        if s["mouth"]:
            h0, h1, w0, w1 = s["mouth_box"]
            mt, mh, mw = s["mouth_tube"]
            self.tok_m = torch.cat([tube_tokens(x[:, :, :, h0:h1, w0:w1] - 0.5, mt, mh, mw)] * 2)
            self.mgrid = (T // mt, (h1 - h0) // mh, (w1 - w0) // mw)
        dc = cfg["diffusion"]["audio"]
        self.abar = alpha_bar(dc)
        self.sched = ddim_schedule(int(dc["steps"]), int(dc["sampler_steps"]))
        self.g = float(cfg["sampling"]["guidance_scale"].get("audio", 3.0))
        self.param = str(dc.get("param", "eps"))


@torch.no_grad()
def guided(W: Weights, P: Prompt, z: torch.Tensor, k: int) -> torch.Tensor:
    """The guided prediction of the sampler's pass k (1 for the first) at
    the audio latent z [B, Ca, Fa]: tokens [B, Na, Ca*l],
    eps_null + g (eps_cond - eps_null)."""
    B, dev = P.B, P.device
    tok_a = chunk_tokens(z.float(), *P.s["chunk"])
    t_a = torch.full((2 * B,), int(P.sched[k - 1]), dtype=torch.long, device=dev)
    eps = denoise(W, P.s, "audio", P.tok_v2, torch.cat([tok_a, tok_a]),
                  torch.zeros(2 * B, dtype=torch.long, device=dev), t_a, P.grid, P.keep_p,
                  torch.ones(2 * B, device=dev), P.tok_m, P.keep_p, P.mgrid)
    return eps[B:] + P.g * (eps[:B] - eps[B:])


@torch.no_grad()
def sample_v2a(W: Weights, P: Prompt, z_init: torch.Tensor,
               passes=()) -> Tuple[torch.Tensor, torch.Tensor, Dict[int, Tuple]]:
    """Video-to-audio sampling of a batch of prompts P (``Prompt`` of frames
    [B, T, H, W, 3] uint8) from the initial audio latent noise z_init
    [B, Ca, Fa] -> (waveforms [B, L], the sampled audio latent [B, Ca, Fa],
    and for each pass k in `passes` the latent it read and its guided
    prediction tokens), float32 on the frames' device."""
    length, stride = P.s["chunk"]
    z = z_init.float().to(P.device)
    kept = {}
    for k, (t_now, t_prev) in enumerate(zip(P.sched[:-1], P.sched[1:]), start=1):
        eps = guided(W, P, z, k)
        if k in passes:
            kept[k] = (z, eps)
        pred = chunk_latent(eps, P.s["Ca"], length, stride, z.shape[-1])
        a_t = float(P.abar[max(int(t_now), 0)])
        a_prev = 1.0 if t_prev < 0 else float(P.abar[int(t_prev)])
        z = ddim_update(z, pred, a_t, a_prev, P.param)
    return decode_audio(W, P.s, z), z, kept
