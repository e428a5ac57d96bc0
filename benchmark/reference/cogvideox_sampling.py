"""Plain PyTorch reference of CogVideoX text-to-video sampling, written from
the published description (arXiv:2408.06072; diffusers'
``CogVideoXTransformer3DModel``, ``CogVideoXDDIMScheduler``,
``CogVideoXPipeline`` and ``AutoencoderKLCogVideoX`` at the THUDM/CogVideoX-5b
configs) and kept apart from the program under test: it imports nothing of
it.

Everything runs in float32 with TF32 off: no kernels, no fused ops, softmax
attention computed a block of queries at a time so that the scores of 17 776
tokens fit. Weights are a mapping from diffusers' parameter names (the VAE
decoder's under ``vae.decoder.``) to tensors, made by the benchmark and
handed to both sides; this module reads each one, upcast to float32, where
it is used.

  emb = linear_2(silu(linear_1([cos, sin](t exp(-ln(1e4) i / 1536)))))
  text = text_proj(T5 states); video = Conv2d(16 -> d, k = s = 2) per frame,
      tokens (frame, row, col); the sequence is [text; video]
  block: LayerNormZero (one LN, (shift, scale, gate) for the video rows and
      enc_ ones for the text rows, from Linear(silu(emb)) in that order);
      q, k, v of [text'; video'], per-head LayerNorm of q and k, RoPE on the
      video rows only (rotation matrices of adjacent pairs, axes frame / row
      / col over [16, 24, 24] dims, angles in float64); attention; to_out;
      gated residuals; the same for the MLP (GELU tanh)
  out: proj_out((1 + scale) LN(norm_final(video)) + shift), unpatchified
  DDIM (CogVideoXDDIMScheduler): scaled_linear betas in float64, alpha_bar
      rescaled to zero terminal SNR on its square roots, 'trailing' steps,
      v-prediction: x0 = sqrt(a) x - sqrt(1 - a) v, x_prev = sqrt((1 - a_prev)
      / (1 - a)) x + (sqrt(a_prev) - sqrt(a) sqrt((1 - a_prev) / (1 - a))) x0;
      [uncond; cond] at guidance g: v_u + g (v_c - v_u)
  VAE decoder on z / 0.7 in batches of latent frames (3, then 2s): causal
      3-D convolutions (time padded by the first frame or the frames the
      last batch left), SpatialNorm3D (GroupNorm times conv_y(zq) plus
      conv_b(zq), zq resized by nearest with its first frame apart when the
      frame count is odd), resnets, x2 upsampling (time too in the first two
      up blocks, the first frame kept single); frames (x / 2 + 0.5) clamped

Departures from the source: the latent and the transformer's streams stay
float32 (the source's are bf16), and the text rows skip RoPE by slicing
(the source writes the rotated video rows back into q and k).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .av_sampling import Fp8Weights, _low, fp8  # noqa: F401 (the drivers use Fp8Weights)

Weights = Mapping[str, torch.Tensor]
VAE = "vae.decoder"
FRAME_BATCH = 2  # diffusers' num_latent_frames_batch_size, fixed in its code


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# the configuration's parameters
# ---------------------------------------------------------------------------


def dims(cfg: Dict) -> Dict:
    c, v = cfg["model"]["core"], cfg["model"]["vae"]
    H = int(c["n_heads"])
    Dh = int(c["d_model"]) // H
    r = int(v["temporal_compression_ratio"])
    return {"d": H * Dh, "H": H, "Dh": Dh, "m": int(H * Dh * float(c["mlp_ratio"])),
            "layers": int(c["n_layers"]), "cin": int(c["in_channels"]),
            "cout": int(c["out_channels"]), "p": int(c["patch_size"]),
            "text": int(c["text_embed_dim"]), "temb": int(c["time_embed_dim"]),
            "eps": float(c["norm_eps"]), "qk_eps": float(c["qk_norm_eps"]),
            "axes": [int(a) for a in c["axes_dim"]], "theta": float(c["theta"]),
            "chans": [int(x) for x in v["block_out_channels"]], "z": int(v["latent_channels"]),
            "rgb": int(v["out_channels"]), "lpb": int(v["layers_per_block"]),
            "groups": int(v["norm_num_groups"]), "gn_eps": float(v["norm_eps"]),
            "scale": float(v["scaling_factor"]), "tlevels": int(round(math.log2(r)))}


def param_shapes(cfg: Dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of the transformer and of the VAE decoder (under
    ``vae.decoder.``), by diffusers' names, in its order."""
    s = dims(cfg)
    d, m = s["d"], s["m"]
    out: Dict[str, Tuple[int, ...]] = {}

    def lin(name, d_in, d_out):
        out[f"{name}.weight"], out[f"{name}.bias"] = (d_out, d_in), (d_out,)

    def ln(name, c):
        out[f"{name}.weight"], out[f"{name}.bias"] = (c,), (c,)

    def conv(name, c_in, c_out, k):
        out[f"{name}.weight"], out[f"{name}.bias"] = (c_out, c_in) + tuple(k), (c_out,)

    conv("patch_embed.proj", s["cin"], d, (s["p"], s["p"]))
    lin("patch_embed.text_proj", s["text"], d)
    lin("time_embedding.linear_1", d, s["temb"])
    lin("time_embedding.linear_2", s["temb"], s["temb"])
    for i in range(s["layers"]):
        p = f"transformer_blocks.{i}"
        lin(f"{p}.norm1.linear", s["temb"], 6 * d)
        ln(f"{p}.norm1.norm", d)
        for x in ("to_q", "to_k", "to_v"):
            lin(f"{p}.attn1.{x}", d, d)
        ln(f"{p}.attn1.norm_q", s["Dh"])
        ln(f"{p}.attn1.norm_k", s["Dh"])
        lin(f"{p}.attn1.to_out.0", d, d)
        lin(f"{p}.norm2.linear", s["temb"], 6 * d)
        ln(f"{p}.norm2.norm", d)
        lin(f"{p}.ff.net.0.proj", d, m)
        lin(f"{p}.ff.net.2", m, d)
    ln("norm_final", d)
    lin("norm_out.linear", s["temb"], 2 * d)
    ln("norm_out.norm", d)
    lin("proj_out", d, s["p"] ** 2 * s["cout"])

    k3, k1 = (3, 3, 3), (1, 1, 1)

    def snorm(name, c):
        ln(f"{name}.norm_layer", c)
        conv(f"{name}.conv_y.conv", s["z"], c, k1)
        conv(f"{name}.conv_b.conv", s["z"], c, k1)

    def res(name, c_in, c_out):
        snorm(f"{name}.norm1", c_in)
        conv(f"{name}.conv1.conv", c_in, c_out, k3)
        snorm(f"{name}.norm2", c_out)
        conv(f"{name}.conv2.conv", c_out, c_out, k3)
        if c_in != c_out:
            conv(f"{name}.conv_shortcut", c_in, c_out, k1)

    ch = list(reversed(s["chans"]))
    conv(f"{VAE}.conv_in.conv", s["z"], ch[0], k3)
    for j in range(2):
        res(f"{VAE}.mid_block.resnets.{j}", ch[0], ch[0])
    for i, c_out in enumerate(ch):
        c_in = ch[max(i - 1, 0)]
        for j in range(s["lpb"] + 1):
            res(f"{VAE}.up_blocks.{i}.resnets.{j}", c_in if j == 0 else c_out, c_out)
        if i < len(ch) - 1:
            conv(f"{VAE}.up_blocks.{i}.upsamplers.0.conv", c_out, c_out, (3, 3))
    snorm(f"{VAE}.norm_out", ch[-1])
    conv(f"{VAE}.conv_out.conv", ch[-1], s["rgb"], k3)
    return out


def is_norm_scale(name: str) -> bool:
    """A normalisation layer's scale: a LayerNorm's or GroupNorm's
    ``weight``."""
    parts = name.split(".")
    return parts[-1] == "weight" and "norm" in parts[-2]


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _w(W: Weights, name: str) -> torch.Tensor:
    return W[name].float()


def linear(W: Weights, name: str, x: torch.Tensor) -> torch.Tensor:
    w = _w(W, f"{name}.weight")
    if _low(W):
        x, w = fp8(x), fp8(w)
    return x @ w.t() + _w(W, f"{name}.bias")


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def layer_norm(W: Weights, name: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * _w(W, f"{name}.weight") + _w(W, f"{name}.bias")


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """[B] -> [B, dim]: cos then sin of t exp(-ln(10000) i / (dim / 2))."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                         device=t.device) / half)
    ang = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=1)


# ---------------------------------------------------------------------------
# RoPE and attention
# ---------------------------------------------------------------------------


def rope(s: Dict, frames: int, h: int, w: int, device) -> torch.Tensor:
    """[frames h w, Dh / 2, 2, 2] rotation matrices [[cos, -sin], [sin, cos]]
    of each adjacent pair of a head, the tokens frame-major: the frame's
    pairs, then the row's, then the column's."""
    pos = torch.stack(torch.meshgrid(torch.arange(frames), torch.arange(h), torch.arange(w),
                                     indexing="ij"), -1).reshape(-1, 3).to(device)
    mats = []
    for a, dim in enumerate(s["axes"]):
        omega = 1.0 / s["theta"] ** (torch.arange(0, dim, 2, dtype=torch.float64,
                                                  device=device) / dim)
        ang = pos[:, a].double()[:, None] * omega[None]
        cos, sin = torch.cos(ang), torch.sin(ang)
        mats.append(torch.stack([torch.stack([cos, -sin], -1), torch.stack([sin, cos], -1)], -2))
    return torch.cat(mats, dim=1).float()


def rotate(x: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """x [B, H, n, Dh]: each pair (x_2i, x_2i+1) times its matrix."""
    pairs = x.reshape(*x.shape[:-1], -1, 2)
    return torch.einsum("nkij,bhnkj->bhnki", R, pairs).reshape(x.shape)


def softmax_attention(W: Weights, q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """[B, H, N, Dh] each: softmax(q k^T / sqrt(Dh)) v, a block of queries at
    a time (at most 2^29 scores a block)."""
    if _low(W):
        q, k, v = fp8(q), fp8(k), fp8(v)
    B, H, N, Dh = q.shape
    blk = max(16, (1 << 29) // (B * H * N))
    out = torch.empty_like(q)
    kt = k.transpose(-1, -2)
    for lo in range(0, N, blk):
        probs = torch.softmax(q[:, :, lo:lo + blk] @ kt / math.sqrt(Dh), dim=-1)
        out[:, :, lo:lo + blk] = (fp8(probs) if _low(W) else probs) @ v
    return out


# ---------------------------------------------------------------------------
# the transformer
# ---------------------------------------------------------------------------


def heads(x: torch.Tensor, n: int) -> torch.Tensor:
    B, N, D = x.shape
    return x.reshape(B, N, n, D // n).transpose(1, 2)


def block(W: Weights, s: Dict, i: int, video, text, emb, R):
    p = f"transformer_blocks.{i}"
    L = text.shape[1]

    def modulate(name, video, text):
        sh, sc, g, esh, esc, eg = linear(W, f"{name}.linear", silu(emb))[:, None].chunk(6, -1)
        v = layer_norm(W, f"{name}.norm", video, s["eps"]) * (1 + sc) + sh
        t = layer_norm(W, f"{name}.norm", text, s["eps"]) * (1 + esc) + esh
        return torch.cat((t, v), 1), g, eg

    x, g, eg = modulate(f"{p}.norm1", video, text)
    q, k, v = (heads(linear(W, f"{p}.attn1.to_{n}", x), s["H"]) for n in ("q", "k", "v"))
    q = layer_norm(W, f"{p}.attn1.norm_q", q, s["qk_eps"])
    k = layer_norm(W, f"{p}.attn1.norm_k", k, s["qk_eps"])
    q = torch.cat((q[:, :, :L], rotate(q[:, :, L:], R)), 2)
    k = torch.cat((k[:, :, :L], rotate(k[:, :, L:], R)), 2)
    a = softmax_attention(W, q, k, v)
    B, H, N, Dh = a.shape
    a = linear(W, f"{p}.attn1.to_out.0", a.transpose(1, 2).reshape(B, N, H * Dh))
    video, text = video + g * a[:, L:], text + eg * a[:, :L]
    x, g, eg = modulate(f"{p}.norm2", video, text)
    h = linear(W, f"{p}.ff.net.2", gelu_tanh(linear(W, f"{p}.ff.net.0.proj", x)))
    return video + g * h[:, L:], text + eg * h[:, :L]


@torch.no_grad()
def velocity(W: Weights, cfg: Dict, x: torch.Tensor, ctx: torch.Tensor,
             t: int) -> torch.Tensor:
    """The transformer's v-prediction at latents x [B, F, C, H, W] for T5
    states ctx [B, L, 4096] at the integer timestep t."""
    no_tf32()
    s = dims(cfg)
    B, Fr, C, Hh, Ww = x.shape
    p = s["p"]
    h, w = Hh // p, Ww // p
    emb = timestep_embedding(torch.full((B,), t, device=x.device), s["d"])
    emb = linear(W, "time_embedding.linear_2", silu(linear(W, "time_embedding.linear_1", emb)))
    text = linear(W, "patch_embed.text_proj", ctx.float())
    wp = _w(W, "patch_embed.proj.weight")
    frames = x.float().reshape(B * Fr, C, Hh, Ww)
    if _low(W):
        frames, wp = fp8(frames), fp8(wp)
    video = F.conv2d(frames, wp, _w(W, "patch_embed.proj.bias"), stride=p)
    video = video.flatten(2).transpose(1, 2).reshape(B, Fr * h * w, s["d"])
    R = rope(s, Fr, h, w, x.device)
    for i in range(s["layers"]):
        video, text = block(W, s, i, video, text, emb, R)
    sh, sc = linear(W, "norm_out.linear", silu(emb))[:, None].chunk(2, -1)
    out = layer_norm(W, "norm_out.norm", layer_norm(W, "norm_final", video, s["eps"]),
                     s["eps"]) * (1 + sc) + sh
    out = linear(W, "proj_out", out).reshape(B, Fr, h, w, s["cout"], p, p)
    return out.permute(0, 1, 4, 2, 5, 3, 6).reshape(B, Fr, s["cout"], Hh, Ww)


def guided(W: Weights, cfg: Dict, x: torch.Tensor, text: torch.Tensor, negative: torch.Tensor,
           t: int, guidance: float) -> torch.Tensor:
    """v_u + g (v_c - v_u) at latents x [B, ...], the negative prompt's
    states giving v_u and the prompt's v_c."""
    B = x.shape[0]
    v = velocity(W, cfg, torch.cat((x, x)), torch.cat((negative, text)), t)
    return v[:B] + guidance * (v[B:] - v[:B])


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------


def schedule(cfg: Dict) -> Tuple[np.ndarray, List[int]]:
    """(alpha_bar [T] float64, the sampler's timesteps then -1)."""
    d = cfg["diffusion"]
    T, steps = int(d["train_steps"]), int(cfg["sampling"]["steps"])
    if str(d["beta_schedule"]) != "scaled_linear" or str(d["timestep_spacing"]) != "trailing":
        raise ValueError("the reference covers scaled_linear betas at trailing timesteps")
    betas = np.linspace(float(d["beta_start"]) ** 0.5, float(d["beta_end"]) ** 0.5, T,
                        dtype=np.float64) ** 2
    abar = np.cumprod(1.0 - betas)
    if bool(d["rescale_zero_terminal_snr"]):
        r = np.sqrt(abar)
        r = (r - r[-1]) * r[0] / (r[0] - r[-1])
        abar = r ** 2
    ts = [int(t) - 1 for t in np.round(np.arange(T, 0, -T / steps))]
    return abar, ts + [-1]


def ddim_update(x: torch.Tensor, v: torch.Tensor, a: float, a_prev: float) -> torch.Tensor:
    """CogVideoXDDIMScheduler.step (eta 0, v-prediction) from x_t to x_prev."""
    x0 = math.sqrt(a) * x - math.sqrt(1.0 - a) * v
    c = math.sqrt((1.0 - a_prev) / (1.0 - a))
    return c * x + (math.sqrt(a_prev) - math.sqrt(a) * c) * x0


def step_alphas(abar: np.ndarray, ts: List[int], k: int) -> Tuple[float, float]:
    """(alpha_bar at pass k's timestep, at the next; 1 past the last)."""
    t, t_prev = ts[k - 1], ts[k]
    return float(abar[t]), 1.0 if t_prev < 0 else float(abar[t_prev])


@torch.no_grad()
def sample(W: Weights, cfg: Dict, noise: torch.Tensor, text: torch.Tensor,
           negative: torch.Tensor, keep: Iterable[int] = ()
           ) -> Tuple[torch.Tensor, Dict[int, Tuple]]:
    """The whole DDIM run from noise [B, F, C, h, w]: the final latent and,
    for each pass k (1-based) in `keep`, (the latent it read, its guided
    v)."""
    abar, ts = schedule(cfg)
    g, keep = float(cfg["sampling"]["guidance"]), set(keep)
    x, seen = noise.float(), {}
    for k in range(1, len(ts)):
        v = guided(W, cfg, x, text, negative, ts[k - 1], g)
        if k in keep:
            seen[k] = (x.clone(), v)
        x = ddim_update(x, v, *step_alphas(abar, ts, k))
    return x, seen


# ---------------------------------------------------------------------------
# the VAE decoder
# ---------------------------------------------------------------------------


def resize_nearest(x: torch.Tensor, size: Tuple[int, ...]) -> torch.Tensor:
    """Nearest resize of the trailing len(size) dims: output i reads input
    floor(i in / out)."""
    for j, n in enumerate(size):
        dim = x.ndim - len(size) + j
        idx = (torch.arange(n, device=x.device) * x.shape[dim]) // n
        x = x.index_select(dim, idx)
    return x


def group_norm(W: Weights, name: str, x: torch.Tensor, groups: int, eps: float) -> torch.Tensor:
    B, C = x.shape[:2]
    xg = x.reshape(B, groups, -1)
    mu = xg.mean(dim=-1, keepdim=True)
    var = ((xg - mu) ** 2).mean(dim=-1, keepdim=True)
    y = ((xg - mu) / torch.sqrt(var + eps)).reshape(x.shape)
    shape = (1, C) + (1,) * (x.ndim - 2)
    return y * _w(W, f"{name}.weight").reshape(shape) + _w(W, f"{name}.bias").reshape(shape)


def conv3d(W: Weights, name: str, x: torch.Tensor) -> torch.Tensor:
    w = _w(W, f"{name}.weight")
    if _low(W):
        x, w = fp8(x), fp8(w)
    return F.conv3d(x, w, _w(W, f"{name}.bias"))


def causal_conv(W: Weights, name: str, x: torch.Tensor, cache: Dict) -> torch.Tensor:
    """Kernel 3: time padded on the left by the cache (the last two frames
    of the previous batch's padded input) or two copies of the first frame,
    space by one zero on each side."""
    head = cache.get(name, torch.cat([x[:, :, :1]] * 2, 2))
    x = torch.cat((head, x), 2)
    cache[name] = x[:, :, -2:]
    return conv3d(W, name, F.pad(x, (1, 1, 1, 1)))


def spatial_norm(W: Weights, s: Dict, name: str, f: torch.Tensor, zq: torch.Tensor):
    T, size = f.shape[2], tuple(f.shape[-2:])
    if T > 1 and T % 2 == 1:
        zq = torch.cat((resize_nearest(zq[:, :, :1], (1,) + size),
                        resize_nearest(zq[:, :, 1:], (T - 1,) + size)), 2)
    else:
        zq = resize_nearest(zq, (T,) + size)
    gn = group_norm(W, f"{name}.norm_layer", f, s["groups"], s["gn_eps"])
    return gn * conv3d(W, f"{name}.conv_y.conv", zq) + conv3d(W, f"{name}.conv_b.conv", zq)


def resnet(W: Weights, s: Dict, name: str, x, zq, cache):
    h = causal_conv(W, f"{name}.conv1.conv", silu(spatial_norm(W, s, f"{name}.norm1", x, zq)),
                    cache)
    h = causal_conv(W, f"{name}.conv2.conv", silu(spatial_norm(W, s, f"{name}.norm2", h, zq)),
                    cache)
    if f"{name}.conv_shortcut.weight" in W:
        x = conv3d(W, f"{name}.conv_shortcut", x)
    return x + h


def upsample(W: Weights, name: str, x: torch.Tensor, compress_time: bool) -> torch.Tensor:
    B, C, T, H, Wd = x.shape
    x = x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
    if compress_time and T > 1:
        rest = x[:, :, T % 2:].repeat_interleave(2, dim=2)
        x = torch.cat((x[:, :, :T % 2], rest), 2)
    w = _w(W, f"{name}.weight")
    frames = x.transpose(1, 2).reshape(-1, C, 2 * H, 2 * Wd)
    if _low(W):
        frames, w = fp8(frames), fp8(w)
    y = F.conv2d(frames, w, _w(W, f"{name}.bias"), padding=1)
    return y.reshape(B, -1, C, 2 * H, 2 * Wd).transpose(1, 2)


def decode_batch(W: Weights, s: Dict, z: torch.Tensor, cache: Dict) -> torch.Tensor:
    h = causal_conv(W, f"{VAE}.conv_in.conv", z, cache)
    for j in range(2):
        h = resnet(W, s, f"{VAE}.mid_block.resnets.{j}", h, z, cache)
    n = len(s["chans"])
    for i in range(n):
        for j in range(s["lpb"] + 1):
            h = resnet(W, s, f"{VAE}.up_blocks.{i}.resnets.{j}", h, z, cache)
        if i < n - 1:
            h = upsample(W, f"{VAE}.up_blocks.{i}.upsamplers.0.conv", h, i < s["tlevels"])
    h = silu(spatial_norm(W, s, f"{VAE}.norm_out", h, z))
    return causal_conv(W, f"{VAE}.conv_out.conv", h, cache)


@torch.no_grad()
def decode(W: Weights, cfg: Dict, z: torch.Tensor) -> torch.Tensor:
    """Latent [B, F, C, h, w] (the sampler's layout) -> frames [B, 3, 1 + 4
    (F - 1), 8 h, 8 w], not clamped, decoded in the source's batches of
    latent frames: FRAME_BATCH + F % FRAME_BATCH, then FRAME_BATCH at a time."""
    no_tf32()
    s = dims(cfg)
    z = z.float().permute(0, 2, 1, 3, 4) / s["scale"]
    Fr, n = z.shape[2], FRAME_BATCH
    rem = Fr % n
    batches = [(0, n + rem)] + [(a, a + n) for a in range(n + rem, Fr, n)]
    cache: Dict = {}
    return torch.cat([decode_batch(W, s, z[:, :, a:b], cache) for a, b in batches], 2)


def video_values(x: torch.Tensor) -> torch.Tensor:
    """Decoder output [B, 3, T, H, W] -> [B, T, H, W, 3] on the 0..255 scale
    of the frames written (255 clamp(x / 2 + 0.5, 0, 1)), not rounded."""
    return (255.0 * (x / 2 + 0.5).clamp(0.0, 1.0)).permute(0, 2, 3, 4, 1)
