"""Plain PyTorch reference of FLUX.1 text-to-image sampling, written from the
published equations (``github.com/black-forest-labs/flux``: ``src/flux/
model.py``, ``modules/layers.py``, ``math.py``, ``sampling.py`` and
``modules/autoencoder.py``) and kept apart from the program under test: it
imports nothing of it.

Everything runs in float32 with TF32 off: no kernels, no fused ops, dense
softmax attention. Weights are a mapping from the source's parameter names
(the AE decoder's under ``ae.decoder.``) to tensors, made by the benchmark
and handed to both sides; this module reads each one, upcast to float32,
where it is used, so on the card only one block's float32 copy lives beside
the bf16 weights at a time.

  vec = MLP_t(emb(t)) + MLP_g(emb(g)) + MLP_y(y), emb: [cos, sin] of 1000 t
  img = img_in(x), txt = txt_in(c); pe: RoPE rotation matrices per pair of
      each axis (16, 56, 56 dims of the 128), angles in float64
  double blocks: per stream (shift, scale, gate) x 2 from Linear(silu(vec));
      qkv of (1 + scale) LN(x) + shift, q and k RMS-normed per head, one
      attention over [txt; img] with RoPE, then gated proj and gated MLP
  single blocks on [txt; img]: linear1 -> q, k, v and the MLP input;
      x + gate linear2([attn; gelu_tanh(mlp)])
  last layer: Linear((1 + scale) LN(img) + shift)
  Euler over the shifted schedule, one pass a step, guidance embedded
  AE decoder: z / 0.3611 + 0.1159 -> conv_in -> mid (res, attn, res) ->
      up levels (res x 3, nearest x2 + conv) -> GN, swish, conv_out

Departures from the source: the latent stays float32 between steps, and the
positions are float64 when the angles are taken (the source's latent is
bf16 and its positions float32).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .av_sampling import Fp8Weights, _low, fp8  # noqa: F401 (the drivers use Fp8Weights)

Weights = Mapping[str, torch.Tensor]


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# the configuration's parameters
# ---------------------------------------------------------------------------


def _dims(cfg: Dict) -> Dict:
    c, a = cfg["model"]["core"], cfg["model"]["ae"]
    d = int(c["d_model"])
    return {"d": d, "H": int(c["n_heads"]), "m": int(d * float(c["mlp_ratio"])),
            "double": int(c["depth"]), "single": int(c["depth_single_blocks"]),
            "axes": [int(x) for x in c["axes_dim"]], "theta": float(c["theta"]),
            "cin": int(c["in_channels"]), "ctx": int(c["context_in_dim"]),
            "vec": int(c["vec_in_dim"]), "ch": int(a["ch"]), "out_ch": int(a["out_ch"]),
            "ch_mult": [int(x) for x in a["ch_mult"]], "res": int(a["num_res_blocks"]),
            "z": int(a["z_channels"]), "scale": float(a["scale_factor"]),
            "shift": float(a["shift_factor"])}


def param_shapes(cfg: Dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of the transformer and of the AE decoder (under
    ``ae.decoder.``), by the source's names, in its order."""
    s = _dims(cfg)
    d, m, hd = s["d"], s["m"], s["d"] // s["H"]
    out: Dict[str, Tuple[int, ...]] = {}

    def lin(name, d_in, d_out):
        out[f"{name}.weight"], out[f"{name}.bias"] = (d_out, d_in), (d_out,)

    lin("img_in", s["cin"], d)
    for name, d_in in (("time_in", 256), ("vector_in", s["vec"]), ("guidance_in", 256)):
        lin(f"{name}.in_layer", d_in, d)
        lin(f"{name}.out_layer", d, d)
    lin("txt_in", s["ctx"], d)
    for i in range(s["double"]):
        for st in ("img", "txt"):
            p = f"double_blocks.{i}.{st}"
            lin(f"{p}_mod.lin", d, 6 * d)
            lin(f"{p}_attn.qkv", d, 3 * d)
            out[f"{p}_attn.norm.query_norm.scale"] = (hd,)
            out[f"{p}_attn.norm.key_norm.scale"] = (hd,)
            lin(f"{p}_attn.proj", d, d)
            lin(f"{p}_mlp.0", d, m)
            lin(f"{p}_mlp.2", m, d)
    for i in range(s["single"]):
        p = f"single_blocks.{i}"
        lin(f"{p}.linear1", d, 3 * d + m)
        lin(f"{p}.linear2", d + m, d)
        out[f"{p}.norm.query_norm.scale"] = (hd,)
        out[f"{p}.norm.key_norm.scale"] = (hd,)
        lin(f"{p}.modulation.lin", d, 3 * d)
    lin("final_layer.linear", d, s["cin"])
    lin("final_layer.adaLN_modulation.1", d, 2 * d)

    def conv(name, c_in, c_out, k):
        out[f"{name}.weight"], out[f"{name}.bias"] = (c_out, c_in, k, k), (c_out,)

    def gn(name, c):
        out[f"{name}.weight"], out[f"{name}.bias"] = (c,), (c,)

    def res(name, c_in, c_out):
        gn(f"{name}.norm1", c_in)
        conv(f"{name}.conv1", c_in, c_out, 3)
        gn(f"{name}.norm2", c_out)
        conv(f"{name}.conv2", c_out, c_out, 3)
        if c_in != c_out:
            conv(f"{name}.nin_shortcut", c_in, c_out, 1)

    D = "ae.decoder"
    c_in = s["ch"] * s["ch_mult"][-1]
    conv(f"{D}.conv_in", s["z"], c_in, 3)
    res(f"{D}.mid.block_1", c_in, c_in)
    gn(f"{D}.mid.attn_1.norm", c_in)
    for x in ("q", "k", "v", "proj_out"):
        conv(f"{D}.mid.attn_1.{x}", c_in, c_in, 1)
    res(f"{D}.mid.block_2", c_in, c_in)
    for level in reversed(range(len(s["ch_mult"]))):
        c_out = s["ch"] * s["ch_mult"][level]
        for j in range(s["res"] + 1):
            res(f"{D}.up.{level}.block.{j}", c_in, c_out)
            c_in = c_out
        if level != 0:
            conv(f"{D}.up.{level}.upsample.conv", c_in, c_in, 3)
    gn(f"{D}.norm_out", c_in)
    conv(f"{D}.conv_out", c_in, s["out_ch"], 3)
    return out


def is_norm_scale(name: str) -> bool:
    """A normalisation layer's scale: QK-norm's ``scale``, GroupNorm's
    ``weight``."""
    parts = name.split(".")
    return parts[-1] == "scale" or (parts[-1] == "weight" and "norm" in parts[-2])


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


def conv2d(W: Weights, name: str, x: torch.Tensor) -> torch.Tensor:
    w = _w(W, f"{name}.weight")
    if _low(W):
        x, w = fp8(x), fp8(w)
    return F.conv2d(x, w, _w(W, f"{name}.bias"), padding=w.shape[-1] // 2)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps)


def rms_norm(W: Weights, name: str, x: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt((x * x).mean(dim=-1, keepdim=True) + 1e-6) * _w(W, name)


def group_norm(W: Weights, name: str, x: torch.Tensor, groups: int = 32) -> torch.Tensor:
    B, C = x.shape[:2]
    xg = x.reshape(B, groups, -1)
    mu = xg.mean(dim=-1, keepdim=True)
    var = ((xg - mu) ** 2).mean(dim=-1, keepdim=True)
    y = ((xg - mu) / torch.sqrt(var + 1e-6)).reshape(x.shape)
    return y * _w(W, f"{name}.weight")[None, :, None, None] + _w(
        W, f"{name}.bias")[None, :, None, None]


def softmax_attention(W: Weights, q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """[..., N, Dh] each: softmax(q k^T / sqrt(Dh)) v."""
    if _low(W):
        q, k, v = fp8(q), fp8(k), fp8(v)
    probs = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1]), dim=-1)
    return (fp8(probs) if _low(W) else probs) @ v


def timestep_embedding(t: torch.Tensor, dim: int = 256) -> torch.Tensor:
    """[B] -> [B, dim]: cos then sin of 1000 t exp(-ln(10000) i / (dim / 2))."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                         device=t.device) / half)
    ang = 1000.0 * t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=1)


def mlp_embedder(W: Weights, name: str, x: torch.Tensor) -> torch.Tensor:
    return linear(W, f"{name}.out_layer", silu(linear(W, f"{name}.in_layer", x)))


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(ids: torch.Tensor, axes: List[int], theta: float) -> torch.Tensor:
    """ids [N, n_axes] -> [N, Dh / 2, 2, 2] rotation matrices [[cos, -sin],
    [sin, cos]] of each adjacent pair, the axes' pairs in order."""
    mats = []
    for a, dim in enumerate(axes):
        omega = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float64,
                                             device=ids.device) / dim)
        ang = ids[:, a].double()[:, None] * omega[None]
        cos, sin = torch.cos(ang), torch.sin(ang)
        mats.append(torch.stack([torch.stack([cos, -sin], -1),
                                 torch.stack([sin, cos], -1)], -2))
    return torch.cat(mats, dim=1).float()


def apply_rope(x: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """x [B, H, N, Dh]: each pair (x_2i, x_2i+1) times its matrix."""
    pairs = x.reshape(*x.shape[:-1], -1, 2)
    return torch.einsum("nkij,bhnkj->bhnki", R, pairs).reshape(x.shape)


def heads(x: torch.Tensor, n: int) -> torch.Tensor:
    B, N, D = x.shape
    return x.reshape(B, N, n, D // n).transpose(1, 2)


def attention(W: Weights, q, k, v, R) -> torch.Tensor:
    out = softmax_attention(W, apply_rope(q, R), apply_rope(k, R), v)
    B, H, N, Dh = out.shape
    return out.transpose(1, 2).reshape(B, N, H * Dh)


# ---------------------------------------------------------------------------
# the transformer
# ---------------------------------------------------------------------------


def modulation(W: Weights, name: str, vec: torch.Tensor, n: int) -> List[torch.Tensor]:
    return list(linear(W, name, silu(vec))[:, None, :].chunk(n, dim=-1))


def double_block(W: Weights, s: Dict, i: int, img, txt, vec, R):
    p = f"double_blocks.{i}"
    mods, qkv = {}, {}
    for st, x in (("img", img), ("txt", txt)):
        mods[st] = modulation(W, f"{p}.{st}_mod.lin", vec, 6)
        sh, sc = mods[st][0], mods[st][1]
        q, k, v = linear(W, f"{p}.{st}_attn.qkv", (1 + sc) * layer_norm(x) + sh).chunk(3, -1)
        q = rms_norm(W, f"{p}.{st}_attn.norm.query_norm.scale", heads(q, s["H"]))
        k = rms_norm(W, f"{p}.{st}_attn.norm.key_norm.scale", heads(k, s["H"]))
        qkv[st] = (q, k, heads(v, s["H"]))
    q, k, v = (torch.cat((qkv["txt"][j], qkv["img"][j]), dim=2) for j in range(3))
    attn = attention(W, q, k, v, R)
    L = txt.shape[1]
    out = {}
    for st, x, a in (("img", img, attn[:, L:]), ("txt", txt, attn[:, :L])):
        sh1, sc1, g1, sh2, sc2, g2 = mods[st]
        x = x + g1 * linear(W, f"{p}.{st}_attn.proj", a)
        h = gelu_tanh(linear(W, f"{p}.{st}_mlp.0", (1 + sc2) * layer_norm(x) + sh2))
        out[st] = x + g2 * linear(W, f"{p}.{st}_mlp.2", h)
    return out["img"], out["txt"]


def single_block(W: Weights, s: Dict, i: int, x, vec, R):
    p = f"single_blocks.{i}"
    sh, sc, g = modulation(W, f"{p}.modulation.lin", vec, 3)
    h = linear(W, f"{p}.linear1", (1 + sc) * layer_norm(x) + sh)
    d = s["d"]
    q, k, v = (heads(h[..., j * d:(j + 1) * d], s["H"]) for j in range(3))
    q = rms_norm(W, f"{p}.norm.query_norm.scale", q)
    k = rms_norm(W, f"{p}.norm.key_norm.scale", k)
    a = attention(W, q, k, v, R)
    return x + g * linear(W, f"{p}.linear2", torch.cat((a, gelu_tanh(h[..., 3 * d:])), -1))


def velocity(W: Weights, cfg: Dict, x: torch.Tensor, txt: torch.Tensor, y: torch.Tensor,
             t: float, guidance: float, hw: Tuple[int, int]) -> torch.Tensor:
    """The transformer's velocity at packed latent x [B, h w, 64] and time
    t, for T5 embeddings txt [B, L, 4096], pooled y [B, 768] and the
    guidance, the image tokens on the h x w grid."""
    no_tf32()
    s = _dims(cfg)
    B = x.shape[0]
    tv = torch.full((B,), t, device=x.device)
    gv = torch.full((B,), guidance, device=x.device)
    vec = (mlp_embedder(W, "time_in", timestep_embedding(tv))
           + mlp_embedder(W, "guidance_in", timestep_embedding(gv))
           + mlp_embedder(W, "vector_in", y.float()))
    img = linear(W, "img_in", x.float())
    tx = linear(W, "txt_in", txt.float())
    h, w = hw
    ids = torch.zeros(tx.shape[1] + h * w, 3, device=x.device)
    rows, cols = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    ids[tx.shape[1]:, 1] = rows.reshape(-1).float().to(x.device)
    ids[tx.shape[1]:, 2] = cols.reshape(-1).float().to(x.device)
    R = rope(ids, s["axes"], s["theta"])
    for i in range(s["double"]):
        img, tx = double_block(W, s, i, img, tx, vec, R)
    z = torch.cat((tx, img), dim=1)
    for i in range(s["single"]):
        z = single_block(W, s, i, z, vec, R)
    sh, sc = linear(W, "final_layer.adaLN_modulation.1", silu(vec))[:, None].chunk(2, -1)
    return linear(W, "final_layer.linear", (1 + sc) * layer_norm(z[:, tx.shape[1]:]) + sh)


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------


def schedule(cfg: Dict) -> List[float]:
    """linspace(1, 0, steps + 1) through t -> e^mu / (e^mu + 1/t - 1), mu
    on the line through (256, base_shift) and (4096, max_shift) at the
    image's tokens."""
    sp = cfg["sampling"]
    n_img = (int(sp["height"]) // 16) * (int(sp["width"]) // 16)
    slope = (float(sp["max_shift"]) - float(sp["base_shift"])) / (4096 - 256)
    mu = float(sp["base_shift"]) + slope * (n_img - 256)
    ts = np.linspace(1.0, 0.0, int(sp["steps"]) + 1)
    with np.errstate(divide="ignore"):
        shifted = np.exp(mu) / (np.exp(mu) + (1.0 / ts - 1.0))
    return [float(v) for v in shifted]


def grid(cfg: Dict) -> Tuple[int, int]:
    return int(cfg["sampling"]["height"]) // 16, int(cfg["sampling"]["width"]) // 16


def patchify(z: torch.Tensor) -> torch.Tensor:
    """[B, C, 2h, 2w] -> [B, h w, C * 4], features (c, ph, pw)."""
    B, C, H, W_ = z.shape
    return (z.reshape(B, C, H // 2, 2, W_ // 2, 2).permute(0, 2, 4, 1, 3, 5)
            .reshape(B, (H // 2) * (W_ // 2), C * 4))


def unpatchify(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    B, _, D = x.shape
    return (x.reshape(B, h, w, D // 4, 2, 2).permute(0, 3, 1, 4, 2, 5)
            .reshape(B, D // 4, 2 * h, 2 * w))


def sample(W: Weights, cfg: Dict, noise: torch.Tensor, txt: torch.Tensor, y: torch.Tensor,
           keep: Iterable[int] = ()) -> Tuple[torch.Tensor, Dict[int, Tuple]]:
    """The Euler run from noise [B, 16, 2h, 2w]: the final latent [B, 16, 2h,
    2w] and, for each pass k (1-based) in `keep`, (the packed latent it
    read, its velocity)."""
    ts, keep = schedule(cfg), set(keep)
    g = float(cfg["sampling"]["guidance"])
    x = patchify(noise.float())
    seen = {}
    for k, (t_cur, t_prev) in enumerate(zip(ts[:-1], ts[1:]), start=1):
        v = velocity(W, cfg, x, txt, y, t_cur, g, grid(cfg))
        if k in keep:
            seen[k] = (x.clone(), v)
        x = x + (t_prev - t_cur) * v
    return unpatchify(x, *grid(cfg)), seen


# ---------------------------------------------------------------------------
# the AE decoder
# ---------------------------------------------------------------------------


def resnet(W: Weights, name: str, x: torch.Tensor) -> torch.Tensor:
    h = conv2d(W, f"{name}.conv1", silu(group_norm(W, f"{name}.norm1", x)))
    h = conv2d(W, f"{name}.conv2", silu(group_norm(W, f"{name}.norm2", h)))
    if f"{name}.nin_shortcut.weight" in W:
        x = conv2d(W, f"{name}.nin_shortcut", x)
    return x + h


def attn_block(W: Weights, name: str, x: torch.Tensor) -> torch.Tensor:
    B, C, H, W_ = x.shape
    h = group_norm(W, f"{name}.norm", x)
    q, k, v = (conv2d(W, f"{name}.{n}", h).reshape(B, C, H * W_).transpose(1, 2)
               for n in ("q", "k", "v"))
    out = softmax_attention(W, q, k, v).transpose(1, 2).reshape(B, C, H, W_)
    return x + conv2d(W, f"{name}.proj_out", out)


def decode(W: Weights, cfg: Dict, z: torch.Tensor) -> torch.Tensor:
    """Latent [B, 16, h, w] -> image [B, 3, 8 h, 8 w] in [-1, 1] (clamped)."""
    no_tf32()
    s = _dims(cfg)
    D = "ae.decoder"
    h = conv2d(W, f"{D}.conv_in", z.float() / s["scale"] + s["shift"])
    h = resnet(W, f"{D}.mid.block_2", attn_block(W, f"{D}.mid.attn_1",
                                                 resnet(W, f"{D}.mid.block_1", h)))
    for level in reversed(range(len(s["ch_mult"]))):
        for j in range(s["res"] + 1):
            h = resnet(W, f"{D}.up.{level}.block.{j}", h)
        if level != 0:
            h = conv2d(W, f"{D}.up.{level}.upsample.conv",
                       F.interpolate(h, scale_factor=2.0, mode="nearest"))
    h = conv2d(W, f"{D}.conv_out", silu(group_norm(W, f"{D}.norm_out", h)))
    return h.clamp(-1.0, 1.0)


def image_values(x: torch.Tensor) -> torch.Tensor:
    """[B, 3, H, W] in [-1, 1] -> [B, H, W, 3] on the 0..255 scale of the
    image written (127.5 (x + 1)), not rounded."""
    return (127.5 * (x + 1.0)).permute(0, 2, 3, 1)


def sample_image(W: Weights, cfg: Dict, noise: torch.Tensor, txt: torch.Tensor,
                 y: torch.Tensor, keep: Iterable[int] = ()
                 ) -> Tuple[torch.Tensor, torch.Tensor, Dict[int, Tuple]]:
    """(image [B, H, W, 3] uint8, latent, the kept passes): the whole run,
    the image truncated to uint8 as the source writes it."""
    z, seen = sample(W, cfg, noise, txt, y, keep)
    return image_values(decode(W, cfg, z)).to(torch.uint8), z, seen
