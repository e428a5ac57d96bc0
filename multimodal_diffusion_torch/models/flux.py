"""FLUX.1 rectified-flow transformer (Black Forest Labs, 2024): the layer
equations of ``github.com/black-forest-labs/flux`` ``src/flux/model.py``,
``modules/layers.py`` and ``math.py``, at the widths a config gives
(``configs/flux_dev.yaml``: FLUX.1-dev, hidden 3072, 24 heads of 128, 19
double-stream and 38 single-stream blocks, RoPE axes [16, 56, 56]).

  vec = time_in(emb(t)) + guidance_in(emb(g)) + vector_in(y)
        emb: 256-dim [cos, sin] of 1000 t; each embedder Linear-SiLU-Linear
  img = img_in(x) [B, N_img, 64 -> d];  txt = txt_in(c) [B, L, 4096 -> d]
  pe  = 3-axis RoPE of the position ids (txt 0; img (0, row, col))
  double-stream block (x depth), weights per stream (img, txt):
        (shift, scale, gate) x 2 = Linear(silu(vec)) (6 d)
        q, k, v = qkv((1 + scale1) LN(x) + shift1); q, k per-head RMSNorm
        joint attention over cat(txt, img), RoPE on q and k
        x += gate1 proj(attn);  x += gate2 mlp((1 + scale2) LN(x) + shift2)
  single-stream block (x depth_single_blocks) on cat(txt, img):
        (shift, scale, gate) = Linear(silu(vec)) (3 d)
        q, k, v, h = linear1((1 + scale) LN(x) + shift); QK-norm, RoPE, attention
        x += gate linear2(cat(attn, gelu_tanh(h)))
  last layer on the image tokens: Linear((1 + scale) LN(x) + shift) -> 64

LN is LayerNorm without affine, eps 1e-6; the MLP is Linear-GELU(tanh)-
Linear at mlp_ratio * d; RoPE rotates adjacent pairs (x0, x1) of each head
by angles pos * theta^(-2i / d_axis) per axis, the axes' 8, 28 and 28 pairs
concatenated (``rope_tables``).

Departures from the source, none of which changes the equations: the
residual streams, modulation, norms and RoPE run in float32 (the source
keeps its streams in the weights' bf16), and the projections take bf16
operands through ``HotDense``; QK-norm's output goes to RoPE in float32
before one rounding to bf16 (the source rounds after the norm too); the
RoPE angles are computed in float64 from float64 positions (the source
mixes a float32 position with float64 frequencies). On the card, without a
gradient, the QK-norm, RoPE and that rounding of q and k are one
hand-written kernel (``ops/qk_norm_rope.py``) that writes the joint
sequence's q and k in place of their concatenation (``roped_qk``); it takes
the bf16 of FLUX.1 as served, and refuses another precision on the card.
The CPU and autograd run the plain chain (``plain_roped_qk``). The attention runs
through ``ops/attention.py::multi_head_attention``: the hand-written flash
forward on the card, the dense path on the CPU.

Parameter names are the source's, so a state dict of the published layout
loads by name. Built on the meta device (``build_flux``) the model
allocates nothing until its weights are handed over.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import multi_head_attention
from ..ops.qk_norm_rope import qk_norm_rope
from ..utils.profiling import span
from .mmdit import HotDense


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    in_channels: int = 64
    vec_in_dim: int = 768
    context_in_dim: int = 4096
    hidden_size: int = 3072
    mlp_ratio: float = 4.0
    num_heads: int = 24
    depth: int = 19
    depth_single_blocks: int = 38
    axes_dim: Tuple[int, ...] = (16, 56, 56)
    theta: float = 10_000.0
    qkv_bias: bool = True
    guidance_embed: bool = True
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def from_config(cls, cfg: Dict, dtype: torch.dtype = torch.bfloat16) -> "FluxConfig":
        c = cfg["model"]["core"]
        return cls(in_channels=int(c["in_channels"]), vec_in_dim=int(c["vec_in_dim"]),
                   context_in_dim=int(c["context_in_dim"]), hidden_size=int(c["d_model"]),
                   mlp_ratio=float(c["mlp_ratio"]), num_heads=int(c["n_heads"]),
                   depth=int(c["depth"]), depth_single_blocks=int(c["depth_single_blocks"]),
                   axes_dim=tuple(int(a) for a in c["axes_dim"]), theta=float(c["theta"]),
                   qkv_bias=bool(c["qkv_bias"]), guidance_embed=bool(c["guidance_embed"]),
                   dtype=dtype)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def timestep_embedding(t: torch.Tensor, dim: int = 256, max_period: float = 10_000.0,
                       time_factor: float = 1000.0) -> torch.Tensor:
    """[B] -> [B, dim] float32: [cos, sin] of time_factor * t times
    exp(-ln(max_period) i / (dim / 2)), cos first."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                           device=t.device) / half)
    args = (time_factor * t.float())[:, None] * freqs[None]
    return F.pad(torch.cat([torch.cos(args), torch.sin(args)], dim=-1), (0, dim % 2))


def rope_tables(ids: torch.Tensor, axes_dim: Sequence[int], theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Position ids [N, n_axes] -> (cos, sin), each [N, sum(axes_dim) / 2]
    float32: per axis the angles pos * theta^(-2i / d_axis), i < d_axis / 2,
    in float64, the axes concatenated in order."""
    angles = []
    for a, d in enumerate(axes_dim):
        omega = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                             device=ids.device) / d)
        angles.append(ids[:, a].double()[:, None] * omega[None])
    ang = torch.cat(angles, dim=-1)
    return torch.cos(ang).float(), torch.sin(ang).float()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate adjacent pairs (x0, x1) of x [B, H, N, Dh] (float32) by the
    tables [N, Dh / 2]: (cos x0 - sin x1, sin x0 + cos x1)."""
    x0, x1 = x.unflatten(-1, (-1, 2)).unbind(-1)
    return torch.stack([cos * x0 - sin * x1, sin * x0 + cos * x1], dim=-1).flatten(-2)


def layer_norm(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm without affine, eps 1e-6, float32."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=1e-6)


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(1 + scale) LN(x) + shift, float32; shift and scale [B, 1, d]."""
    return torch.addcmul(shift, layer_norm(x), 1.0 + scale)


class MLPEmbedder(nn.Module):
    def __init__(self, d_in: int, d: int, dtype: torch.dtype):
        super().__init__()
        self.in_layer = HotDense(d_in, d, dtype)
        self.out_layer = HotDense(d, d, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out_layer(F.silu(self.in_layer(x).float())).float()


class RMSNorm(nn.Module):
    """x rsqrt(mean(x^2) + 1e-6) scale over the head dim, float32."""

    def __init__(self, d: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6) * self.scale.float()


class QKNorm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.query_norm = RMSNorm(d)
        self.key_norm = RMSNorm(d)


class Modulation(nn.Module):
    """Linear(silu(vec)) split into n chunks [B, 1, d] (float32): (shift,
    scale, gate) once or twice."""

    def __init__(self, d: int, n: int, dtype: torch.dtype):
        super().__init__()
        self.n = n
        self.lin = HotDense(d, n * d, dtype)

    def forward(self, vec: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return self.lin(F.silu(vec)).float()[:, None, :].chunk(self.n, dim=-1)


class SelfAttention(nn.Module):
    def __init__(self, d: int, n_heads: int, qkv_bias: bool, dtype: torch.dtype):
        super().__init__()
        if not qkv_bias:
            raise NotImplementedError("qkv projections without a bias")
        self.qkv = HotDense(d, 3 * d, dtype)
        self.norm = QKNorm(d // n_heads)
        self.proj = HotDense(d, d, dtype)


def split_heads(qkv: torch.Tensor, n_heads: int) -> Tuple[torch.Tensor, ...]:
    """[B, N, 3 d] -> q, k, v, each a [B, H, N, Dh] view."""
    B, N, _ = qkv.shape
    return qkv.view(B, N, 3, n_heads, -1).permute(2, 0, 3, 1, 4).unbind(0)


Stream = Tuple[torch.Tensor, QKNorm]  # a stream's qkv projection [B, n, 3 d] and its QK-norm


def plain_roped_qk(streams: Sequence[Stream], n_heads: int,
                   pe: Tuple[torch.Tensor, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain chain of ``roped_qk``: each stream's q and k through its
    RMSNorm modules (float32), concatenated in the streams' order, then
    ``apply_rope`` and one rounding to the qkv's dtype."""
    qs, ks = [], []
    for qkv, norm in streams:
        q, k, _ = split_heads(qkv, n_heads)
        qs.append(norm.query_norm(q))
        ks.append(norm.key_norm(k))
    q, k = (t[0] if len(t) == 1 else torch.cat(t, 2) for t in (qs, ks))
    cos, sin = pe
    dtype = streams[0][0].dtype
    return apply_rope(q, cos, sin).to(dtype), apply_rope(k, cos, sin).to(dtype)


def roped_qk(streams: Sequence[Stream], n_heads: int,
             pe: Tuple[torch.Tensor, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """q and k of the joint sequence, each [B, H, N, Dh] in the qkv's dtype,
    from each stream's (qkv, QK-norm) in the sequence's order (a double
    block's txt then img, or a single block's one stream): per-head RMSNorm,
    RoPE at the joint positions, one rounding. A CUDA qkv that needs no
    gradient takes the kernel (``ops/qk_norm_rope.py``), one launch a stream
    into one joint q and one joint k buffer, and the kernel takes FLUX.1 as
    served, bf16 qkv and scales: on the card, another precision raises
    without a gradient. CPU tensors and autograd take the plain chain."""
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for qkv, norm in streams
        for t in (qkv, norm.query_norm.scale, norm.key_norm.scale))
    if not streams[0][0].is_cuda or needs_grad:
        return plain_roped_qk(streams, n_heads, pe)
    cos, sin = pe
    out, offset = None, 0
    for qkv, norm in streams:
        out = qk_norm_rope(qkv, norm.query_norm.scale, norm.key_norm.scale, cos, sin, offset,
                           out)
        offset += qkv.shape[1]
    if offset != cos.shape[0]:  # rows no stream wrote would go to attention unset
        raise ValueError(f"roped_qk: the streams hold {offset} tokens, the RoPE tables "
                         f"{cos.shape[0]}")
    return out


def joint_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Attention over the roped q, k and v ([B, H, N, Dh], one dtype)
    through ``multi_head_attention``; returns [B, N, H Dh]."""
    out = multi_head_attention(q, k, v)
    B, H, N, Dh = out.shape
    return out.transpose(1, 2).reshape(B, N, H * Dh)


class GeluTanh(nn.Module):
    """GELU, tanh approximation, in float32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(x.float(), approximate="tanh")


def mlp(d: int, hidden: int, dtype: torch.dtype) -> nn.Sequential:
    """Linear-GELU(tanh)-Linear, named 0 and 2 as in the source."""
    return nn.Sequential(HotDense(d, hidden, dtype), GeluTanh(), HotDense(hidden, d, dtype))


class DoubleStreamBlock(nn.Module):
    def __init__(self, c: FluxConfig):
        super().__init__()
        d, hidden = c.hidden_size, int(c.hidden_size * c.mlp_ratio)
        self.n_heads = c.num_heads
        for s in ("img", "txt"):
            setattr(self, f"{s}_mod", Modulation(d, 6, c.dtype))
            setattr(self, f"{s}_attn", SelfAttention(d, c.num_heads, c.qkv_bias, c.dtype))
            setattr(self, f"{s}_mlp", mlp(d, hidden, c.dtype))

    def forward(self, img: torch.Tensor, txt: torch.Tensor, vec: torch.Tensor,
                pe: Tuple[torch.Tensor, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        im, tm = self.img_mod(vec), self.txt_mod(vec)
        i1, i2, t1, t2 = im[:3], im[3:], tm[:3], tm[3:]
        iqkv = self.img_attn.qkv(modulate(img, i1[0], i1[1]))
        tqkv = self.txt_attn.qkv(modulate(txt, t1[0], t1[1]))
        q, k = roped_qk([(tqkv, self.txt_attn.norm), (iqkv, self.img_attn.norm)],
                        self.n_heads, pe)
        v = torch.cat((split_heads(tqkv, self.n_heads)[2], split_heads(iqkv, self.n_heads)[2]), 2)
        attn = joint_attention(q, k, v)
        L = txt.shape[1]
        img = img + i1[2] * self.img_attn.proj(attn[:, L:]).float()
        img = img + i2[2] * self.img_mlp(modulate(img, i2[0], i2[1])).float()
        txt = txt + t1[2] * self.txt_attn.proj(attn[:, :L]).float()
        txt = txt + t2[2] * self.txt_mlp(modulate(txt, t2[0], t2[1])).float()
        return img, txt


class SingleStreamBlock(nn.Module):
    def __init__(self, c: FluxConfig):
        super().__init__()
        d = c.hidden_size
        self.d, self.hidden, self.n_heads = d, int(d * c.mlp_ratio), c.num_heads
        self.linear1 = HotDense(d, 3 * d + self.hidden, c.dtype)
        self.linear2 = HotDense(d + self.hidden, d, c.dtype)
        self.norm = QKNorm(c.head_dim)
        self.modulation = Modulation(d, 3, c.dtype)

    def forward(self, x: torch.Tensor, vec: torch.Tensor,
                pe: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        shift, scale, gate = self.modulation(vec)
        qkv, h = self.linear1(modulate(x, shift, scale)).split([3 * self.d, self.hidden], -1)
        q, k = roped_qk([(qkv, self.norm)], self.n_heads, pe)
        attn = joint_attention(q, k, split_heads(qkv, self.n_heads)[2])
        act = F.gelu(h.float(), approximate="tanh").to(attn.dtype)
        return x + gate * self.linear2(torch.cat((attn, act), 2)).float()


class LastLayer(nn.Module):
    def __init__(self, d: int, d_out: int, dtype: torch.dtype):
        super().__init__()
        self.linear = HotDense(d, d_out, dtype)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), HotDense(d, 2 * d, dtype))

    def forward(self, x: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
        shift, scale = self.adaLN_modulation(vec).float()[:, None, :].chunk(2, dim=-1)
        return self.linear(modulate(x, shift, scale)).float()


class Flux(nn.Module):
    """The transformer: forward(img [B, N, in_channels], img_ids [N, 3], txt
    [B, L, context_in_dim], txt_ids [L, 3], timesteps [B], y [B, vec_in_dim],
    guidance [B]) -> the velocity [B, N, in_channels], float32."""

    def __init__(self, c: FluxConfig):
        super().__init__()
        if c.hidden_size % c.num_heads or sum(c.axes_dim) != c.head_dim:
            raise ValueError(f"hidden {c.hidden_size} / {c.num_heads} heads must equal "
                             f"sum(axes_dim) {sum(c.axes_dim)}")
        if not c.guidance_embed:
            raise NotImplementedError("a model without the guidance embedder")
        self.cfg = c
        d = c.hidden_size
        self.img_in = HotDense(c.in_channels, d, c.dtype)
        self.time_in = MLPEmbedder(256, d, c.dtype)
        self.vector_in = MLPEmbedder(c.vec_in_dim, d, c.dtype)
        self.guidance_in = MLPEmbedder(256, d, c.dtype)
        self.txt_in = HotDense(c.context_in_dim, d, c.dtype)
        self.double_blocks = nn.ModuleList(DoubleStreamBlock(c) for _ in range(c.depth))
        self.single_blocks = nn.ModuleList(SingleStreamBlock(c)
                                           for _ in range(c.depth_single_blocks))
        self.final_layer = LastLayer(d, c.in_channels, c.dtype)

    def forward(self, img: torch.Tensor, img_ids: torch.Tensor, txt: torch.Tensor,
                txt_ids: torch.Tensor, timesteps: torch.Tensor, y: torch.Tensor,
                guidance: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        vec = (self.time_in(timestep_embedding(timesteps))
               + self.guidance_in(timestep_embedding(guidance)) + self.vector_in(y))
        img = self.img_in(img).float()
        txt = self.txt_in(txt).float()
        pe = rope_tables(torch.cat((txt_ids, img_ids), 0), c.axes_dim, c.theta)
        with span("flux.double_blocks"):
            for block in self.double_blocks:
                img, txt = block(img, txt, vec, pe)
        x = torch.cat((txt, img), 1)
        with span("flux.single_blocks"):
            for block in self.single_blocks:
                x = block(x, vec, pe)
        return self.final_layer(x[:, txt.shape[1]:], vec)


def init_flux_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights in place, tensor by tensor from `generator`
    (on the parameters' device): every matrix and convolution kernel N(0, 1 /
    fan-in), every norm scale 1, every other vector (the biases) N(0, 0.02)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() >= 2:
                w = torch.randn(p.shape, generator=generator, device=p.device)
                p.copy_(w / math.sqrt(math.prod(p.shape[1:])))
            elif name.endswith("scale") or (name.endswith("weight")
                                             and "norm" in name.split(".")[-2]):
                p.fill_(1.0)
            else:
                p.copy_(0.02 * torch.randn(p.shape, generator=generator, device=p.device))
