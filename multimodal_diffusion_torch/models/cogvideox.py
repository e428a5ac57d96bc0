"""CogVideoX expert transformer (Yang et al., "CogVideoX: Text-to-Video
Diffusion Models with An Expert Transformer", arXiv:2408.06072): the layer
equations of diffusers' ``CogVideoXTransformer3DModel`` at the widths a
config gives (``configs/cogvideox_5b.yaml``: CogVideoX-5B, 42 blocks, 48
heads of 64, d 3072, MLP 12288, time embedding 512).

  emb   = Linear-SiLU-Linear(sinusoid_3072(t)) [B, 512]: [cos, sin] of the
          integer t times exp(-ln(1e4) i / 1536)
  video = proj(x) per frame: Conv2d 16 -> d, kernel and stride 2; tokens
          ordered (frame, row, col)
  text  = text_proj(T5 states) [B, 226, 4096 -> d]; the sequence is [text;
          video], with no position embedding (RoPE only)
  block (x num_layers), one shared weight stream over both, "expert"
  adaptive LayerNorm per modality:
        (shift, scale, gate, enc_shift, enc_scale, enc_gate)
            = norm1.linear(silu(emb)) (6 d);
        video' = LN(video)(1 + scale) + shift, text' the same with enc_
        q, k, v = to_q/k/v([text'; video']), 48 heads of 64;
        q, k per-head LayerNorm (weight, bias, eps 1e-6); RoPE on the video
        rows; attention; to_out.0
        video += gate attn[video rows]; text += enc_gate attn[text rows]
        norm2 the same form, then the MLP (Linear-GELU(tanh)-Linear) over
        [text'; video'] and gated residuals with norm2's gates
  out   = proj_out(LN_out(norm_final(video))(1 + scale) + shift), (shift,
          scale) = norm_out.linear(silu(emb)); 64 = (C 16, p 2, p 2) per
          token, unpatchified to [B, F, 16, H, W]

LayerNorms are over d with weight and bias, eps ``norm_eps`` (1e-5).
RoPE (diffusers ``get_3d_rotary_pos_embed`` on the native grid, no crop
offset) rotates adjacent pairs of each head by angles pos theta^(-2i /
d_axis) over the axes (frame, row, col) with [16, 24, 24] of the 64 dims:
``flux.rope_tables`` and ``flux.apply_rope``. The tables are taken over the
joint sequence, the text rows at position (0, 0, 0): their angles are zero,
cos 1 and sin 0, so they rotate by exactly nothing and the result equals
rotating the video rows alone. The model calls RoPE through this module's
``apply_rope`` name.

Departures from the source, none of which changes the equations: the
residual streams, modulation, every LayerNorm (the QK-norm too) and RoPE
run in float32, and the projections take bf16 operands through
``HotDense`` (the source keeps everything in the weights' bf16); q and k
are rounded to bf16 once, after RoPE. The attention runs through
``ops/attention.py::multi_head_attention``: the hand-written flash forward
on the card, the dense path on the CPU.

Parameter names are diffusers', so a published state dict loads by name.
Built on the meta device (``infer/sample_cogvideox.py::build_cogvideox``)
the model allocates nothing until its weights are handed over.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import multi_head_attention
from ..utils.profiling import span
from .flux import apply_rope, rope_tables, timestep_embedding
from .mmdit import HotDense

__all__ = ["CogVideoXConfig", "CogVideoXTransformer", "apply_rope", "position_ids"]


@dataclasses.dataclass(frozen=True)
class CogVideoXConfig:
    in_channels: int = 16
    out_channels: int = 16
    num_heads: int = 48
    head_dim: int = 64
    num_layers: int = 42
    text_embed_dim: int = 4096
    time_embed_dim: int = 512
    patch_size: int = 2
    mlp_ratio: float = 4.0
    norm_eps: float = 1e-5
    qk_norm_eps: float = 1e-6
    axes_dim: Tuple[int, ...] = (16, 24, 24)
    theta: float = 10_000.0
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def from_config(cls, cfg: Dict, dtype: torch.dtype = torch.bfloat16) -> "CogVideoXConfig":
        c = cfg["model"]["core"]
        return cls(in_channels=int(c["in_channels"]), out_channels=int(c["out_channels"]),
                   num_heads=int(c["n_heads"]), head_dim=int(c["d_model"]) // int(c["n_heads"]),
                   num_layers=int(c["n_layers"]), text_embed_dim=int(c["text_embed_dim"]),
                   time_embed_dim=int(c["time_embed_dim"]), patch_size=int(c["patch_size"]),
                   mlp_ratio=float(c["mlp_ratio"]), norm_eps=float(c["norm_eps"]),
                   qk_norm_eps=float(c["qk_norm_eps"]),
                   axes_dim=tuple(int(a) for a in c["axes_dim"]), theta=float(c["theta"]),
                   dtype=dtype)

    @property
    def d(self) -> int:
        return self.num_heads * self.head_dim


class LayerNorm(nn.LayerNorm):
    """LayerNorm with weight and bias, statistics and output in float32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps)


class LayerNormZero(nn.Module):
    """diffusers' ``CogVideoXLayerNormZero``: one LayerNorm over both streams
    and a (shift, scale, gate) for each: ``linear(silu(emb))`` split as
    (shift, scale, gate, enc_shift, enc_scale, enc_gate)."""

    def __init__(self, c: CogVideoXConfig):
        super().__init__()
        self.linear = HotDense(c.time_embed_dim, 6 * c.d, c.dtype)
        self.norm = LayerNorm(c.d, eps=c.norm_eps)

    def forward(self, video: torch.Tensor, text: torch.Tensor, emb: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """(video', text', gate, enc_gate), float32; the gates [B, 1, d]."""
        shift, scale, gate, e_shift, e_scale, e_gate = (
            self.linear(F.silu(emb)).float()[:, None, :].chunk(6, dim=-1))
        return (torch.addcmul(shift, self.norm(video), 1.0 + scale),
                torch.addcmul(e_shift, self.norm(text), 1.0 + e_scale), gate, e_gate)


class Attention(nn.Module):
    """Joint attention over [text; video]: to_q, to_k, to_v, per-head
    LayerNorm of q and k, RoPE, attention, to_out.0."""

    def __init__(self, c: CogVideoXConfig):
        super().__init__()
        self.n_heads = c.num_heads
        self.to_q, self.to_k, self.to_v = (HotDense(c.d, c.d, c.dtype) for _ in range(3))
        self.norm_q = LayerNorm(c.head_dim, eps=c.qk_norm_eps)
        self.norm_k = LayerNorm(c.head_dim, eps=c.qk_norm_eps)
        self.to_out = nn.ModuleList([HotDense(c.d, c.d, c.dtype)])

    def heads(self, x: torch.Tensor) -> torch.Tensor:
        """[B, N, H Dh] -> a [B, H, N, Dh] view."""
        B, N, _ = x.shape
        return x.view(B, N, self.n_heads, -1).transpose(1, 2)

    def forward(self, x: torch.Tensor, pe: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        cos, sin = pe
        x = x.to(self.to_q.dtype)
        q = apply_rope(self.norm_q(self.heads(self.to_q(x))), cos, sin)
        k = apply_rope(self.norm_k(self.heads(self.to_k(x))), cos, sin)
        v = self.heads(self.to_v(x))
        out = multi_head_attention(q.to(v.dtype), k.to(v.dtype), v)
        B, H, N, Dh = out.shape
        return self.to_out[0](out.transpose(1, 2).reshape(B, N, H * Dh)).float()


class GeluTanhProj(nn.Module):
    """diffusers' ``GELU(approximate="tanh")``: ``proj`` then GELU (tanh),
    in float32."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype):
        super().__init__()
        self.proj = HotDense(d_in, d_out, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.proj(x).float(), approximate="tanh")


class FeedForward(nn.Module):
    """``ff.net``: [GELU-tanh projection, dropout (identity), Linear]."""

    def __init__(self, c: CogVideoXConfig):
        super().__init__()
        hidden = int(c.d * c.mlp_ratio)
        self.net = nn.ModuleList([GeluTanhProj(c.d, hidden, c.dtype), nn.Identity(),
                                  HotDense(hidden, c.d, c.dtype)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x)).float()


class CogVideoXBlock(nn.Module):
    def __init__(self, c: CogVideoXConfig):
        super().__init__()
        self.norm1 = LayerNormZero(c)
        self.attn1 = Attention(c)
        self.norm2 = LayerNormZero(c)
        self.ff = FeedForward(c)

    def forward(self, video: torch.Tensor, text: torch.Tensor, emb: torch.Tensor,
                pe: Tuple[torch.Tensor, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        L = text.shape[1]
        v, t, gate, e_gate = self.norm1(video, text, emb)
        a = self.attn1(torch.cat((t, v), 1), pe)
        video = video + gate * a[:, L:]
        text = text + e_gate * a[:, :L]
        v, t, gate, e_gate = self.norm2(video, text, emb)
        h = self.ff(torch.cat((t, v), 1))
        return video + gate * h[:, L:], text + e_gate * h[:, :L]


class PatchEmbed(nn.Module):
    """``patch_embed``: ``proj`` (Conv2d, kernel and stride p, on each frame)
    and ``text_proj`` (Linear)."""

    def __init__(self, c: CogVideoXConfig):
        super().__init__()
        self.proj = nn.Conv2d(c.in_channels, c.d, c.patch_size, stride=c.patch_size)
        self.text_proj = HotDense(c.text_embed_dim, c.d, c.dtype)
        self.dtype = c.dtype

    def forward(self, text: torch.Tensor, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(text [B, L, d], video [B, F h w, d]), float32."""
        B, Fr, C, H, W = x.shape
        w, b = self.proj.weight.to(self.dtype), self.proj.bias.to(self.dtype)
        v = F.conv2d(x.reshape(B * Fr, C, H, W).to(self.dtype), w, b, stride=self.proj.stride)
        v = v.flatten(2).transpose(1, 2).reshape(B, -1, v.shape[1])
        return self.text_proj(text).float(), v.float()


class TimestepEmbedding(nn.Module):
    def __init__(self, d_in: int, d: int, dtype: torch.dtype):
        super().__init__()
        self.linear_1 = HotDense(d_in, d, dtype)
        self.linear_2 = HotDense(d, d, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x).float())).float()


class AdaLayerNorm(nn.Module):
    """``norm_out``: (shift, scale) = linear(silu(emb)), in that order, then
    LN(x)(1 + scale) + shift."""

    def __init__(self, c: CogVideoXConfig):
        super().__init__()
        self.linear = HotDense(c.time_embed_dim, 2 * c.d, c.dtype)
        self.norm = LayerNorm(c.d, eps=c.norm_eps)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        shift, scale = self.linear(F.silu(emb)).float()[:, None, :].chunk(2, dim=-1)
        return torch.addcmul(shift, self.norm(x), 1.0 + scale)


def position_ids(text_len: int, frames: int, h: int, w: int, device) -> torch.Tensor:
    """[text_len + frames h w, 3] float32: the text rows at (0, 0, 0), the
    video tokens at (frame, row, col), frame-major then row-major."""
    f, r, c = torch.meshgrid(torch.arange(frames, device=device), torch.arange(h, device=device),
                             torch.arange(w, device=device), indexing="ij")
    video = torch.stack((f, r, c), -1).reshape(-1, 3).float()
    return torch.cat((torch.zeros(text_len, 3, device=device), video))


class CogVideoXTransformer(nn.Module):
    """forward(x [B, F, C, H, W], text [B, L, text_embed_dim], t [B] integer
    timesteps) -> the v-prediction [B, F, out_channels, H, W], float32."""

    def __init__(self, c: CogVideoXConfig):
        super().__init__()
        if c.d != c.num_heads * c.head_dim or sum(c.axes_dim) != c.head_dim:
            raise ValueError(f"head dim {c.head_dim} must equal sum(axes_dim) "
                             f"{sum(c.axes_dim)}")
        self.cfg = c
        d = c.d
        self.patch_embed = PatchEmbed(c)
        self.time_embedding = TimestepEmbedding(d, c.time_embed_dim, c.dtype)
        self.transformer_blocks = nn.ModuleList(CogVideoXBlock(c) for _ in range(c.num_layers))
        self.norm_final = LayerNorm(d, eps=c.norm_eps)
        self.norm_out = AdaLayerNorm(c)
        self.proj_out = HotDense(d, c.patch_size ** 2 * c.out_channels, c.dtype)

    def forward(self, x: torch.Tensor, text: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        B, Fr, _, H, W = x.shape
        p = c.patch_size
        h, w = H // p, W // p
        emb = self.time_embedding(timestep_embedding(t, c.d, time_factor=1.0))
        text, video = self.patch_embed(text, x)
        pe = rope_tables(position_ids(text.shape[1], Fr, h, w, x.device), c.axes_dim, c.theta)
        with span("cogvideox.blocks"):
            for block in self.transformer_blocks:
                video, text = block(video, text, emb, pe)
        out = self.proj_out(self.norm_out(self.norm_final(video), emb)).float()
        out = out.reshape(B, Fr, h, w, c.out_channels, p, p).permute(0, 1, 4, 2, 5, 3, 6)
        return out.reshape(B, Fr, c.out_channels, H, W)
