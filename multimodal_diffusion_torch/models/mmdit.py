"""MMDiT — multimodal diffusion transformer core (counterpart of the JAX
``models/mmdit.py``).

A pre-norm transformer encoder over the concatenated [video; audio] token
sequence. Parameters are fp32; compute runs in ``cfg.dtype`` (bf16 for mvp)
with norm statistics and attention softmax in fp32. Eval-mode (deterministic)
forward only: dropout is never applied.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import multi_head_attention
from .adapters import Dense


class RMSNorm(nn.Module):
    """y = weight * x / (sqrt(mean(x^2) + 1e-12) + eps): eps sits OUTSIDE the
    sqrt (the reference formula); the +1e-12 inside keeps exactly-zero rows
    (CFG-dropped tokens) finite. Statistics in fp32."""

    def __init__(self, d: int, eps: float = 1e-6, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.eps, self.dtype = eps, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        norm = torch.sqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + 1e-12)
        return (self.weight * xf / (norm + self.eps)).to(self.dtype)


class LayerNorm(nn.Module):
    """LayerNorm with eps 1e-5, statistics in fp32, output in ``dtype``."""

    def __init__(self, d: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))
        self.eps, self.dtype = eps, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), x.shape[-1:], self.weight, self.bias,
                            self.eps).to(self.dtype)


def make_norm(kind: str, d: int, dtype: torch.dtype) -> nn.Module:
    if kind.lower() == "rmsnorm":
        return RMSNorm(d, dtype=dtype)
    return LayerNorm(d, dtype=dtype)


def rotary_embed(q: torch.Tensor, k: torch.Tensor, max_period: float = 10_000.0):
    """Rotary position embedding over the sequence axis of [B, H, N, Dh]."""
    Dh = q.shape[-1]
    half = Dh // 2
    freqs = 1.0 / (max_period ** (
        torch.arange(half, dtype=torch.float32, device=q.device) / half))
    pos = torch.arange(q.shape[-2], dtype=torch.float32, device=q.device)
    ang = pos[:, None] * freqs[None, :]  # [N, half]
    cos, sin = torch.cos(ang), torch.sin(ang)

    def rot(x):
        x1, x2 = x[..., :half], x[..., half: 2 * half]
        xr1 = x1 * cos - x2 * sin
        xr2 = x1 * sin + x2 * cos
        return torch.cat([xr1, xr2, x[..., 2 * half:]], dim=-1).to(x.dtype)

    return rot(q), rot(k)


class Attention(nn.Module):
    """Self-attention with a fused qkv projection (biases), optional RoPE, and
    an output projection. Attention itself goes through
    ``multi_head_attention``: the CUDA kernel on the card."""

    def __init__(self, d: int, n_heads: int, rope: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if d % n_heads:
            raise ValueError(f"d_model {d} not divisible by n_heads {n_heads}")
        self.n_heads, self.rope = n_heads, rope
        self.qkv = Dense(d, 3 * d, dtype)
        self.out = Dense(d, d, dtype)

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None,
                use_kernel: Optional[bool] = None) -> torch.Tensor:
        B, N, d = x.shape
        H = self.n_heads
        qkv = self.qkv(x).reshape(B, N, 3, H, d // H)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # [B, H, N, Dh]
        if self.rope:
            q, k = rotary_embed(q, k)
        out = multi_head_attention(q, k, v, key_padding_mask=key_padding_mask,
                                   use_kernel=use_kernel)
        return self.out(out.transpose(1, 2).reshape(B, N, d))


class MLP(nn.Module):
    """fc1 -> GELU (erf, or tanh when gelu_exact is False) -> fc2."""

    def __init__(self, d: int, mlp_ratio: float = 4.0, gelu_exact: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = int(d * mlp_ratio)
        self.fc1 = Dense(d, hidden, dtype)
        self.fc2 = Dense(hidden, d, dtype)
        self.approximate = "none" if gelu_exact else "tanh"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate=self.approximate))


class Block(nn.Module):
    """Pre-norm residual block: x + attn(norm1(x)); x + mlp(norm2(x))."""

    def __init__(self, d: int, n_heads: int, mlp_ratio: float, norm: str,
                 rope: bool, gelu_exact: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = make_norm(norm, d, dtype)
        self.attn = Attention(d, n_heads, rope, dtype)
        self.norm2 = make_norm(norm, d, dtype)
        self.mlp = MLP(d, mlp_ratio, gelu_exact, dtype)

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None,
                use_kernel: Optional[bool] = None) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), key_padding_mask, use_kernel)
        return x + self.mlp(self.norm2(x))


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    """The JAX MMDiTConfig's fields that an eval-mode forward reads (dropout
    keys of the config tree are ignored: eval mode)."""

    d_model: int = 1024
    n_layers: int = 16
    n_heads: int = 16
    mlp_ratio: float = 4.0
    norm: str = "rmsnorm"
    rope: bool = False
    gelu_exact: bool = True
    dtype: Any = torch.float32
    # pad the token axis to a multiple of this; pad rows are masked keys and
    # their outputs are sliced off
    seq_multiple: int = 1
    quant: str = "none"

    @classmethod
    def from_dict(cls, d: dict, **overrides) -> "MMDiTConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in known}
        kw.update(overrides)
        return cls(**kw)


class MMDiT(nn.Module):
    """Stack of self-attention blocks over the concatenated token sequence,
    then a final norm. forward(x [B, N, d], key_padding_mask [B, N] bool
    True=PAD) -> [B, N, d]."""

    def __init__(self, cfg: MMDiTConfig):
        super().__init__()
        if cfg.quant != "none":
            raise NotImplementedError(
                f"model.core.quant={cfg.quant!r} is not ported yet (int8 comes later)")
        self.cfg = cfg
        self.blocks = nn.ModuleList(
            Block(cfg.d_model, cfg.n_heads, cfg.mlp_ratio, cfg.norm, cfg.rope,
                  cfg.gelu_exact, cfg.dtype)
            for _ in range(cfg.n_layers))
        self.norm = make_norm(cfg.norm, cfg.d_model, cfg.dtype)

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None,
                use_kernel: Optional[bool] = None) -> torch.Tensor:
        cfg = self.cfg
        if x.shape[-1] != cfg.d_model:
            raise ValueError(f"expected width {cfg.d_model}, got {x.shape[-1]}")
        x = x.to(cfg.dtype)
        B, N, _ = x.shape
        pad_n = (-N) % max(1, cfg.seq_multiple)
        if pad_n:
            x = F.pad(x, (0, 0, 0, pad_n))
            if key_padding_mask is None:
                key_padding_mask = torch.zeros((B, N), dtype=torch.bool, device=x.device)
            key_padding_mask = F.pad(key_padding_mask, (0, pad_n), value=True)
        for blk in self.blocks:
            x = blk(x, key_padding_mask, use_kernel)
        if pad_n:
            x = x[:, :N]
        return self.norm(x)

