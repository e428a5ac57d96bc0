"""MMDiT — multimodal diffusion transformer core (counterpart of the JAX
``models/mmdit.py``).

A pre-norm transformer encoder over the concatenated [video; audio] token
sequence. Parameters are fp32; compute runs in ``cfg.dtype`` (bf16 for mvp)
with norm statistics and attention softmax in fp32.

Dropout (residual, MLP, token and attention-probability dropout) is on under
``module.train()`` and off under ``eval()``. It draws only from an explicit
``torch.Generator`` that ``set_dropout_generator`` hands to every dropout
module; a training-mode dropout without one raises (no global RNG).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import mha_reference, multi_head_attention, padding_bias
from .adapters import Dense


class Dropout(nn.Module):
    """Inverted dropout, flax semantics: keep with probability 1 - rate and
    scale the kept values by 1 / (1 - rate). Identity in eval mode or at
    rate 0. Draws come from ``self.generator`` (see set_dropout_generator)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.generator: Optional[torch.Generator] = None

    def _uniform(self, shape, device) -> torch.Tensor:
        if self.generator is None:
            raise RuntimeError("dropout in training mode needs a generator: "
                               "call set_dropout_generator(model, generator)")
        return torch.rand(shape, generator=self.generator, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate <= 0.0:
            return x
        keep = self._uniform(x.shape, x.device) < 1.0 - self.rate
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


class TokenDropout(Dropout):
    """Zero whole tokens of [B, N, d] with probability ``rate`` (no rescale),
    as the JAX core's stochastic token dropout."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate <= 0.0:
            return x
        keep = self._uniform(x.shape[:2], x.device) > self.rate
        return x * keep.to(x.dtype)[..., None]


def set_dropout_generator(model: nn.Module, generator: torch.Generator) -> None:
    """Hand `generator` to every dropout module of `model`."""
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.generator = generator


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
    an output projection, then residual dropout. Attention itself goes through
    ``multi_head_attention``: the CUDA kernels on the card, forward and
    backward. A training pass with ``attn_dropout > 0`` takes the dense
    einsum body with probability dropout instead, as the JAX package does
    (the kernels draw no random numbers)."""

    def __init__(self, d: int, n_heads: int, rope: bool = False,
                 dtype: torch.dtype = torch.float32, attn_dropout: float = 0.0,
                 resid_dropout: float = 0.0):
        super().__init__()
        if d % n_heads:
            raise ValueError(f"d_model {d} not divisible by n_heads {n_heads}")
        self.n_heads, self.rope = n_heads, rope
        self.qkv = Dense(d, 3 * d, dtype)
        self.out = Dense(d, d, dtype)
        self.attn_drop = Dropout(attn_dropout)
        self.resid_drop = Dropout(resid_dropout)

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None,
                use_kernel: Optional[bool] = None) -> torch.Tensor:
        B, N, d = x.shape
        H = self.n_heads
        qkv = self.qkv(x).reshape(B, N, 3, H, d // H)
        # head views of the one projection; unbind's backward stacks the
        # three grads into one qkv-shaped buffer
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))  # [B, H, N, Dh]
        if self.rope:
            q, k = rotary_embed(q, k)
        if self.training and self.attn_drop.rate > 0.0:
            # the JAX package's training body: no all-masked-row zeroing
            bias = None if key_padding_mask is None else padding_bias(key_padding_mask)
            out = mha_reference(q, k, v, bias, probs_dropout=self.attn_drop)
        else:
            out = multi_head_attention(q, k, v, key_padding_mask=key_padding_mask,
                                       use_kernel=use_kernel)
        return self.resid_drop(self.out(out.transpose(1, 2).reshape(B, N, d)))


class MLP(nn.Module):
    """fc1 -> GELU (erf, or tanh when gelu_exact is False) -> dropout -> fc2
    -> dropout."""

    def __init__(self, d: int, mlp_ratio: float = 4.0, gelu_exact: bool = True,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        hidden = int(d * mlp_ratio)
        self.fc1 = Dense(d, hidden, dtype)
        self.fc2 = Dense(hidden, d, dtype)
        self.approximate = "none" if gelu_exact else "tanh"
        self.drop1 = Dropout(dropout)
        self.drop2 = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.drop1(F.gelu(self.fc1(x), approximate=self.approximate))
        return self.drop2(self.fc2(h))


class Block(nn.Module):
    """Pre-norm residual block: x + attn(norm1(x)); x + mlp(norm2(x))."""

    def __init__(self, d: int, n_heads: int, mlp_ratio: float, norm: str,
                 rope: bool, gelu_exact: bool = True,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 attn_dropout: float = 0.0):
        super().__init__()
        self.norm1 = make_norm(norm, d, dtype)
        self.attn = Attention(d, n_heads, rope, dtype, attn_dropout, dropout)
        self.norm2 = make_norm(norm, d, dtype)
        self.mlp = MLP(d, mlp_ratio, gelu_exact, dtype, dropout)

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None,
                use_kernel: Optional[bool] = None) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), key_padding_mask, use_kernel)
        return x + self.mlp(self.norm2(x))


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    """The JAX MMDiTConfig's fields that the port reads (the parallelism
    fields are not ported)."""

    d_model: int = 1024
    n_layers: int = 16
    n_heads: int = 16
    mlp_ratio: float = 4.0
    dropout: float = 0.1
    attn_dropout: float = 0.0
    token_dropout: float = 0.0
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
        self.token_drop = TokenDropout(cfg.token_dropout)
        self.blocks = nn.ModuleList(
            Block(cfg.d_model, cfg.n_heads, cfg.mlp_ratio, cfg.norm, cfg.rope,
                  cfg.gelu_exact, cfg.dtype, cfg.dropout, cfg.attn_dropout)
            for _ in range(cfg.n_layers))
        self.norm = make_norm(cfg.norm, cfg.d_model, cfg.dtype)

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None,
                use_kernel: Optional[bool] = None) -> torch.Tensor:
        cfg = self.cfg
        if x.shape[-1] != cfg.d_model:
            raise ValueError(f"expected width {cfg.d_model}, got {x.shape[-1]}")
        x = self.token_drop(x.to(cfg.dtype))
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

