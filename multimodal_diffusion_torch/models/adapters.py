"""Projection + embedding toolkit (counterpart of the JAX ``models/adapters.py``).

Parameters are fp32; each module computes in its ``dtype`` by casting the
weight and the input at use, like flax's ``dtype``/``param_dtype`` split.
Constructors allocate zeros; ``models/diffusion.init_weights`` draws the
random weights from an explicit generator.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.schedule import timestep_embedding


class Dense(nn.Module):
    """y = x W^T + b computed in ``dtype`` (weight [out, in] stays fp32)."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(d_out, d_in))
        self.bias = nn.Parameter(torch.zeros(d_out))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class LinearAdapter(nn.Module):
    """Per-token linear projection to width d."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = Dense(d_in, d_out, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class ModalityEmbedding(nn.Module):
    """Learned per-modality embedding added to every token of that modality."""

    def __init__(self, d: int, modalities=("video", "audio"),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.modalities = tuple(modalities)
        self.table = nn.Parameter(torch.zeros(len(self.modalities), d))
        self.dtype = dtype

    def forward(self, x: torch.Tensor, modality: str) -> torch.Tensor:
        idx = self.modalities.index(modality)
        return x + self.table[idx].to(self.dtype)[None, None, :]


def sinusoid_table(n: int, d: int) -> np.ndarray:
    """Interleaved sin/cos positional table [n, d]."""
    pe = np.zeros((n, d), dtype=np.float32)
    pos = np.arange(n, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float32) * (-math.log(10000.0) / d))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div[: pe[:, 1::2].shape[1]])
    return pe


@functools.lru_cache(maxsize=None)
def sinusoid_on(n: int, d: int, device: Optional[torch.device]) -> torch.Tensor:
    """``sinusoid_table(n, d)`` on `device`, copied there once: a captured
    CUDA graph of the denoiser (models/graphed.py) can copy nothing from the
    host. Made outside inference mode, so a training pass may use it."""
    with torch.inference_mode(False):
        return torch.from_numpy(sinusoid_table(n, d)).to(device)


class PositionalEmbedding1D(nn.Module):
    """1-D positions for audio tokens; mode 'learned' or 'sin'."""

    def __init__(self, d: int, max_len: int = 4096, mode: str = "learned",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.d, self.mode, self.dtype = d, mode, dtype
        if mode == "learned":
            self.table = nn.Parameter(torch.zeros(max_len, d))

    def forward(self, N: int, device: Optional[torch.device] = None) -> torch.Tensor:
        """Returns [1, N, d] (broadcasts over batch)."""
        if self.mode == "learned":
            pe = self.table[:N]
        else:
            pe = sinusoid_on(N, self.d, device)
        return pe.to(self.dtype)[None]


class PositionalEmbedding3D(nn.Module):
    """3-D factorized positions for video tokens at grid (T', H', W'):
    per-axis learned tables summed, raster order t-major then h, w."""

    def __init__(self, d: int, max_t: int = 256, max_h: int = 256, max_w: int = 256,
                 mode: str = "learned", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.d, self.mode, self.dtype = d, mode, dtype
        if mode == "learned":
            self.t_table = nn.Parameter(torch.zeros(max_t, d))
            self.h_table = nn.Parameter(torch.zeros(max_h, d))
            self.w_table = nn.Parameter(torch.zeros(max_w, d))

    def forward(self, Tt: int, Hh: int, Ww: int,
                device: Optional[torch.device] = None) -> torch.Tensor:
        """Returns [1, Tt*Hh*Ww, d]."""
        N = Tt * Hh * Ww
        if self.mode == "learned":
            pe = (self.t_table[:Tt, None, None, :]
                  + self.h_table[None, :Hh, None, :]
                  + self.w_table[None, None, :Ww, :]).reshape(N, self.d)
        else:
            pe = sinusoid_on(N, self.d, device)
        return pe.to(self.dtype)[None]


class TimestepEmbedder(nn.Module):
    """t [B] int -> [B, dim]; sinusoidal base, optional SiLU-MLP refinement."""

    def __init__(self, dim: int = 256, mode: str = "sin",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.mode, self.dtype = dim, mode, dtype
        if mode == "mlp":
            self.fc1 = Dense(dim, dim * 2, dtype)
            self.fc2 = Dense(dim * 2, dim, dtype)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        base = timestep_embedding(t, self.dim)  # fp32, cos||sin order
        if self.mode == "mlp":
            return self.fc2(F.silu(self.fc1(base)))
        return base.to(self.dtype)
