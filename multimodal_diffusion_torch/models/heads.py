"""Epsilon-prediction heads (counterpart of the JAX ``models/heads.py``).

MultiModalNoiseHead: per-modality input projection -> shared trunk of
(Dense -> LayerNorm(eps 1e-5) -> act) blocks -> per-modality output Dense
(the joint model's one modality-specific layer, so no per-modality trunk).
Eval mode: no dropout.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .adapters import Dense
from .mmdit import LayerNorm

_ACTS = {
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "relu": F.relu,
    "leaky_relu": lambda x: F.leaky_relu(x, negative_slope=0.1),
}


def _act(name: str):
    name = (name or "gelu").lower()
    if name not in _ACTS:
        raise ValueError(f"Unsupported activation: {name}")
    return _ACTS[name]


class TrunkBlock(nn.Module):
    """Dense -> LayerNorm -> act."""

    def __init__(self, d_in: int, width: int, activation: str,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dense = Dense(d_in, width, dtype)
        self.norm = LayerNorm(width, dtype=dtype)
        self.act = _act(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.norm(self.dense(x)))


class MultiModalNoiseHead(nn.Module):
    """Shared-trunk eps heads; dict-in / dict-out. Modalities absent from the
    input dict are skipped."""

    def __init__(self, input_dims: Mapping[str, int], output_dims: Mapping[str, int],
                 hidden_dim: int = 512, num_shared_layers: int = 2,
                 activation: str = "gelu", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.modalities = tuple(output_dims)
        for m in self.modalities:
            self.add_module(f"input_proj_{m}", Dense(input_dims[m], hidden_dim, dtype))
        self.shared = nn.ModuleList(
            TrunkBlock(hidden_dim, hidden_dim, activation, dtype)
            for _ in range(max(0, num_shared_layers)))
        for m in self.modalities:
            self.add_module(f"out_proj_{m}", Dense(hidden_dim, int(output_dims[m]), dtype))

    def forward(self, inputs: Dict[str, Optional[torch.Tensor]]) -> Dict[str, torch.Tensor]:
        outputs: Dict[str, torch.Tensor] = {}
        for m in self.modalities:
            x = inputs.get(m)
            if x is None:
                continue
            x = getattr(self, f"input_proj_{m}")(x)
            for blk in self.shared:
                x = blk(x)
            outputs[m] = getattr(self, f"out_proj_{m}")(x)
        if not outputs:
            raise ValueError("MultiModalNoiseHead: no modalities present in inputs")
        return outputs
