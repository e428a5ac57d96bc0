"""Byte-level text encoder, the conditioning tower of the text families
(counterpart of the JAX ``models/text_encoder.py``).

UTF-8 bytes between BOS and EOS, padded with PAD to ``max_len``; an
embedding, a learned position table, the MMDiT stack under the pad mask
(pad keys are masked in attention), and a mean over the positions that are
not padding: forward(ids [B, L]) -> (tokens [B, L, d], pooled [B, d]).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .mmdit import MMDiT, MMDiTConfig

PAD_ID = 256
BOS_ID = 257
EOS_ID = 258
VOCAB = 259


def tokenize_text(texts: Sequence[str], max_len: int = 77) -> np.ndarray:
    """UTF-8 bytes + BOS/EOS, padded/truncated to max_len: [B, max_len] int32."""
    out = np.full((len(texts), max_len), PAD_ID, np.int32)
    for i, t in enumerate(texts):
        ids = [BOS_ID] + list(t.encode("utf-8"))[: max_len - 2] + [EOS_ID]
        out[i, : len(ids)] = ids
    return out


@dataclasses.dataclass(frozen=True)
class TextEncoderConfig:
    width: int = 256
    max_len: int = 77
    core: MMDiTConfig = dataclasses.field(
        default_factory=lambda: MMDiTConfig(
            d_model=256, n_layers=4, n_heads=4, mlp_ratio=4.0, dropout=0.0))
    dtype: Any = torch.float32


class Embed(nn.Module):
    """Token embedding table [vocab, d] (fp32), looked up in ``dtype``."""

    def __init__(self, vocab: int, d: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(vocab, d))
        self.dtype = dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids.long()].to(self.dtype)


class TextEncoder(nn.Module):
    def __init__(self, cfg: TextEncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.token_embed = Embed(VOCAB, cfg.width, cfg.dtype)
        self.pos = nn.Parameter(torch.zeros(cfg.max_len, cfg.width))
        self.core = MMDiT(cfg.core)

    def forward(self, ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """ids: [B, L] int -> (token_embs [B, L, d], pooled [B, d]); pooled is
        the mean over the non-pad positions (fp32 sum, at least one position
        counted)."""
        emb = self.token_embed(ids)
        h = emb + self.pos[: ids.shape[1]].to(emb.dtype)[None]
        pad_mask = ids == PAD_ID  # True = PAD
        h = self.core(h, pad_mask)
        keep = (~pad_mask).to(torch.float32)[..., None]
        pooled = (h.float() * keep).sum(dim=1) / keep.sum(dim=1).clamp(min=1.0)
        return h, pooled.to(h.dtype)
