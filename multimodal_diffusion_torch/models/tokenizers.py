"""Tokenizer convenience classes (counterpart of the JAX
``models/tokenizers.py``): ``VideoTokenizer`` and ``AudioTokenizer``, class
wrappers with ``token_dim`` accessors over the vectorized ops the hot paths
call (``ops/tokenize.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import tokenize as tk


@dataclasses.dataclass(frozen=True)
class VideoTokenizer:
    lat_ch: int
    t: int
    h: int
    w: int

    @property
    def token_dim(self) -> int:
        return self.lat_ch * self.t * self.h * self.w

    def encode(self, z: torch.Tensor) -> torch.Tensor:
        """[B, C, T, H, W] -> [B, N, token_dim]."""
        return tk.tube_patch_video(z, self.t, self.h, self.w)

    def decode(self, tokens: torch.Tensor, T: int, H: int, W: int) -> torch.Tensor:
        """[B, N, token_dim] -> [B, C, T, H, W]."""
        return tk.tube_unpatch_video(tokens, self.lat_ch, T, H, W, self.t, self.h, self.w)


@dataclasses.dataclass(frozen=True)
class AudioTokenizer:
    lat_ch: int
    length: int
    stride: int

    @property
    def token_dim(self) -> int:
        return self.lat_ch * self.length

    def num_tokens(self, F: int) -> int:
        return tk.num_chunks(F, self.length, self.stride)

    def encode(self, z: torch.Tensor) -> torch.Tensor:
        """[B, C, F] -> [B, N, token_dim]."""
        return tk.audio_tokens_from_latent(z, self.length, self.stride)

    def decode(self, tokens: torch.Tensor, F: int) -> torch.Tensor:
        """[B, N, token_dim] -> [B, C, F] (vectorized overlap-add)."""
        return tk.audio_latent_from_tokens(tokens, self.lat_ch, self.length, F, self.stride)
