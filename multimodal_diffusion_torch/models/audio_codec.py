"""AudioCodec — waveform <-> latent-frame codec (counterpart of the JAX
``models/audio_codec.py``).

  encode: two k=9 Conv1d+GELU -> average-pool at hop (or the exact
          `frames_per_clip` hop) -> 1x1 to lat_ch.   [B,1,L] -> [B,Ca,Fa]
  decode: 1x1 -> nearest-upsample x hop -> three k=smooth_kernel convs
          (GELU between) -> tanh.   [B,Ca,Fa] -> [B,1,Fa*hop]

Channels-first [B, C, L] throughout.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class AudioCodecConfig:
    in_ch: int = 1
    lat_ch: int = 8
    sr: int = 16000
    hop_samples: int = 320
    hidden: int = 64
    smooth_kernel: int = 7
    frames_per_clip: Optional[int] = None
    dtype: Any = torch.float32

    @classmethod
    def from_dict(cls, d: Dict, **overrides) -> "AudioCodecConfig":
        lat = d.get("latent", {})
        codec = d.get("codec", {})
        sr = int(d.get("sr", 16000))
        if "frame_hop_ms" in lat:
            hop_samples = max(1, int(round(sr * float(lat["frame_hop_ms"]) / 1000.0)))
        else:
            hop_samples = int(codec.get("hop_samples", 320))
        kw = dict(
            in_ch=int(d.get("in_ch", 1)),
            lat_ch=int(lat.get("channels", 8)),
            sr=sr,
            hop_samples=hop_samples,
            hidden=int(codec.get("hidden", 64)),
            smooth_kernel=int(codec.get("smooth_kernel", 7)),
            frames_per_clip=int(lat.get("frames_per_clip", 0)) or None,
        )
        kw.update(overrides)
        return cls(**kw)


def exact_pool_params(L: int, Fa: int) -> Tuple[int, int]:
    """Integer hop with Fa*hop >= L and minimal right-pad."""
    if Fa <= 0:
        raise ValueError(f"frames_per_clip must be positive, got {Fa}")
    hop = max(1, int(round(L / Fa)))
    total = Fa * hop
    if total < L:
        hop += 1
        total = Fa * hop
    return hop, total


class Conv1d(nn.Conv1d):
    """'same'-padded Conv1d (odd kernel) computed in ``dtype`` (fp32 weights)."""

    def __init__(self, c_in: int, c_out: int, k: int, dtype: torch.dtype):
        super().__init__(c_in, c_out, k, padding=k // 2)
        nn.init.zeros_(self.weight)
        nn.init.zeros_(self.bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x.to(self.dtype), self.weight.to(self.dtype),
                                  self.bias.to(self.dtype))


class AudioCodec(nn.Module):
    def __init__(self, cfg: AudioCodecConfig):
        super().__init__()
        self.cfg = cfg
        c, dt = cfg, cfg.dtype
        k = max(3, int(c.smooth_kernel))
        self.pre0 = Conv1d(c.in_ch, c.hidden, 9, dt)
        self.pre1 = Conv1d(c.hidden, c.hidden, 9, dt)
        self.to_lat = Conv1d(c.hidden, c.lat_ch, 1, dt)
        self.from_lat = Conv1d(c.lat_ch, c.hidden, 1, dt)
        self.smooth0 = Conv1d(c.hidden, c.hidden, k, dt)
        self.smooth1 = Conv1d(c.hidden, c.hidden, k, dt)
        self.smooth2 = Conv1d(c.hidden, c.in_ch, k, dt)

    @property
    def hop(self) -> int:
        return int(self.cfg.hop_samples)

    def _avgpool_frames(self, x: torch.Tensor, target_Fa: Optional[int]) -> torch.Tensor:
        """[B, H, L] -> [B, H, Fa]: zero-pad (or crop) to Fa*hop, then the
        mean of each hop-long window."""
        B, H, L = x.shape
        if target_Fa is None:
            hop = self.hop
            Fa = math.ceil(L / hop)
            total = Fa * hop
        else:
            Fa = int(target_Fa)
            hop, total = exact_pool_params(L, Fa)
        if total > L:
            x = F.pad(x, (0, total - L))
        elif total < L:
            x = x[..., :total]
        return x.reshape(B, H, Fa, hop).mean(dim=-1)

    def encode(self, wav: torch.Tensor) -> torch.Tensor:
        """wav: [B, 1, L] mono in [-1,1] -> z: [B, Ca, Fa]."""
        if wav.ndim != 3 or wav.shape[1] != self.cfg.in_ch:
            raise ValueError(
                f"AudioCodec.encode expects [B,{self.cfg.in_ch},L], got {tuple(wav.shape)}")
        h = F.gelu(self.pre0(wav), approximate="none")
        h = F.gelu(self.pre1(h), approximate="none")
        return self.to_lat(self._avgpool_frames(h, self.cfg.frames_per_clip))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z: [B, Ca, Fa] -> wav_hat: [B, 1, Fa*hop] in [-1,1]."""
        if z.ndim != 3:
            raise ValueError("AudioCodec.decode expects [B,Ca,Fa]")
        h = self.from_lat(z)
        h = torch.repeat_interleave(h, self.hop, dim=-1)  # nearest upsample
        h = F.gelu(self.smooth0(h), approximate="none")
        h = F.gelu(self.smooth1(h), approximate="none")
        return torch.tanh(self.smooth2(h))
