"""CogVideoX's causal 3-D VAE decoder: diffusers' ``AutoencoderKLCogVideoX``
decoder (``CogVideoXDecoder3D``) at the widths a config gives
(``configs/cogvideox_5b.yaml``: ``vae/config.json`` of THUDM/CogVideoX-5b,
``block_out_channels`` [128, 256, 256, 512], 16 latent channels,
``layers_per_block`` 3, GroupNorm 32 groups eps 1e-6, SiLU, no post-quant
conv, scaling factor 0.7, temporal compression 4).

  z / scaling_factor [B, 16, F, h, w], decoded in batches of latent frames:
      the first 2 + F % 2 frames, then 2 at a time (13 -> 3, 2, 2, 2, 2, 2;
      ``FRAME_BATCH``, the source's ``num_latent_frames_batch_size``, a
      constant of its code and not of its config)
  conv_in (causal 3x3x3, 16 -> 512)
  mid_block: 2 resnets at 512
  up_blocks i = 0..3 (channels 512, 256, 256, 128), each 4 resnets, then
      (all but the last) CogVideoXUpsample3D: nearest x2 in space, and in
      time too on the first two (``compress_time``), then a 3x3 Conv2d on
      each frame
  norm_out, SiLU, conv_out (causal 3x3x3, 128 -> 3)

A resnet is x + conv2(silu(norm2(conv1(silu(norm1(x)))))), with a 1x1x1
``conv_shortcut`` where the channels change. Every norm is a
``SpatialNorm3D(f, zq)``: GroupNorm(f) * conv_y(zq) + conv_b(zq), conv_y and
conv_b kernel-1 convolutions of the batch's latent zq, which is first
resized (nearest) to f's frames, rows and columns, its first frame apart
from the rest when f has an odd number of frames above 1. The GroupNorm's
statistics are those of the frame batch, as in the source.

A causal convolution pads time on the left with k - 1 frames and space
with zeros on both sides: for the first batch, copies of its first frame
(``pad_mode`` "first"); for each later one, the last k - 1 frames of the
input it was handed before (the convolution cache carried across batches,
``conv_cache``). Temporal x2 upsampling of an odd frame count keeps the
first frame single (1 + 2n -> 1 + 4n), so 13 latent frames give 9 + 5 x 8
= 49 frames.

The convolutions run in the weights' dtype (bf16 as served), the GroupNorm
statistics, the SpatialNorm products and SiLU in float32; the residual
stream is in the convolutions' dtype. Parameter names are diffusers' under
``decoder.``. Departures and readings of the source not confirmed against
its code here: the source's ``CogVideoXSafeConv3d`` splits inputs above 2
GB along time with k - 1 frames of overlap, the same convolution, which
this port runs unsplit; the per-frame 3x3 Conv2d of the upsampler runs as a
1x3x3 Conv3d with the same weights; the tiled decode (``enable_tiling``)
is not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

Cache = Dict[nn.Module, torch.Tensor]

FRAME_BATCH = 2  # latent frames a decode batch after the first


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    block_out_channels: Tuple[int, ...] = (128, 256, 256, 512)
    latent_channels: int = 16
    out_channels: int = 3
    layers_per_block: int = 3
    norm_num_groups: int = 32
    norm_eps: float = 1e-6
    scaling_factor: float = 0.7
    temporal_compression_ratio: int = 4
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def from_config(cls, cfg: Dict, dtype: torch.dtype = torch.bfloat16) -> "VAEConfig":
        v = cfg["model"]["vae"]
        return cls(block_out_channels=tuple(int(c) for c in v["block_out_channels"]),
                   latent_channels=int(v["latent_channels"]), out_channels=int(v["out_channels"]),
                   layers_per_block=int(v["layers_per_block"]),
                   norm_num_groups=int(v["norm_num_groups"]), norm_eps=float(v["norm_eps"]),
                   scaling_factor=float(v["scaling_factor"]),
                   temporal_compression_ratio=int(v["temporal_compression_ratio"]), dtype=dtype)


class CausalConv3d(nn.Module):
    """``CogVideoXCausalConv3d``: ``conv`` (a Conv3d without padding of its
    own), time padded on the left from the cache or the first frame, space
    padded with zeros."""

    def __init__(self, c_in: int, c_out: int, k: int, dtype: torch.dtype):
        super().__init__()
        self.conv = nn.Conv3d(c_in, c_out, k)
        self.k, self.dtype = k, dtype

    def forward(self, x: torch.Tensor, cache: Cache) -> torch.Tensor:
        x = x.to(self.dtype)
        w, b = self.conv.weight.to(self.dtype), self.conv.bias.to(self.dtype)
        if self.k == 1:
            return F.conv3d(x, w, b)
        head = cache.get(self)
        if head is None:
            head = x[:, :, :1].expand(-1, -1, self.k - 1, -1, -1)
        x = torch.cat((head, x), 2)
        cache[self] = x[:, :, -(self.k - 1):].clone()
        return F.conv3d(x, w, b, padding=(0, self.k // 2, self.k // 2))


class SpatialNorm3D(nn.Module):
    """``CogVideoXSpatialNorm3D``: GroupNorm(f) * conv_y(zq) + conv_b(zq),
    float32."""

    def __init__(self, f_channels: int, zq_channels: int, groups: int, eps: float,
                 dtype: torch.dtype):
        super().__init__()
        self.norm_layer = nn.GroupNorm(groups, f_channels, eps=eps)
        self.conv_y = CausalConv3d(zq_channels, f_channels, 1, dtype)
        self.conv_b = CausalConv3d(zq_channels, f_channels, 1, dtype)

    def forward(self, f: torch.Tensor, zq: torch.Tensor, cache: Cache) -> torch.Tensor:
        T = f.shape[2]
        if T > 1 and T % 2 == 1:
            zq = torch.cat((F.interpolate(zq[:, :, :1], size=(1,) + tuple(f.shape[-2:])),
                            F.interpolate(zq[:, :, 1:], size=(T - 1,) + tuple(f.shape[-2:]))), 2)
        else:
            zq = F.interpolate(zq, size=tuple(f.shape[-3:]))
        n = self.norm_layer
        norm = F.group_norm(f.float(), n.num_groups, n.weight.float(), n.bias.float(), n.eps)
        return torch.addcmul(self.conv_b(zq, cache).float(), norm, self.conv_y(zq, cache).float())


class ResnetBlock3D(nn.Module):
    """``CogVideoXResnetBlock3D`` with spatial norms and no time embedding."""

    def __init__(self, c_in: int, c_out: int, c: VAEConfig):
        super().__init__()
        zc, g, eps, dt = c.latent_channels, c.norm_num_groups, c.norm_eps, c.dtype
        self.norm1 = SpatialNorm3D(c_in, zc, g, eps, dt)
        self.conv1 = CausalConv3d(c_in, c_out, 3, dt)
        self.norm2 = SpatialNorm3D(c_out, zc, g, eps, dt)
        self.conv2 = CausalConv3d(c_out, c_out, 3, dt)
        if c_in != c_out:
            self.conv_shortcut = nn.Conv3d(c_in, c_out, 1)
        self.dtype = dt

    def forward(self, x: torch.Tensor, zq: torch.Tensor, cache: Cache) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x, zq, cache)), cache)
        h = self.conv2(F.silu(self.norm2(h, zq, cache)), cache)
        if hasattr(self, "conv_shortcut"):
            s = self.conv_shortcut
            x = F.conv3d(x.to(self.dtype), s.weight.to(self.dtype), s.bias.to(self.dtype))
        return x.to(self.dtype) + h


class Upsample3D(nn.Module):
    """``CogVideoXUpsample3D``: nearest x2 in space (and in time under
    ``compress_time``, the first of an odd frame count kept single), then
    ``conv``, a 3x3 Conv2d on each frame."""

    def __init__(self, ch: int, compress_time: bool, dtype: torch.dtype):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)
        self.compress_time, self.dtype = compress_time, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        T = x.shape[2]
        if self.compress_time and T > 1 and T % 2 == 1:
            x = torch.cat((F.interpolate(x[:, :, 0], scale_factor=2.0)[:, :, None],
                           F.interpolate(x[:, :, 1:], scale_factor=2.0)), 2)
        elif self.compress_time and T > 1:
            x = F.interpolate(x, scale_factor=2.0)
        else:
            x = F.interpolate(x, scale_factor=(1.0, 2.0, 2.0))
        w, b = self.conv.weight.to(self.dtype)[:, :, None], self.conv.bias.to(self.dtype)
        return F.conv3d(x, w, b, padding=(0, 1, 1))


class UpBlock3D(nn.Module):
    def __init__(self, c_in: int, c_out: int, upsample: bool, compress_time: bool, c: VAEConfig):
        super().__init__()
        self.resnets = nn.ModuleList(ResnetBlock3D(c_in if i == 0 else c_out, c_out, c)
                                     for i in range(c.layers_per_block + 1))
        if upsample:
            self.upsamplers = nn.ModuleList([Upsample3D(c_out, compress_time, c.dtype)])


class MidBlock3D(nn.Module):
    def __init__(self, ch: int, c: VAEConfig):
        super().__init__()
        self.resnets = nn.ModuleList(ResnetBlock3D(ch, ch, c) for _ in range(2))


class Decoder3D(nn.Module):
    def __init__(self, c: VAEConfig):
        super().__init__()
        chans: Sequence[int] = list(reversed(c.block_out_channels))
        self.conv_in = CausalConv3d(c.latent_channels, chans[0], 3, c.dtype)
        self.mid_block = MidBlock3D(chans[0], c)
        levels = int(math.log2(c.temporal_compression_ratio))  # up blocks that double time
        self.up_blocks = nn.ModuleList(
            UpBlock3D(chans[max(i - 1, 0)], chans[i], i < len(chans) - 1, i < levels, c)
            for i in range(len(chans)))
        self.norm_out = SpatialNorm3D(chans[-1], c.latent_channels, c.norm_num_groups,
                                      c.norm_eps, c.dtype)
        self.conv_out = CausalConv3d(chans[-1], c.out_channels, 3, c.dtype)

    def forward(self, z: torch.Tensor, cache: Cache) -> torch.Tensor:
        """One batch of latent frames [B, C, f, h, w] -> frames, float32."""
        h = self.conv_in(z, cache)
        for r in self.mid_block.resnets:
            h = r(h, z, cache)
        for up in self.up_blocks:
            for r in up.resnets:
                h = r(h, z, cache)
            if hasattr(up, "upsamplers"):
                h = up.upsamplers[0](h)
        return self.conv_out(F.silu(self.norm_out(h, z, cache)), cache).float()


def frame_batches(frames: int) -> Tuple[Tuple[int, int], ...]:
    """The source's batches of latent frames: (start, end) of the first
    FRAME_BATCH + frames % FRAME_BATCH, then FRAME_BATCH at a time."""
    n, rem = FRAME_BATCH, frames % FRAME_BATCH
    return tuple((n * i + (0 if i == 0 else rem), n * (i + 1) + rem)
                 for i in range(max(frames // n, 1)))


class CogVideoXVAEDecoder(nn.Module):
    """decode(z [B, latent_channels, F, h, w]) -> frames [B, out_channels,
    1 + 4 (F - 1), 8 h, 8 w] float32, not clamped."""

    def __init__(self, c: VAEConfig):
        super().__init__()
        self.cfg = c
        self.decoder = Decoder3D(c)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        z = z.float() / self.cfg.scaling_factor
        cache: Cache = {}
        return torch.cat([self.decoder(z[:, :, a:b].to(self.cfg.dtype), cache)
                          for a, b in frame_batches(z.shape[2])], 2)
