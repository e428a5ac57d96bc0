"""FLUX.1's autoencoder decoder (``github.com/black-forest-labs/flux``
``src/flux/modules/autoencoder.py``): a 16-channel latent at 1/8 of the
image's side to RGB in [-1, 1].

  z / scale_factor + shift_factor -> conv_in (z_channels -> ch ch_mult[-1])
  mid: ResnetBlock, AttnBlock, ResnetBlock
  up levels from the deepest: num_res_blocks + 1 ResnetBlocks each, then
      (all but the last) nearest x2 and a 3x3 conv
  GroupNorm -> swish -> conv_out (ch -> out_ch)

ResnetBlock: x + conv2(swish(GN(conv1(swish(GN(x)))))), a 1x1
``nin_shortcut`` where the channels change; AttnBlock: x + proj_out of one
head of attention over the h w positions, q, k, v 1x1 convs of GN(x);
GroupNorm 32 groups, eps 1e-6. Parameter names are the source's under
``decoder.``.

The convolutions run in the weights' dtype (bf16 when served), the
GroupNorm statistics and the swish in float32. The AttnBlock's one head is
as wide as the channels (512 at FLUX.1's widths), outside the flash
kernel's head dims, so it runs through ``F.scaled_dot_product_attention``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class AEConfig:
    ch: int = 128
    out_ch: int = 3
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 16
    scale_factor: float = 0.3611
    shift_factor: float = 0.1159
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def from_config(cls, cfg: Dict, dtype: torch.dtype = torch.bfloat16) -> "AEConfig":
        a = cfg["model"]["ae"]
        return cls(ch=int(a["ch"]), out_ch=int(a["out_ch"]),
                   ch_mult=tuple(int(m) for m in a["ch_mult"]),
                   num_res_blocks=int(a["num_res_blocks"]), z_channels=int(a["z_channels"]),
                   scale_factor=float(a["scale_factor"]), shift_factor=float(a["shift_factor"]),
                   dtype=dtype)


def swish(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x.float())


class GroupNorm(nn.GroupNorm):
    """32 groups, eps 1e-6, statistics and output in float32."""

    def __init__(self, c: int):
        super().__init__(32, c, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps)


class Conv(nn.Conv2d):
    """A 'same'-padded convolution in ``dtype``."""

    def __init__(self, c_in: int, c_out: int, k: int, dtype: torch.dtype):
        super().__init__(c_in, c_out, k, padding=k // 2)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x.to(self.dtype), self.weight.to(self.dtype),
                                  self.bias.to(self.dtype))


class ResnetBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, dtype: torch.dtype):
        super().__init__()
        self.norm1, self.conv1 = GroupNorm(c_in), Conv(c_in, c_out, 3, dtype)
        self.norm2, self.conv2 = GroupNorm(c_out), Conv(c_out, c_out, 3, dtype)
        if c_in != c_out:
            self.nin_shortcut = Conv(c_in, c_out, 1, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(swish(self.norm2(self.conv1(swish(self.norm1(x))))))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    def __init__(self, c: int, dtype: torch.dtype):
        super().__init__()
        self.norm = GroupNorm(c)
        self.q, self.k, self.v = (Conv(c, c, 1, dtype) for _ in range(3))
        self.proj_out = Conv(c, c, 1, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.norm(x)
        q, k, v = (m(h).flatten(2).transpose(1, 2)[:, None] for m in (self.q, self.k, self.v))
        out = F.scaled_dot_product_attention(q, k, v)  # [B, 1, H W, C]
        return x + self.proj_out(out[:, 0].transpose(1, 2).reshape(B, C, H, W))


class Upsample(nn.Module):
    def __init__(self, c: int, dtype: torch.dtype):
        super().__init__()
        self.conv = Conv(c, c, 3, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x.to(self.conv.dtype), scale_factor=2.0, mode="nearest"))


class Decoder(nn.Module):
    def __init__(self, c: AEConfig):
        super().__init__()
        mult: Sequence[int] = c.ch_mult
        block_in = c.ch * mult[-1]
        self.conv_in = Conv(c.z_channels, block_in, 3, c.dtype)
        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(block_in, block_in, c.dtype)
        self.mid.attn_1 = AttnBlock(block_in, c.dtype)
        self.mid.block_2 = ResnetBlock(block_in, block_in, c.dtype)
        ups = []
        for level in reversed(range(len(mult))):
            up = nn.Module()
            blocks = []
            for _ in range(c.num_res_blocks + 1):
                blocks.append(ResnetBlock(block_in, c.ch * mult[level], c.dtype))
                block_in = c.ch * mult[level]
            up.block = nn.ModuleList(blocks)
            if level != 0:
                up.upsample = Upsample(block_in, c.dtype)
            ups.insert(0, up)
        self.up = nn.ModuleList(ups)
        self.norm_out = GroupNorm(block_in)
        self.conv_out = Conv(block_in, c.out_ch, 3, c.dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(z)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        for level in reversed(range(len(self.up))):
            for block in self.up[level].block:
                h = block(h)
            if level != 0:
                h = self.up[level].upsample(h)
        return self.conv_out(swish(self.norm_out(h))).float()


class AEDecoder(nn.Module):
    """decode(z [B, z_channels, h, w]) -> [B, out_ch, 8 h, 8 w] float32, not
    clamped."""

    def __init__(self, c: AEConfig):
        super().__init__()
        self.cfg = c
        self.decoder = Decoder(c)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z.float() / self.cfg.scale_factor + self.cfg.shift_factor)
