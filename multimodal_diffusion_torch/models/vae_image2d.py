"""ImageVAE, the 2-D convolutional autoencoder of latent image diffusion
(counterpart of the JAX ``models/vae_image2d.py``).

Each encoder stage is ResBlocks then a stride-2 3x3 convolution, so H and W
halve per stage (``down`` a power of two); the decoder mirrors it with 2x
nearest upsampling, each followed by a 3x3 convolution. Channels-first
[B, C, H, W] throughout; fp32 parameters, convolutions in ``dtype``,
GroupNorm statistics in fp32 with flax's epsilon 1e-6.

Convolutions pad as flax's ``padding="SAME"``: a stride-2 3x3 convolution on
an even size pads 0 rows before and 1 after (``same_padding``), not the
symmetric 1 and 1 of ``nn.Conv2d(padding=1)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class ImageVAEConfig:
    in_ch: int = 3
    lat_ch: int = 4
    down: int = 8  # spatial downsample factor (power of 2)
    base: int = 64
    max_ch: int = 256
    blocks_per_stage: int = 1
    variational: bool = False
    out_activation: str = "tanh"  # images in [-1, 1]
    dtype: Any = torch.float32

    @classmethod
    def from_dict(cls, d: Dict, **overrides) -> "ImageVAEConfig":
        lat = d.get("latent", {})
        kw = dict(
            in_ch=int(d.get("in_ch", 3)),
            lat_ch=int(lat.get("channels", 4)),
            down=int(lat.get("s_down", lat.get("down", 8))),
            base=int(d.get("encoder", {}).get("base", 64)),
            max_ch=int(d.get("encoder", {}).get("max_ch", 256)),
            blocks_per_stage=int(d.get("encoder", {}).get("blocks", 1)),
            variational=bool(d.get("variational", False)),
            out_activation=str(d.get("out_activation", "tanh")),
        )
        kw.update(overrides)
        return cls(**kw)

    @property
    def n_stages(self) -> int:
        down, n = self.down, 0
        while down > 1:
            if down % 2:
                raise ValueError("down must be a power of 2")
            down //= 2
            n += 1
        return n

    def ch(self, stage: int) -> int:
        return min(self.base * (2 ** stage), self.max_ch)


def same_padding(size: int, k: int, stride: int) -> Tuple[int, int]:
    """flax/XLA "SAME" padding of one axis: (before, after), the odd one
    after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Conv2d(nn.Conv2d):
    """A k x k convolution with flax's "SAME" padding, computed in ``dtype``
    (fp32 weights)."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__(c_in, c_out, k, stride=stride, padding=0)
        nn.init.zeros_(self.weight)
        nn.init.zeros_(self.bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        (hb, ha), (wb, wa) = (same_padding(n, k, s) for n in x.shape[-2:])
        x = x.to(self.dtype)
        if (hb, wb) == (ha, wa):
            return F.conv2d(x, self.weight.to(self.dtype), self.bias.to(self.dtype),
                            s, (hb, wb))
        return F.conv2d(F.pad(x, (wb, wa, hb, ha)), self.weight.to(self.dtype),
                        self.bias.to(self.dtype), s)


class GroupNorm(nn.GroupNorm):
    """GroupNorm(min(8, C) groups, eps 1e-6) in fp32 (statistics, and scale
    and bias upcast when the serving weights are bf16), output in ``dtype``."""

    def __init__(self, c: int, dtype: torch.dtype = torch.float32):
        super().__init__(min(8, c), c, eps=1e-6)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight.float(), self.bias.float(),
                            self.eps).to(self.dtype)


class ResBlock2D(nn.Module):
    """x + conv2(silu(norm2(conv1(silu(norm1(x)))))), with a 1x1 conv3 on the
    skip when the width changes."""

    def __init__(self, c_in: int, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = GroupNorm(c_in, dtype)
        self.conv1 = Conv2d(c_in, features, 3, dtype=dtype)
        self.norm2 = GroupNorm(features, dtype)
        self.conv2 = Conv2d(features, features, 3, dtype=dtype)
        self.conv3 = Conv2d(c_in, features, 1, dtype=dtype) if c_in != features else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv3 is not None:
            x = self.conv3(x)
        return x + h


def upsample2x_nearest(h: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, 2H, 2W], each pixel repeated 2x2."""
    B, C, H, W = h.shape
    return h[:, :, :, None, :, None].expand(B, C, H, 2, W, 2).reshape(B, C, 2 * H, 2 * W)


class ImageVAE(nn.Module):
    def __init__(self, cfg: ImageVAEConfig):
        super().__init__()
        self.cfg = c = cfg
        dt, n = c.dtype, c.n_stages
        self.enc_in = Conv2d(c.in_ch, c.ch(0), 3, dtype=dt)
        for s in range(n):
            for b in range(c.blocks_per_stage):
                self.add_module(f"enc_{s}_{b}", ResBlock2D(c.ch(s), c.ch(s), dt))
            self.add_module(f"enc_down_{s}", Conv2d(c.ch(s), c.ch(s + 1), 3, 2, dt))
        self.enc_mid = ResBlock2D(c.ch(n), c.ch(n), dt)
        if c.variational:
            self.to_mu = Conv2d(c.ch(n), c.lat_ch, 1, dtype=dt)
            self.to_logv = Conv2d(c.ch(n), c.lat_ch, 1, dtype=dt)
        else:
            self.to_lat = Conv2d(c.ch(n), c.lat_ch, 1, dtype=dt)

        self.dec_in = Conv2d(c.lat_ch, c.ch(n), 3, dtype=dt)
        self.dec_mid = ResBlock2D(c.ch(n), c.ch(n), dt)
        for s in range(n):
            self.add_module(f"dec_up_{s}", Conv2d(c.ch(s + 1), c.ch(s), 3, dtype=dt))
            for b in range(c.blocks_per_stage):
                self.add_module(f"dec_{s}_{b}", ResBlock2D(c.ch(s), c.ch(s), dt))
        self.dec_norm = GroupNorm(c.ch(0), dt)
        self.dec_out = Conv2d(c.ch(0), c.in_ch, 3, dtype=dt)

    def _blocks(self, kind: str, s: int):
        return [getattr(self, f"{kind}_{s}_{b}") for b in range(self.cfg.blocks_per_stage)]

    def encode_with_kld(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                        noise: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """x: [B, C, H, W] -> (z [B, lat_ch, H/down, W/down], kld | None).

        Variational: z = mu + noise * exp(logv / 2), the noise `noise` or
        drawn from `generator` ([B, lat_ch, h, w], mu's dtype); with neither,
        z = mu. kld = 0.5 mean(mu^2 + exp(logv) - 1 - logv) in fp32."""
        c = self.cfg
        h = self.enc_in(x.to(c.dtype))
        for s in range(c.n_stages):
            for blk in self._blocks("enc", s):
                h = blk(h)
            h = getattr(self, f"enc_down_{s}")(h)
        h = self.enc_mid(h)
        if not c.variational:
            return self.to_lat(h), None
        mu, logv = self.to_mu(h), self.to_logv(h)
        if noise is None and generator is not None:
            noise = torch.randn(mu.shape, generator=generator, device=mu.device)
        z = mu if noise is None else mu + noise.to(mu.dtype) * torch.exp(0.5 * logv)
        lv = logv.float()
        kld = 0.5 * torch.mean(-1.0 - lv + mu.float() ** 2 + torch.exp(lv))
        return z, kld

    def encode(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
               ) -> torch.Tensor:
        return self.encode_with_kld(x, generator)[0]

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z: [B, lat_ch, h, w] -> x_hat [B, C, h*down, w*down]."""
        c = self.cfg
        h = self.dec_mid(self.dec_in(z.to(c.dtype)))
        for s in reversed(range(c.n_stages)):
            h = getattr(self, f"dec_up_{s}")(upsample2x_nearest(h))
            for blk in self._blocks("dec", s):
                h = blk(h)
        x = self.dec_out(F.silu(self.dec_norm(h)))
        return torch.tanh(x) if c.out_activation == "tanh" else torch.sigmoid(x)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """Autoencode: (x_hat, z, kld)."""
        z, kld = self.encode_with_kld(x, generator)
        return self.decode(z), z, kld
