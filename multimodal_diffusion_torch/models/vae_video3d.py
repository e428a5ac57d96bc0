"""VideoVAE, conv arch (counterpart of the JAX ``models/vae_video3d.py``).

  encode: conv blocks (Conv3d k=3 -> GELU -> GroupNorm) -> AvgPool3d
          (t_down, s_down, s_down) -> 1x1 conv to lat_ch
          [B,3,T,H,W] -> [B,Cv,T/t_down,H/s_down,W/s_down]
  decode: 1x1 -> trilinear upsample (half-pixel centres) -> conv blocks ->
          1x1 -> sigmoid/tanh

Channels-first [B, C, T, H, W] throughout. ``arch: patch`` comes with the
flagship config later; the variational VAE, which no config uses, is not
ported.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class VideoVAEConfig:
    in_ch: int = 3
    lat_ch: int = 8
    t_down: int = 4
    s_down: int = 8
    enc_base: int = 64
    enc_blocks: int = 2
    dec_base: int = 64
    dec_blocks: int = 2
    variational: bool = False
    out_activation: str = "sigmoid"  # "sigmoid" | "tanh"
    arch: str = "conv"
    dtype: Any = torch.float32

    @classmethod
    def from_dict(cls, d: Dict, **overrides) -> "VideoVAEConfig":
        """Config tree matches the YAML `video:` block."""
        lat = d.get("latent", {})
        enc = d.get("encoder", {})
        dec = d.get("decoder", {})
        kw = dict(
            in_ch=int(d.get("in_ch", 3)),
            lat_ch=int(lat.get("channels", 8)),
            t_down=int(lat.get("t_down", 4)),
            s_down=int(lat.get("s_down", 8)),
            enc_base=int(enc.get("base", 64)),
            enc_blocks=int(enc.get("blocks", 2)),
            dec_base=int(dec.get("base", 64)),
            dec_blocks=int(dec.get("blocks", 2)),
            variational=bool(d.get("variational", False)),
            out_activation=str(d.get("out_activation", "sigmoid")),
            arch=str(d.get("arch", enc.get("arch", "conv"))),
        )
        kw.update(overrides)
        return cls(**kw)


class Conv3d(nn.Conv3d):
    """'same'-padded Conv3d computed in ``dtype`` (fp32 weights)."""

    def __init__(self, c_in: int, c_out: int, k: int, dtype: torch.dtype):
        super().__init__(c_in, c_out, k, padding=k // 2)
        nn.init.zeros_(self.weight)
        nn.init.zeros_(self.bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x.to(self.dtype), self.weight.to(self.dtype),
                                  self.bias.to(self.dtype))


class ConvBlock3D(nn.Module):
    """Conv3d(k=3, same) -> GELU -> GroupNorm(min(8, C), eps 1e-5): the norm
    sits AFTER the activation. GroupNorm statistics in fp32."""

    def __init__(self, c_in: int, features: int, dtype: torch.dtype):
        super().__init__()
        self.conv = Conv3d(c_in, features, 3, dtype)
        self.norm = nn.GroupNorm(min(8, features), features, eps=1e-5)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.gelu(self.conv(x), approximate="none")
        return self.norm(x.float()).to(self.dtype)


class VideoVAE(nn.Module):
    def __init__(self, cfg: VideoVAEConfig):
        super().__init__()
        if cfg.arch != "conv":
            raise NotImplementedError(
                f"VideoVAE arch {cfg.arch!r} is not ported yet (only 'conv')")
        if cfg.variational:
            raise NotImplementedError("the variational VideoVAE is not ported")
        self.cfg = cfg
        c, dt = cfg, cfg.dtype
        self.enc = nn.ModuleList(
            ConvBlock3D(c.in_ch if i == 0 else c.enc_base, c.enc_base, dt)
            for i in range(c.enc_blocks))
        enc_out = c.enc_base if c.enc_blocks else c.in_ch
        self.to_lat = Conv3d(enc_out, c.lat_ch, 1, dt)
        self.from_lat = Conv3d(c.lat_ch, c.dec_base, 1, dt)
        self.dec = nn.ModuleList(
            ConvBlock3D(c.dec_base, c.dec_base, dt) for _ in range(c.dec_blocks))
        self.to_img = Conv3d(c.dec_base, c.in_ch, 1, dt)

    def _center_crop(self, x: torch.Tensor) -> torch.Tensor:
        """Center-crop [B,C,T,H,W] so dims divide the downsample factors."""
        c = self.cfg
        B, C, T, H, W = x.shape
        T2 = (T // c.t_down) * c.t_down
        H2 = (H // c.s_down) * c.s_down
        W2 = (W // c.s_down) * c.s_down
        if (T2, H2, W2) == (T, H, W):
            return x
        warnings.warn(
            f"[VideoVAE] input (T={T},H={H},W={W}) not divisible by "
            f"(t_down={c.t_down}, s_down={c.s_down}); center-cropping to "
            f"(T={T2},H={H2},W={W2}).")
        t0, h0, w0 = (T - T2) // 2, (H - H2) // 2, (W - W2) // 2
        return x[:, :, t0:t0 + T2, h0:h0 + H2, w0:w0 + W2]

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, 3, T, H, W] -> z: [B, Cv, T', H', W']."""
        c = self.cfg
        h = self._center_crop(x).to(c.dtype)
        for blk in self.enc:
            h = blk(h)
        h = F.avg_pool3d(h, kernel_size=(c.t_down, c.s_down, c.s_down))
        return self.to_lat(h)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z: [B, Cv, T', H', W'] -> x_hat: [B, 3, T, H, W] in [0,1] (sigmoid)
        or [-1,1] (tanh)."""
        c = self.cfg
        _, _, Tp, Hp, Wp = z.shape
        h = self.from_lat(z.to(c.dtype))
        size = (Tp * c.t_down, Hp * c.s_down, Wp * c.s_down)
        h = F.interpolate(h, size=size, mode="trilinear", align_corners=False)
        for blk in self.dec:
            h = blk(h)
        x = self.to_img(h)
        return torch.sigmoid(x) if c.out_activation == "sigmoid" else torch.tanh(x)
