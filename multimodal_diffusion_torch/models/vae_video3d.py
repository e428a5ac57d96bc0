"""VideoVAE (counterpart of the JAX ``models/vae_video3d.py``), two archs.

``arch: conv`` (mvp):
  encode: conv blocks (Conv3d k=3 -> GELU -> GroupNorm) -> AvgPool3d
          (t_down, s_down, s_down) -> 1x1 conv to lat_ch
          [B,3,T,H,W] -> [B,Cv,T/t_down,H/s_down,W/s_down]
  decode: 1x1 -> trilinear upsample (half-pixel centres) -> conv blocks ->
          1x1 -> sigmoid/tanh

``arch: patch`` (the flagship): the downsampling is one Dense over
non-overlapping (t_down, s_down, s_down) tubelets, and every conv block runs
at latent resolution:
  encode: patchify -> Dense (patch_dim -> hidden) -> LayerNorm (eps 1e-6) ->
          GELU -> conv blocks -> 1x1 conv to lat_ch
  decode: 1x1 -> conv blocks -> Dense (hidden -> patch_dim) -> unpatchify ->
          sigmoid/tanh

Channels-first [B, C, T, H, W] at the boundary and in the convs; a tubelet's
vector is ordered (t, h, w, C) with C last, as the JAX package builds it from
its channels-last layout, so ``patch_embed``/``unpatch_proj`` weights carry
across.

``variational: true`` (no config uses it) replaces ``to_lat`` with the 1x1
convs ``to_mu`` and ``to_logv``: ``encode_with_kld`` returns mu, or
mu + eps * exp(logv / 2) when it is given noise or a generator, and the fp32
KL mean; ``forward`` returns (x_hat, z, kld).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_antialiased
from .adapters import Dense
from .mmdit import LayerNorm


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
    arch: str = "conv"  # "conv" | "patch"
    hidden: int = 0  # patch-arch channel width (0 -> 2 * enc_base)
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
            hidden=int(enc.get("hidden", 0)),
        )
        kw.update(overrides)
        return cls(**kw)

    @property
    def patch_hidden(self) -> int:
        return self.hidden if self.hidden > 0 else 2 * self.enc_base

    @property
    def patch_dim(self) -> int:
        return self.t_down * self.s_down * self.s_down * self.in_ch


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
    sits AFTER the activation. GroupNorm in fp32 (statistics, and scale and
    bias upcast when the serving weights are bf16)."""

    def __init__(self, c_in: int, features: int, dtype: torch.dtype):
        super().__init__()
        self.conv = Conv3d(c_in, features, 3, dtype)
        self.norm = nn.GroupNorm(min(8, features), features, eps=1e-5)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.gelu(self.conv(x), approximate="none")
        n = self.norm
        return F.group_norm(x.float(), n.num_groups, n.weight.float(), n.bias.float(),
                            n.eps).to(self.dtype)


def _resize(x: torch.Tensor, size: Tuple[int, int, int]) -> torch.Tensor:
    """[B, C, T, H, W] resized to `size` as ``jax.image.resize(...,
    "trilinear")``: trilinear with half-pixel centres (``F.interpolate``)
    when no axis shrinks, else the antialiased triangle kernel on every axis
    that changes (``ops/resize.py``). When enlarging the antialiased kernel
    is the same function; ``F.interpolate`` is kept there only for the
    enlarging path's bits, which earlier tests pin, and its speed (one
    kernel on the card against three dense contractions)."""
    if all(n >= m for n, m in zip(size, x.shape[2:])):
        return F.interpolate(x, size=size, mode="trilinear", align_corners=False)
    return resize_antialiased(x, size, (2, 3, 4))


class VideoVAE(nn.Module):
    def __init__(self, cfg: VideoVAEConfig):
        super().__init__()
        if cfg.arch not in ("conv", "patch"):
            raise ValueError(f"VideoVAE arch must be 'conv'|'patch', got {cfg.arch!r}")
        self.cfg = cfg
        c, dt = cfg, cfg.dtype
        patch = c.arch == "patch"
        if patch:
            enc_width = dec_width = c.patch_hidden
            self.patch_embed = Dense(c.patch_dim, enc_width, dt)
            self.patch_norm = LayerNorm(enc_width, eps=1e-6, dtype=dt)  # flax's default eps
            enc_in = enc_width
        else:
            enc_width, dec_width, enc_in = c.enc_base, c.dec_base, c.in_ch
        self.enc = nn.ModuleList(
            ConvBlock3D(enc_in if i == 0 else enc_width, enc_width, dt)
            for i in range(c.enc_blocks))
        lat_in = enc_width if c.enc_blocks else enc_in
        if c.variational:
            self.to_mu = Conv3d(lat_in, c.lat_ch, 1, dt)
            self.to_logv = Conv3d(lat_in, c.lat_ch, 1, dt)
        else:
            self.to_lat = Conv3d(lat_in, c.lat_ch, 1, dt)
        self.from_lat = Conv3d(c.lat_ch, dec_width, 1, dt)
        self.dec = nn.ModuleList(
            ConvBlock3D(dec_width, dec_width, dt) for _ in range(c.dec_blocks))
        if patch:
            self.unpatch_proj = Dense(dec_width, c.patch_dim, dt)
        else:
            self.to_img = Conv3d(dec_width, c.in_ch, 1, dt)

    def _patchify(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C, T, H, W] -> [B, T', H', W', t_down*s_down*s_down*C]:
        non-overlapping tubelets, each vector ordered (t, h, w, C)."""
        td, sd = self.cfg.t_down, self.cfg.s_down
        B, C, T, H, W = x.shape
        x = x.reshape(B, C, T // td, td, H // sd, sd, W // sd, sd)
        return x.permute(0, 2, 4, 6, 3, 5, 7, 1).reshape(
            B, T // td, H // sd, W // sd, td * sd * sd * C)

    def _unpatchify(self, h: torch.Tensor) -> torch.Tensor:
        """[B, T', H', W', t_down*s_down*s_down*C] -> [B, C, T, H, W]."""
        td, sd, C = self.cfg.t_down, self.cfg.s_down, self.cfg.in_ch
        B, Tp, Hp, Wp, _ = h.shape
        h = h.reshape(B, Tp, Hp, Wp, td, sd, sd, C)
        return h.permute(0, 7, 1, 4, 2, 5, 3, 6).reshape(B, C, Tp * td, Hp * sd, Wp * sd)

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

    def encode_with_kld(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                        noise: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """x: [B, 3, T, H, W] -> (z [B, Cv, T', H', W'], kld | None).

        Variational: z = mu + noise * exp(logv / 2), the noise `noise` or
        drawn from `generator` ([B, Cv, T', H', W'], cast to mu's dtype); with
        neither (eval), z = mu. kld = 0.5 mean(mu^2 + exp(logv) - 1 - logv)
        in fp32."""
        h = self._encode_features(x)
        if not self.cfg.variational:
            return self.to_lat(h), None
        mu, logv = self.to_mu(h), self.to_logv(h)
        if noise is None and generator is not None:
            noise = torch.randn(mu.shape, generator=generator, device=mu.device)
        z = mu if noise is None else mu + noise.to(mu.dtype) * torch.exp(0.5 * logv)
        lv = logv.float()
        kld = 0.5 * torch.mean(-1.0 - lv + mu.float() ** 2 + torch.exp(lv))
        return z, kld

    def encode(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: [B, 3, T, H, W] -> z: [B, Cv, T', H', W']."""
        return self.encode_with_kld(x, generator, noise)[0]

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None):
        """Full autoencode: (x_hat, z, kld)."""
        z, kld = self.encode_with_kld(x, generator, noise)
        return self.decode(z), z, kld

    def _encode_features(self, x: torch.Tensor) -> torch.Tensor:
        """The encoder's features at latent resolution, before the latent
        projection."""
        c = self.cfg
        h = self._center_crop(x).to(c.dtype)
        if c.arch == "patch":
            h = F.gelu(self.patch_norm(self.patch_embed(self._patchify(h))),
                       approximate="none")
            h = h.permute(0, 4, 1, 2, 3)  # [B, hidden, T', H', W']
            for blk in self.enc:
                h = blk(h)
        else:
            for blk in self.enc:
                h = blk(h)
            h = F.avg_pool3d(h, kernel_size=(c.t_down, c.s_down, c.s_down))
        return h

    def decode(self, z: torch.Tensor,
               out_size: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
        """z: [B, Cv, T', H', W'] -> x_hat: [B, 3, T, H, W] in [0,1] (sigmoid)
        or [-1,1] (tanh). (T, H, W) is the latent grid times the downsample
        factors, or ``out_size``: the patch arch resizes its decoded frames
        to it, the conv arch its hidden grid before the decoder blocks, as
        the JAX package's ``jax.image.resize(..., "trilinear")``
        (``_resize``)."""
        c = self.cfg
        _, _, Tp, Hp, Wp = z.shape
        natural = (Tp * c.t_down, Hp * c.s_down, Wp * c.s_down)
        size = natural if out_size is None else tuple(int(n) for n in out_size)
        h = self.from_lat(z.to(c.dtype))
        if c.arch == "patch":
            for blk in self.dec:
                h = blk(h)
            x = self._unpatchify(self.unpatch_proj(h.permute(0, 2, 3, 4, 1)))
            if size != natural:
                x = _resize(x, size)
        else:
            h = _resize(h, size)
            for blk in self.dec:
                h = blk(h)
            x = self.to_img(h)
        return torch.sigmoid(x) if c.out_activation == "sigmoid" else torch.tanh(x)
