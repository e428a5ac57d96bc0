"""AVDiffusionModel — the joint audio<->video latent diffusion model
(counterpart of the JAX ``models/diffusion.py``), eval-mode forward:

    latents --tokenize--> raw tokens --adapters--> width-d tokens
      (+ modality embedding, + positional embeddings, + timestep embedding)
      --[cfg keep-mask]--> MMDiT core --> per-modality noise heads --> eps

Submodule names follow the JAX parameter tree {vid_vae, aud_codec, adapt_v,
adapt_a, embed, t_embed, core, head}, so ``utils/convert.py`` maps a JAX
checkpoint onto this module's state_dict.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..ops import tokenize as tk
from .adapters import (
    Dense,
    LinearAdapter,
    ModalityEmbedding,
    PositionalEmbedding1D,
    PositionalEmbedding3D,
    TimestepEmbedder,
)
from .audio_codec import AudioCodec, AudioCodecConfig, Conv1d
from .heads import MultiModalNoiseHead
from .mmdit import MMDiT, MMDiTConfig
from .vae_video3d import Conv3d, VideoVAE, VideoVAEConfig


@dataclasses.dataclass(frozen=True)
class AVDiffusionConfig:
    """Derived from the merged YAML tree (same key paths as configs/mvp.yaml)."""

    width: int = 512
    tube: Tuple[int, int, int] = (2, 4, 4)  # (t, h, w)
    chunk: Tuple[int, int] = (4, 4)  # (length, stride)
    vae: VideoVAEConfig = dataclasses.field(default_factory=VideoVAEConfig)
    codec: AudioCodecConfig = dataclasses.field(default_factory=AudioCodecConfig)
    core: MMDiTConfig = dataclasses.field(default_factory=MMDiTConfig)
    head_hidden: int = 512
    head_activation: str = "gelu"
    head_num_layers: int = 2
    out_dim_v: int = 256
    out_dim_a: int = 32
    timestep_mode: str = "sinusoidal"  # "sinusoidal" | "mlp"
    use_modality_embed: bool = True
    posenc_video: str = "learned_3d"  # "learned_3d" | "sin" | "none"
    posenc_audio: str = "learned_1d"  # "learned_1d" | "sin" | "none"
    latent_rmsnorm: bool = False
    dtype: Any = torch.float32

    @classmethod
    def from_config(cls, cfg: Dict, dtype: Any = torch.float32) -> "AVDiffusionConfig":
        mouth = (cfg.get("conditioning", {}) or {}).get("mouth_crop", {}) or {}
        if mouth.get("enabled", False):
            raise NotImplementedError(
                "conditioning.mouth_crop is not ported yet (the specificity8 slice)")
        par = cfg.get("parallel", {}) or {}
        for key in ("context", "pipe"):
            if int(par.get(key, 1) or 1) > 1:
                raise NotImplementedError(
                    f"parallel.{key} > 1 is not ported yet (a later slice)")
        tok = cfg["tokenizer"]
        tube = tok["video"]["tube"]
        chunk = tok["audio"]["chunk"]
        heads = cfg["model"]["heads"]
        emb = cfg.get("embeddings", {})
        posenc = emb.get("posenc", {})
        return cls(
            width=int(tok["width"]),
            tube=(int(tube["t"]), int(tube["h"]), int(tube["w"])),
            chunk=(int(chunk["length"]), int(chunk["stride"])),
            vae=VideoVAEConfig.from_dict(cfg["video"], dtype=dtype),
            codec=AudioCodecConfig.from_dict(cfg["audio"], dtype=dtype),
            core=MMDiTConfig.from_dict(cfg["model"]["core"], dtype=dtype),
            head_hidden=int(heads["video"]["hidden_dim"]),
            head_num_layers=int(heads["video"].get("num_layers", 2)),
            head_activation=heads["video"].get("activation", "gelu"),
            out_dim_v=int(heads["video"]["out_dim"]),
            out_dim_a=int(heads["audio"]["out_dim"]),
            timestep_mode=str(emb.get("timestep_embed", "sinusoidal")),
            use_modality_embed=bool(emb.get("use_modality_embed", True)),
            posenc_video=str(posenc.get("video", "learned_3d")),
            posenc_audio=str(posenc.get("audio", "learned_1d")),
            latent_rmsnorm=bool(cfg["model"].get("latent_rmsnorm", False)),
            dtype=dtype,
        )

    @property
    def token_dim_video(self) -> int:
        t, h, w = self.tube
        return self.vae.lat_ch * t * h * w

    @property
    def token_dim_audio(self) -> int:
        return self.codec.lat_ch * self.chunk[0]


class Embeddings(nn.Module):
    """Modality + positional embeddings, grouped under one parameter key."""

    def __init__(self, c: AVDiffusionConfig):
        super().__init__()
        self.cfg = c
        if c.use_modality_embed:
            self.modality = ModalityEmbedding(c.width, ("video", "audio"), c.dtype)
        if c.posenc_video != "none":
            self.pos_v = PositionalEmbedding3D(
                c.width, mode="learned" if c.posenc_video.startswith("learned") else "sin",
                dtype=c.dtype)
        if c.posenc_audio != "none":
            self.pos_a = PositionalEmbedding1D(
                c.width, mode="learned" if c.posenc_audio.startswith("learned") else "sin",
                dtype=c.dtype)

    def forward(self, Xv: torch.Tensor, Xa: torch.Tensor,
                video_grid: Tuple[int, int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
        c = self.cfg
        if c.use_modality_embed:
            Xv = self.modality(Xv, "video")
            Xa = self.modality(Xa, "audio")
        if c.posenc_video != "none":
            Xv = Xv + self.pos_v(*video_grid, device=Xv.device)
        if c.posenc_audio != "none":
            Xa = Xa + self.pos_a(Xa.shape[1], device=Xa.device)
        return Xv, Xa


class AVDiffusionModel(nn.Module):
    def __init__(self, cfg: AVDiffusionConfig):
        super().__init__()
        c = self.cfg = cfg
        if c.timestep_mode not in ("sinusoidal", "mlp"):
            raise ValueError(
                f"embeddings.timestep_embed must be sinusoidal|mlp, got {c.timestep_mode!r}")
        self.vid_vae = VideoVAE(c.vae)
        self.aud_codec = AudioCodec(c.codec)
        self.adapt_v = LinearAdapter(c.token_dim_video, c.width, c.dtype)
        self.adapt_a = LinearAdapter(c.token_dim_audio, c.width, c.dtype)
        self.embed = Embeddings(c)
        self.t_embed = TimestepEmbedder(
            dim=c.width, mode="mlp" if c.timestep_mode == "mlp" else "sin", dtype=c.dtype)
        self.core = MMDiT(c.core)
        self.head = MultiModalNoiseHead(
            input_dims={"video": c.core.d_model, "audio": c.core.d_model},
            output_dims={"video": c.out_dim_v, "audio": c.out_dim_a},
            hidden_dim=c.head_hidden,
            num_shared_layers=c.head_num_layers,
            activation=c.head_activation,
            dtype=c.dtype)

    # ------------------ codec passthroughs ------------------

    def _latent_norm(self, z: torch.Tensor) -> torch.Tensor:
        """Per-sample RMS normalization (cfg.latent_rmsnorm)."""
        if not self.cfg.latent_rmsnorm:
            return z
        ms = torch.mean(torch.square(z), dim=tuple(range(1, z.ndim)), keepdim=True)
        return z * torch.rsqrt(ms + 1e-8)

    def encode_video(self, x: torch.Tensor) -> torch.Tensor:
        return self._latent_norm(self.vid_vae.encode(x))

    def decode_video(self, z: torch.Tensor) -> torch.Tensor:
        return self.vid_vae.decode(z)

    def encode_audio(self, wav: torch.Tensor) -> torch.Tensor:
        return self._latent_norm(self.aud_codec.encode(wav))

    def decode_audio(self, z: torch.Tensor) -> torch.Tensor:
        return self.aud_codec.decode(z)

    # ------------------ tokenization ------------------

    def tokenize_video(self, z_v: torch.Tensor) -> torch.Tensor:
        t, h, w = self.cfg.tube
        return tk.tube_patch_video(z_v, t, h, w)

    def tokenize_audio(self, z_a: torch.Tensor) -> torch.Tensor:
        l, s = self.cfg.chunk
        return tk.audio_tokens_from_latent(z_a, l, s)

    def untokenize_video(self, tok: torch.Tensor, latent_shape) -> torch.Tensor:
        t, h, w = self.cfg.tube
        _, C, T, H, W = latent_shape
        return tk.tube_unpatch_video(tok, C, T, H, W, t, h, w)

    def untokenize_audio(self, tok: torch.Tensor, latent_shape) -> torch.Tensor:
        l, s = self.cfg.chunk
        _, C, F_ = latent_shape
        return tk.audio_latent_from_tokens(tok, C, l, F_, s)

    def video_grid(self, z_v_shape) -> Tuple[int, int, int]:
        t, h, w = self.cfg.tube
        return (z_v_shape[2] // t, z_v_shape[3] // h, z_v_shape[4] // w)

    # ------------------ denoiser ------------------

    def embed_tokens(self, tok_v: torch.Tensor, tok_a: torch.Tensor,
                     t_v: torch.Tensor, t_a: torch.Tensor,
                     video_grid: Tuple[int, int, int],
                     keep_v: Optional[torch.Tensor] = None,
                     keep_a: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, int]:
        """Project + embed + timestep-ADD + CFG keep-mask; returns (X, Nv).
        The keep multiplier applies AFTER all embeddings."""
        Xv = self.adapt_v(tok_v)
        Xa = self.adapt_a(tok_a)
        Xv, Xa = self.embed(Xv, Xa, video_grid)
        Xv = Xv + self.t_embed(t_v).to(Xv.dtype)[:, None, :]
        Xa = Xa + self.t_embed(t_a).to(Xa.dtype)[:, None, :]
        if keep_v is not None:
            Xv = Xv * keep_v.to(Xv.dtype)[:, None, None]
        if keep_a is not None:
            Xa = Xa * keep_a.to(Xa.dtype)[:, None, None]
        return torch.cat([Xv, Xa], dim=1), Xv.shape[1]

    def denoise_tokens(self, tok_v: torch.Tensor, tok_a: torch.Tensor,
                       t_v: torch.Tensor, t_a: torch.Tensor,
                       video_grid: Tuple[int, int, int],
                       keep_v: Optional[torch.Tensor] = None,
                       keep_a: Optional[torch.Tensor] = None,
                       use_kernel: Optional[bool] = None) -> Dict[str, torch.Tensor]:
        """Full denoiser pass: {'eps_v', 'eps_a', 'h_v', 'h_a'}.
        ``use_kernel`` picks the attention backend (None: by device)."""
        X, Nv = self.embed_tokens(tok_v, tok_a, t_v, t_a, video_grid, keep_v, keep_a)
        Na = tok_a.shape[1]
        H = self.core(X, use_kernel=use_kernel)
        Hv, Ha = H[:, :Nv], H[:, Nv:Nv + Na]
        eps = self.head({"video": Hv, "audio": Ha})
        return {"eps_v": eps["video"], "eps_a": eps["audio"], "h_v": Hv, "h_a": Ha}

    def denoise_latents(self, z_v: torch.Tensor, z_a: torch.Tensor,
                        t_v: torch.Tensor, t_a: torch.Tensor,
                        keep_v: Optional[torch.Tensor] = None,
                        keep_a: Optional[torch.Tensor] = None,
                        use_kernel: Optional[bool] = None) -> Dict[str, torch.Tensor]:
        """Latent-space wrapper: tokenize -> denoise -> fold eps back."""
        out = self.denoise_tokens(self.tokenize_video(z_v), self.tokenize_audio(z_a),
                                  t_v, t_a, self.video_grid(z_v.shape), keep_v, keep_a,
                                  use_kernel)
        return {
            "eps_v": self.untokenize_video(out["eps_v"], z_v.shape),
            "eps_a": self.untokenize_audio(out["eps_a"], z_a.shape),
            "h_v": out["h_v"],
            "h_a": out["h_a"],
        }


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init with the JAX package's initializer families:
    xavier-uniform Dense kernels, lecun-normal 3-D convs, the codec's
    kaiming-uniform (a=0.2) 1-D convs, N(0, 0.02) embedding tables, zero
    biases, unit norm scales. Draws come from ``generator``, so a seed fixes
    the weights (they are not the JAX package's draws)."""
    for mod in model.modules():
        if isinstance(mod, Dense):
            nn.init.xavier_uniform_(mod.weight, generator=generator)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, Conv3d):
            fan_in = mod.weight[0].numel()
            # flax lecun_normal: truncated at 2 std, std corrected for the cut
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, Conv1d):
            fan_in = mod.weight[0].numel()
            lim = math.sqrt(3.0 * (2.0 / (1.0 + 0.2 ** 2)) / fan_in)
            nn.init.uniform_(mod.weight, -lim, lim, generator=generator)
            nn.init.zeros_(mod.bias)
    for name, p in model.named_parameters():
        if name.endswith("table"):
            nn.init.normal_(p, 0.0, 0.02, generator=generator)
