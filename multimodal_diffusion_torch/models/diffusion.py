"""AVDiffusionModel — the joint audio<->video latent diffusion model
(counterpart of the JAX ``models/diffusion.py``):

    latents --tokenize--> raw tokens --adapters--> width-d tokens
      (+ modality embedding, + positional embeddings, + timestep embedding)
      --[cfg keep-mask]--> MMDiT core --> per-modality noise heads --> eps

``denoise_tokens``/``denoise_latents`` serve sampling; ``forward`` is the
training pass (encode -> q_sample -> denoise, plus the token-space targets
and, on request, the reconstructions). Dropout follows ``train()``/``eval()``.
On the card an eval-mode ``denoise_tokens`` without grad replays a captured
CUDA graph of itself (``models/graphed.py``).

With ``conditioning.mouth_crop.enabled`` a second, VAE-free conditioning
stream joins the sequence after audio: raw pixels of a fixed mouth box,
tube-patched into tokens, embedded at t = 0. It conditions only (the heads
never see it) and is zeroed whenever video is the target or is CFG-dropped.

Submodule names follow the JAX parameter tree {vid_vae, aud_codec, adapt_v,
adapt_a, adapt_m, embed, t_embed, core, head}, so ``utils/convert.py`` maps a
JAX checkpoint onto this module's state_dict.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..ops import tokenize as tk
from ..ops.schedule import prediction_target, q_sample
from ..parallel.sharding import tp_part
from .adapters import (
    Dense,
    LinearAdapter,
    ModalityEmbedding,
    PositionalEmbedding1D,
    PositionalEmbedding3D,
    TimestepEmbedder,
)
from .audio_codec import AudioCodec, AudioCodecConfig, Conv1d
from . import graphed
from .heads import MultiModalNoiseHead
from .mmdit import MMDiT, MMDiTConfig
from .vae_image2d import Conv2d
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
    head_dropout: float = 0.1
    head_activation: str = "gelu"
    head_num_layers: int = 2
    out_dim_v: int = 256
    out_dim_a: int = 32
    timestep_mode: str = "sinusoidal"  # "sinusoidal" | "mlp"
    use_modality_embed: bool = True
    posenc_video: str = "learned_3d"  # "learned_3d" | "sin" | "none"
    posenc_audio: str = "learned_1d"  # "learned_1d" | "sin" | "none"
    # prediction parameterization per modality: "eps" | "x0" | "v"
    # (config keys diffusion.{video,audio}.param)
    param_v: str = "eps"
    param_a: str = "eps"
    # conditioning.mouth_crop.*: the mouth-crop conditioning stream
    mouth_enabled: bool = False
    mouth_box: Tuple[int, int, int, int] = (64, 112, 32, 96)  # h0, h1, w0, w1
    mouth_tube: Tuple[int, int, int] = (2, 8, 8)  # (t, h, w) on PIXELS
    latent_rmsnorm: bool = False
    # model.encoder_stopgrad: stop the diffusion loss's gradient at the
    # encoder outputs (the encoders then train on reconstruction only, so it
    # needs training.recon_loss_weight > 0)
    encoder_stopgrad: bool = False
    dtype: Any = torch.float32

    @classmethod
    def from_config(cls, cfg: Dict, dtype: Any = torch.float32,
                    remat: bool = False, mesh: Any = None) -> "AVDiffusionConfig":
        """`mesh` (parallel/mesh.py) carries the core's layouts:
        ``parallel.context > 1`` needs one with a 'context' axis,
        ``parallel.pipe > 1`` one with a 'pipe' axis (the two do not
        combine), and a 'model' axis of size > 1 splits the core's heads
        and MLP units."""
        mouth = (cfg.get("conditioning", {}) or {}).get("mouth_crop", {}) or {}
        mtube = mouth.get("tube", {}) or {}
        par = cfg.get("parallel", {}) or {}
        n_context = int(par.get("context", 1) or 1)
        n_pipe = int(par.get("pipe", 1) or 1)
        layout = {}
        if n_context > 1:
            if mesh is None or "context" not in mesh.axis_names:
                raise ValueError("parallel.context > 1 requires a mesh with a 'context' "
                                 "axis (make_mesh_from_config builds one)")
            layout = {"context_axis": "context",
                      "context_flash": bool(par.get("context_flash", False))}
        if n_pipe > 1:
            if n_context > 1:
                raise ValueError("parallel.pipe and parallel.context cannot be combined")
            if mesh is None or "pipe" not in mesh.axis_names:
                raise ValueError("parallel.pipe > 1 requires a mesh with a 'pipe' axis "
                                 "(make_mesh_from_config builds one)")
            layout = {"pipe_axis": "pipe",
                      "pipe_microbatches": int(par.get("pipe_microbatches", 4))}
        if mesh is not None and mesh.size("model") > 1:
            layout["model_axis"] = "model"
        if layout:
            layout["mesh"] = mesh
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
            core=MMDiTConfig.from_dict(cfg["model"]["core"], dtype=dtype, remat=remat,
                                       **layout),
            head_hidden=int(heads["video"]["hidden_dim"]),
            head_num_layers=int(heads["video"].get("num_layers", 2)),
            head_dropout=float(cfg["model"]["core"].get("dropout", 0.1)),
            head_activation=heads["video"].get("activation", "gelu"),
            out_dim_v=int(heads["video"]["out_dim"]),
            out_dim_a=int(heads["audio"]["out_dim"]),
            timestep_mode=str(emb.get("timestep_embed", "sinusoidal")),
            use_modality_embed=bool(emb.get("use_modality_embed", True)),
            posenc_video=str(posenc.get("video", "learned_3d")),
            posenc_audio=str(posenc.get("audio", "learned_1d")),
            param_v=str(cfg["diffusion"]["video"].get("param", "eps")),
            param_a=str(cfg["diffusion"]["audio"].get("param", "eps")),
            mouth_enabled=bool(mouth.get("enabled", False)),
            mouth_box=tuple(int(x) for x in mouth.get("box", (64, 112, 32, 96))),
            mouth_tube=(int(mtube.get("t", 2)), int(mtube.get("h", 8)),
                        int(mtube.get("w", 8))),
            latent_rmsnorm=bool(cfg["model"].get("latent_rmsnorm", False)),
            encoder_stopgrad=bool(cfg["model"].get("encoder_stopgrad", False)),
            dtype=dtype,
        )

    @property
    def token_dim_video(self) -> int:
        t, h, w = self.tube
        return self.vae.lat_ch * t * h * w

    @property
    def token_dim_audio(self) -> int:
        return self.codec.lat_ch * self.chunk[0]

    @property
    def token_dim_mouth(self) -> int:
        t, h, w = self.mouth_tube
        return 3 * t * h * w

    @property
    def mouth_crop_hw(self) -> Tuple[int, int]:
        h0, h1, w0, w1 = self.mouth_box
        return (h1 - h0, w1 - w0)


class Embeddings(nn.Module):
    """Modality + positional embeddings, grouped under one parameter key."""

    def __init__(self, c: AVDiffusionConfig):
        super().__init__()
        self.cfg = c
        if c.use_modality_embed:
            mods = ("video", "audio", "mouth") if c.mouth_enabled else ("video", "audio")
            self.modality = ModalityEmbedding(c.width, mods, c.dtype)
        if c.posenc_video != "none":
            self.pos_v = PositionalEmbedding3D(
                c.width, mode="learned" if c.posenc_video.startswith("learned") else "sin",
                dtype=c.dtype)
        if c.posenc_audio != "none":
            self.pos_a = PositionalEmbedding1D(
                c.width, mode="learned" if c.posenc_audio.startswith("learned") else "sin",
                dtype=c.dtype)
        if c.mouth_enabled:
            self.pos_m = PositionalEmbedding3D(
                c.width, mode="learned" if c.posenc_video.startswith("learned") else "sin",
                dtype=c.dtype)

    def mouth(self, Xm: torch.Tensor, grid_m: Tuple[int, int, int]) -> torch.Tensor:
        if self.cfg.use_modality_embed:
            Xm = self.modality(Xm, "mouth")
        return Xm + self.pos_m(*grid_m, device=Xm.device)

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
        if c.mouth_enabled:
            self.adapt_m = LinearAdapter(c.token_dim_mouth, c.width, c.dtype)
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
            dtype=c.dtype,
            dropout=c.head_dropout)
        self.graphs = graphed.DenoiserGraphs()

    # ------------------ codec passthroughs ------------------

    def _latent_norm(self, z: torch.Tensor) -> torch.Tensor:
        """Per-sample RMS normalization (cfg.latent_rmsnorm)."""
        if not self.cfg.latent_rmsnorm:
            return z
        ms = torch.mean(torch.square(z), dim=tuple(range(1, z.ndim)), keepdim=True)
        return z * torch.rsqrt(ms + 1e-8)

    def encode_video(self, x: torch.Tensor) -> torch.Tensor:
        return self._latent_norm(self.vid_vae.encode(x))

    def decode_video(self, z: torch.Tensor, out_size=None) -> torch.Tensor:
        return self.vid_vae.decode(z, out_size)

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

    def mouth_tokens(self, video: torch.Tensor) -> torch.Tensor:
        """Raw pixels [B, 3, T, H, W] -> mouth-crop tokens [B, Nm, Dm]: crop
        cfg.mouth_box from each frame (clipped to the frame), shift the
        pixels to [-0.5, 0.5] so that zero means CFG-dropped, and tube-patch
        them. No VAE in this path."""
        h0, h1, w0, w1 = self.cfg.mouth_box
        t, h, w = self.cfg.mouth_tube
        return tk.tube_patch_video(video[:, :, :, h0:h1, w0:w1] - 0.5, t, h, w)

    def mouth_grid(self, T: int) -> Tuple[int, int, int]:
        """The mouth tokens' (time, height, width) grid for T frames."""
        t, h, w = self.cfg.mouth_tube
        ch, cw = self.cfg.mouth_crop_hw
        return (T // t, ch // h, cw // w)

    # ------------------ denoiser ------------------

    def embed_tokens(self, tok_v: torch.Tensor, tok_a: torch.Tensor,
                     t_v: torch.Tensor, t_a: torch.Tensor,
                     video_grid: Tuple[int, int, int],
                     keep_v: Optional[torch.Tensor] = None,
                     keep_a: Optional[torch.Tensor] = None,
                     tok_m: Optional[torch.Tensor] = None,
                     keep_m: Optional[torch.Tensor] = None,
                     mouth_grid: Optional[Tuple[int, int, int]] = None
                     ) -> Tuple[torch.Tensor, int]:
        """Project + embed + timestep-ADD + CFG keep-mask; returns (X, Nv).
        The keep multiplier applies AFTER all embeddings. Mouth tokens (when
        the stream is enabled and they are given) are embedded at t = 0 and
        appended after audio."""
        Xv = self.adapt_v(tok_v)
        Xa = self.adapt_a(tok_a)
        Xv, Xa = self.embed(Xv, Xa, video_grid)
        Xv = Xv + self.t_embed(t_v).to(Xv.dtype)[:, None, :]
        Xa = Xa + self.t_embed(t_a).to(Xa.dtype)[:, None, :]
        if keep_v is not None:
            Xv = Xv * keep_v.to(Xv.dtype)[:, None, None]
        if keep_a is not None:
            Xa = Xa * keep_a.to(Xa.dtype)[:, None, None]
        parts = [Xv, Xa]
        if tok_m is not None:
            if not self.cfg.mouth_enabled:
                raise ValueError("mouth tokens passed but conditioning.mouth_crop.enabled "
                                 "is false")
            Xm = self.embed.mouth(self.adapt_m(tok_m), mouth_grid)
            # clean conditioning: embedded at t = 0 like the frozen prompt
            Xm = Xm + self.t_embed(torch.zeros_like(t_v)).to(Xm.dtype)[:, None, :]
            if keep_m is not None:
                Xm = Xm * keep_m.to(Xm.dtype)[:, None, None]
            parts.append(Xm)
        return torch.cat(parts, dim=1), Xv.shape[1]

    def denoise_tokens(self, tok_v: torch.Tensor, tok_a: torch.Tensor,
                       t_v: torch.Tensor, t_a: torch.Tensor,
                       video_grid: Tuple[int, int, int],
                       keep_v: Optional[torch.Tensor] = None,
                       keep_a: Optional[torch.Tensor] = None,
                       tok_m: Optional[torch.Tensor] = None,
                       keep_m: Optional[torch.Tensor] = None,
                       mouth_grid: Optional[Tuple[int, int, int]] = None
                       ) -> Dict[str, torch.Tensor]:
        """Full denoiser pass: {'eps_v', 'eps_a', 'h_v', 'h_a'} and, with
        mouth tokens, 'h_m' (their contextualized features, for the sync
        loss; they attend in the core but have no head output). A call
        that ``graphed.ineligible`` lets through replays a captured graph of
        this pass (``self.graphs``) and returns fresh tensors."""
        tensors = {"tok_v": tok_v, "tok_a": tok_a, "t_v": t_v, "t_a": t_a, "keep_v": keep_v,
                   "keep_a": keep_a, "tok_m": tok_m, "keep_m": keep_m}
        run = functools.partial(self._denoise_tokens, video_grid=video_grid,
                                mouth_grid=mouth_grid)
        if graphed.ineligible(self, tensors):
            return run(**tensors)
        statics = (tuple(video_grid), None if mouth_grid is None else tuple(mouth_grid))
        return self.graphs(self, run, tensors, statics)

    def _denoise_tokens(self, tok_v, tok_a, t_v, t_a, video_grid, keep_v, keep_a,
                        tok_m, keep_m, mouth_grid) -> Dict[str, torch.Tensor]:
        X, Nv = self.embed_tokens(tok_v, tok_a, t_v, t_a, video_grid, keep_v, keep_a,
                                  tok_m, keep_m, mouth_grid)
        Na = tok_a.shape[1]
        H = self.core(X)
        Hv, Ha = H[:, :Nv], H[:, Nv:Nv + Na]
        eps = self.head({"video": Hv, "audio": Ha})
        out = {"eps_v": eps["video"], "eps_a": eps["audio"], "h_v": Hv, "h_a": Ha}
        if tok_m is not None:
            out["h_m"] = H[:, Nv + Na:Nv + Na + tok_m.shape[1]]
        return out

    def denoise_latents(self, z_v: torch.Tensor, z_a: torch.Tensor,
                        t_v: torch.Tensor, t_a: torch.Tensor,
                        keep_v: Optional[torch.Tensor] = None,
                        keep_a: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Latent-space wrapper: tokenize -> denoise -> fold eps back."""
        out = self.denoise_tokens(self.tokenize_video(z_v), self.tokenize_audio(z_a),
                                  t_v, t_a, self.video_grid(z_v.shape), keep_v, keep_a)
        return {
            "eps_v": self.untokenize_video(out["eps_v"], z_v.shape),
            "eps_a": self.untokenize_audio(out["eps_a"], z_a.shape),
            "h_v": out["h_v"],
            "h_a": out["h_a"],
        }

    def forward(self, video: torch.Tensor, audio: torch.Tensor,
                t_v: torch.Tensor, t_a: torch.Tensor,
                noise_v: torch.Tensor, noise_a: torch.Tensor,
                alpha_bar_v: torch.Tensor, alpha_bar_a: torch.Tensor,
                keep_v: Optional[torch.Tensor] = None,
                keep_a: Optional[torch.Tensor] = None,
                keep_m: Optional[torch.Tensor] = None,
                with_recon: bool = False) -> Dict[str, torch.Tensor]:
        """End-to-end training forward: encode -> q_sample (with the pre-drawn
        latent noise) -> denoise. Returns the token-space predictions
        {'eps_v', 'eps_a'}, the contextualized features {'h_v', 'h_a'} and the
        token-space targets {'eps_true_v', 'eps_true_a'} under
        cfg.param_{v,a}. Dropout is active under ``train()``.

        With the mouth-crop stream enabled, its tokens are cut from the clean
        input pixels ('h_m' is returned too); ``keep_m`` (normally
        (1 - target_is_video) * keep) zeroes the stream whenever video is the
        target or its conditioning is CFG-dropped, and defaults to zeros.

        ``with_recon`` also decodes the clean latents back to pixels and
        waveform ('recon_v' at the input's size, 'recon_a'): the only
        gradient path into the decoders and, under cfg.encoder_stopgrad, into
        the encoders (the denoising path then sees detached latents, the
        decoders the live ones)."""
        # under encoder_stopgrad without the decode nothing differentiates
        # the encoders: they then run without a graph
        live = torch.is_grad_enabled() and (with_recon or not self.cfg.encoder_stopgrad)
        with torch.set_grad_enabled(live):
            z_v0 = self.encode_video(video)
            z_a0 = self.encode_audio(audio)
        z_v0_d, z_a0_d = z_v0, z_a0
        if self.cfg.encoder_stopgrad:
            z_v0_d, z_a0_d = z_v0.detach(), z_a0.detach()
        z_vt, eps_v = q_sample(z_v0_d, t_v, alpha_bar_v, noise_v)
        z_at, eps_a = q_sample(z_a0_d, t_a, alpha_bar_a, noise_a)
        tok_m = mgrid = None
        if self.cfg.mouth_enabled:
            tok_m = self.mouth_tokens(video)
            # the grid of the ACTUAL crop extent (the box clips to the frame)
            h0, h1, w0, w1 = self.cfg.mouth_box
            mt, mh, mw = self.cfg.mouth_tube
            ch = min(h1, video.shape[3]) - min(h0, video.shape[3])
            cw = min(w1, video.shape[4]) - min(w0, video.shape[4])
            mgrid = (video.shape[2] // mt, ch // mh, cw // mw)
            if keep_m is None:
                keep_m = torch.zeros(video.shape[0], device=video.device)
        out = self.denoise_tokens(self.tokenize_video(z_vt), self.tokenize_audio(z_at),
                                  t_v, t_a, self.video_grid(z_vt.shape), keep_v, keep_a,
                                  tok_m, keep_m, mgrid)
        out["eps_true_v"] = self.tokenize_video(
            prediction_target(z_v0_d, eps_v, t_v, alpha_bar_v, self.cfg.param_v))
        out["eps_true_a"] = self.tokenize_audio(
            prediction_target(z_a0_d, eps_a, t_a, alpha_bar_a, self.cfg.param_a))
        if with_recon:
            out["recon_v"] = self.decode_video(z_v0, out_size=tuple(video.shape[2:]))
            out["recon_a"] = self.decode_audio(z_a0)
        return out


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init with the JAX package's initializer families:
    xavier-uniform Dense kernels (lecun-normal for the VideoVAE's patch
    projections), lecun-normal 2-D and 3-D convs, the codec's kaiming-uniform
    (a=0.2) 1-D convs, N(0, 0.02) embedding and position tables, zero
    biases, unit norm scales. Draws come from ``generator``, so a seed fixes
    the weights (they are not the JAX package's draws). A tensor-parallel
    projection (``mmdit.HotDense`` under ``parallel.model``) draws its whole
    weight, as one process does, and keeps its part: the ranks' parts join
    into the one-process init, bit for bit."""
    def lecun_normal_(w: torch.Tensor) -> None:
        # flax lecun_normal: truncated at 2 std, std corrected for the cut
        std = math.sqrt(1.0 / w[0].numel()) / 0.87962566103423978
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)

    for name, mod in model.named_modules():
        if isinstance(mod, Dense):
            # a tensor-parallel part: draw the whole weight, keep the part
            split = getattr(mod, "split", None) is not None
            w = torch.empty(mod.whole_shape("weight")) if split else mod.weight
            if name.startswith("vid_vae."):
                lecun_normal_(w)
            else:
                nn.init.xavier_uniform_(w, generator=generator)
            if split:
                mod.weight.copy_(tp_part(f"{name}.weight", w, mod.weight.shape, mod.tp_n,
                                         mod.tp_i))
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, (Conv2d, Conv3d)):
            lecun_normal_(mod.weight)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, Conv1d):
            fan_in = mod.weight[0].numel()
            lim = math.sqrt(3.0 * (2.0 / (1.0 + 0.2 ** 2)) / fan_in)
            nn.init.uniform_(mod.weight, -lim, lim, generator=generator)
            nn.init.zeros_(mod.bias)
    for name, p in model.named_parameters():
        if name.endswith(("table", "embedding")) or name.split(".")[-1] == "pos":
            nn.init.normal_(p, 0.0, 0.02, generator=generator)
