"""Text -> audio mel-spectrogram diffusion + Griffin-Lim decode (counterpart
of the JAX ``models/text2audio_mel.py``).

The normalized mel spectrogram [1, n_mels, frames] is a 1-channel image
latent: patch tokens over the MMDiT core with the text tokens concatenated
in-sequence, batched CFG as the text->image family, and the host-side
Griffin-Lim vocoder (``media/audio_io.py``) at the end.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from ..media.audio_io import griffin_lim, mel_to_stft_mag
from ..ops import schedule as S
from .adapters import LinearAdapter, PositionalEmbedding1D
from .heads import NoisePredictionHead
from .image_diffusion import patch_image, unpatch_image
from .latent_text2image import (alpha_bar, cfg_sample_loop, encode_prompts, initial_noise,
                                sampling_pairs, text_conditioned_tokens)
from .mmdit import MMDiT, MMDiTConfig
from .text_encoder import PAD_ID, TextEncoder, TextEncoderConfig


@dataclasses.dataclass(frozen=True)
class Text2AudioConfig:
    n_mels: int = 80
    frames: int = 256  # mel time frames per sample
    patch_f: int = 8  # mel-axis patch
    patch_t: int = 8  # time-axis patch
    width: int = 384
    sr: int = 16000
    n_fft: int = 1024
    hop: int = 256
    text: TextEncoderConfig = dataclasses.field(default_factory=TextEncoderConfig)
    core: MMDiTConfig = dataclasses.field(
        default_factory=lambda: MMDiTConfig(d_model=384, n_layers=6, n_heads=6, dropout=0.0))
    steps: int = 1000
    schedule: str = "cosine"
    min_beta: float = 1e-4
    max_beta: float = 2e-2
    # mel normalization: z = (logmel - mean) / std before diffusion
    mel_mean: float = -5.0
    mel_std: float = 4.0
    dtype: Any = torch.float32

    @property
    def n_tokens(self) -> int:
        return (self.n_mels // self.patch_f) * (self.frames // self.patch_t)

    @property
    def token_dim(self) -> int:
        return self.patch_f * self.patch_t


class Text2AudioModel(nn.Module):
    def __init__(self, cfg: Text2AudioConfig):
        super().__init__()
        self.cfg = c = cfg
        self.text_encoder = TextEncoder(c.text)
        self.text_proj = LinearAdapter(c.text.width, c.width, c.dtype)
        self.mel_adapter = LinearAdapter(c.patch_f * c.patch_f, c.width, c.dtype)
        self.pos = PositionalEmbedding1D(c.width, max_len=c.n_tokens, mode="learned",
                                         dtype=c.dtype)
        self.core = MMDiT(c.core)
        self.head = NoisePredictionHead(c.core.d_model, c.token_dim, hidden_dim=c.width,
                                        num_layers=2, dtype=c.dtype)

    def encode_text(self, ids: torch.Tensor):
        return self.text_encoder(ids)

    def denoise(self, m_t: torch.Tensor, t: torch.Tensor, text_tokens: torch.Tensor,
                text_pad: Optional[torch.Tensor] = None,
                keep_text: Optional[torch.Tensor] = None) -> torch.Tensor:
        """m_t: [B, 1, n_mels, frames] noisy normalized mel -> eps_hat. The
        patch is patch_f square over (mels, time), as the JAX model (which
        sizes its position table and head by patch_t)."""
        c = self.cfg
        x, mask, n_txt = text_conditioned_tokens(
            self.mel_adapter, self.text_proj, self.pos, patch_image(m_t, c.patch_f), t,
            text_tokens, text_pad, keep_text, c.width)
        out = self.core(x, mask)
        eps_tok = self.head(out[:, n_txt:])
        return unpatch_image(eps_tok, 1, c.n_mels, c.frames, c.patch_f)

    def forward(self, mels: torch.Tensor, ids: torch.Tensor, t: torch.Tensor,
                noise: torch.Tensor, alpha_bar: torch.Tensor,
                keep_text: Optional[torch.Tensor] = None):
        """Training forward on normalized mels [B, 1, M, F]: (eps_hat, eps)."""
        m_t, eps = S.q_sample(mels, t, alpha_bar, noise)
        text_tokens, _ = self.encode_text(ids)
        eps_hat = self.denoise(m_t, t, text_tokens, ids == PAD_ID, keep_text)
        return eps_hat, eps


def make_t2a_sampler(model: Text2AudioModel, sampler_steps: int = 50,
                     guidance_scale: float = 3.0, eta: float = 0.0):
    """sample(ids, neg_ids, generator=None, m_init=None, step_noise=None) ->
    normalized mel [B, 1, M, F] fp32: DDIM with batched CFG, as
    ``make_t2i_sampler`` (the initial mel `m_init` or drawn from
    `generator`)."""
    c = model.cfg
    abar_np = alpha_bar(c)
    pairs = sampling_pairs(c.steps, sampler_steps)
    g = float(guidance_scale)

    def sample(ids, neg_ids, generator: Optional[torch.Generator] = None,
               m_init: Optional[torch.Tensor] = None,
               step_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        dev = next(model.parameters()).device
        with torch.inference_mode():
            text2, pad2 = encode_prompts(model, ids, neg_ids)
        m = initial_noise((text2.shape[0] // 2, 1, c.n_mels, c.frames), dev, m_init, generator)
        return cfg_sample_loop(model, text2, pad2, m, pairs, g,
                               torch.as_tensor(abar_np, device=dev), "ddim", eta,
                               generator, step_noise)

    return sample


def mel_to_waveform(model_cfg: Text2AudioConfig, mel_norm: np.ndarray,
                    n_iter: int = 32) -> np.ndarray:
    """Normalized mel [1, M, F] (or [M, F]) -> waveform via Griffin-Lim."""
    c = model_cfg
    mel = np.asarray(mel_norm)
    if mel.ndim == 3:
        mel = mel[0]
    log_mel = mel * c.mel_std + c.mel_mean  # de-normalize
    # clamp to a physical dynamic range before exp: diffusion outputs are
    # unbounded and exp() of a wild sample would overflow the vocoder
    mel_power = np.exp(np.clip(log_mel, -12.0, 8.0))
    mag = mel_to_stft_mag(mel_power, c.sr, c.n_fft, c.n_mels)
    return griffin_lim(mag, n_fft=c.n_fft, hop=c.hop, n_iter=n_iter)
