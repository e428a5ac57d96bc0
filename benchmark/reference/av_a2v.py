"""Plain PyTorch reference of the audio-video model's audio-to-video
sampling, beside ``av_sampling.py`` (video-to-audio) and built from its
layers; it imports nothing of the program under test. Float32, TF32 off, as
there.

  wav [B, L] -> the codec encoder: GELU(conv9) twice, the mean of each
      hop-long window (zero-padded to Fa hop, hop = round(L / Fa), one more
      where that falls short), a 1x1 conv to Ca channels, per-sample RMS
      normalised when model.latent_rmsnorm -> z_a [B, Ca, Fa]
  the prompt's chunk tokens (kept on the conditional half, zeroed on the
      null half), the target video latent's tube tokens, and the mouth stream
      as zero tokens with keep 0 (no frames to crop)
  DDIM (eta 0) over round(linspace(T-1, -1, S+1)) of diffusion.video, CFG
      eps_null + g (eps_cond - eps_null) at sampling.guidance_scale.video,
      the video head's tokens back to the latent grid
  the video VAE decoder: a 1x1x1 conv, conv blocks (GELU then GroupNorm),
      and for the patch arch a Dense to t_down s_down^2 3 values per latent
      position unpatchified; sigmoid -> frames [B, 3, T, H, W] in [0, 1]
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .av_sampling import (Weights, alpha_bar, chunk_tokens, conv, ddim_schedule, ddim_update,
                          dense, denoise, gelu, group_norm, latent_norm, sizes, tube_tokens)


def encode_audio(W: Weights, s: Dict, wav: torch.Tensor) -> torch.Tensor:
    """wav [B, L] -> the clean audio latent [B, Ca, Fa]."""
    h = gelu(conv(W, "aud_codec.pre1", gelu(conv(W, "aud_codec.pre0", wav[:, None]))))
    B, C, L = h.shape
    Fa = s["Fa"]
    hop = max(1, round(L / Fa))
    hop += Fa * hop < L
    h = torch.nn.functional.pad(h, (0, max(Fa * hop - L, 0)))[..., :Fa * hop]
    h = h.reshape(B, C, Fa, hop).mean(dim=-1)
    return latent_norm(s, conv(W, "aud_codec.to_lat", h))


def tube_latent(tok: torch.Tensor, C: int, T: int, H: int, W_: int, t: int, h: int,
                w: int) -> torch.Tensor:
    """Inverse of ``tube_tokens``: [B, N, C t h w] -> [B, C, T, H, W]."""
    B = tok.shape[0]
    z = tok.reshape(B, T // t, H // h, W_ // w, C, t, h, w).permute(0, 4, 1, 5, 2, 6, 3, 7)
    return z.reshape(B, C, T, H, W_)


def decode_video(W: Weights, s: Dict, z: torch.Tensor, activation: str) -> torch.Tensor:
    """z [B, Cv, T', H', W'] -> frames [B, 3, T' td, H' sd, W' sd]."""
    h = conv(W, "vid_vae.from_lat", z)
    for i in range(s["dec_blocks"]):
        h = group_norm(W, f"vid_vae.dec.{i}.norm", gelu(conv(W, f"vid_vae.dec.{i}.conv", h)))
    if s["arch"] != "patch":
        raise ValueError("the a2v reference covers the patch video VAE")
    td, sd = s["td"], s["sd"]
    B, _, Tp, Hp, Wp = h.shape
    x = dense(W, "vid_vae.unpatch_proj", h.permute(0, 2, 3, 4, 1))
    x = x.reshape(B, Tp, Hp, Wp, td, sd, sd, 3).permute(0, 7, 1, 4, 2, 5, 3, 6)
    x = x.reshape(B, 3, Tp * td, Hp * sd, Wp * sd)
    return torch.sigmoid(x) if activation == "sigmoid" else torch.tanh(x)


class AudioPrompt:
    """What the sampler derives once from a batch of audio prompts: the
    audio tokens, the CFG keep masks, the zero mouth stream, the target's
    latent shape and the schedule."""

    def __init__(self, W: Weights, cfg: Dict, wav: torch.Tensor):
        s = self.s = sizes(cfg)
        dev = self.device = wav.device
        self.B = B = wav.shape[0]
        self.activation = str(cfg["video"].get("out_activation", "sigmoid"))
        tok_a = chunk_tokens(encode_audio(W, s, wav.float()), *s["chunk"])
        self.tok_a2 = torch.cat([tok_a, tok_a])
        self.keep_p = torch.cat([torch.ones(B, device=dev), torch.zeros(B, device=dev)])
        self.shape = (B, s["Cv"], s["T"] // s["td"], s["H"] // s["sd"], s["W"] // s["sd"])
        t, h, w = s["tube"]
        self.grid = (self.shape[2] // t, self.shape[3] // h, self.shape[4] // w)
        self.tok_m = self.mgrid = self.keep_m = None
        if s["mouth"]:
            h0, h1, w0, w1 = s["mouth_box"]
            mt, mh, mw = s["mouth_tube"]
            self.mgrid = (s["T"] // mt, (h1 - h0) // mh, (w1 - w0) // mw)
            n = self.mgrid[0] * self.mgrid[1] * self.mgrid[2]
            self.tok_m = torch.zeros(2 * B, n, 3 * mt * mh * mw, device=dev)
            self.keep_m = torch.zeros(2 * B, device=dev)
        dc = cfg["diffusion"]["video"]
        self.abar = alpha_bar(dc)
        self.sched = ddim_schedule(int(dc["steps"]), int(dc["sampler_steps"]))
        self.g = float(cfg["sampling"]["guidance_scale"].get("video", 3.0))
        self.param = str(dc.get("param", "eps"))


@torch.no_grad()
def guided(W: Weights, P: AudioPrompt, z: torch.Tensor, k: int) -> torch.Tensor:
    """The guided prediction tokens of the sampler's pass k (1 for the
    first) at the video latent z."""
    B, dev, s = P.B, P.device, P.s
    tok_v = tube_tokens(z.float(), *s["tube"])
    t_v = torch.full((2 * B,), int(P.sched[k - 1]), dtype=torch.long, device=dev)
    eps = denoise(W, s, "video", torch.cat([tok_v, tok_v]), P.tok_a2, t_v,
                  torch.zeros(2 * B, dtype=torch.long, device=dev), P.grid,
                  torch.ones(2 * B, device=dev), P.keep_p, P.tok_m, P.keep_m, P.mgrid)
    return eps[B:] + P.g * (eps[:B] - eps[B:])


@torch.no_grad()
def sample_a2v(W: Weights, P: AudioPrompt, z_init: torch.Tensor,
               passes=()) -> Tuple[torch.Tensor, torch.Tensor, Dict[int, Tuple]]:
    """Audio-to-video sampling from the initial video latent noise z_init ->
    (frames [B, 3, T, H, W] in [0, 1], the sampled latent, and for each pass
    k in `passes` the latent it read and its guided prediction tokens)."""
    s = P.s
    z = z_init.float().to(P.device)
    kept = {}
    for k, (t_now, t_prev) in enumerate(zip(P.sched[:-1], P.sched[1:]), start=1):
        eps = guided(W, P, z, k)
        if k in passes:
            kept[k] = (z, eps)
        pred = tube_latent(eps, s["Cv"], *z.shape[2:], *s["tube"])
        a_t = float(P.abar[max(int(t_now), 0)])
        a_prev = 1.0 if t_prev < 0 else float(P.abar[int(t_prev)])
        z = ddim_update(z, pred, a_t, a_prev, P.param)
    return decode_video(W, s, z, P.activation), z, kept
