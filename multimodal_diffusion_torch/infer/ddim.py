"""DDIM / DPM-Solver++(2M) sampling with batched classifier-free guidance
and optional sync guidance (counterpart of the JAX ``infer/ddim.py``).

The prompt latent is clean (embedded at t=0) and frozen; only the target
latent evolves. CFG is one batched forward per step: cond and null are
stacked on the batch axis (2B), null = the prompt's embedded tokens zeroed;
eps_hat = eps_null + g * (eps_cond - eps_null). The prompt's raw tokens (and
the mouth-crop tokens, when the stream is enabled) are computed once, outside
the step loop. The JAX package's ``lax.scan`` is a Python loop here; each
step runs in the span ``ddim.step`` and its CFG denoiser call in
``ddim.denoiser`` (``utils/profiling.py::span``).

Sync guidance (v2a only) adds to eps_hat, at each step, the gradient with
respect to the audio latent of the model's own temporal InfoNCE between the
conditioning video (or mouth) features and the noisy-audio features: a third,
B-sized forward and its backward through the attention kernels. Only that
gradient is taken; no parameter receives a ``.grad``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.diffusion import AVDiffusionModel
from ..ops import schedule as S
from ..train.losses import sync_contrastive_loss
from ..utils.profiling import span


def make_ddim_sampler(
    *,
    target: str,  # "audio" (v2a) or "video" (a2v)
    sched: np.ndarray,  # [S+1] ints from make_sampling_schedule
    alpha_bar: np.ndarray,  # [T] for the TARGET modality
    guidance_scale: float,
    eta: float = 0.0,
    param: str = "eps",
    sampler: str = "ddim",
    cfg_rescale: float = 0.0,
    sync_guidance_scale: float = 0.0,
    sync_guidance_source: str = "auto",  # auto|mouth|video
    sync_tau: float = 0.1,
    sync_guidance_norm: str = "rms",  # rms|raw
    sync_guidance_min_abar: float = 0.0,
) -> Callable:
    """Returns sample(model, z_prompt, z_init, generator=None, tok_mouth=None)
    -> the final target latent (fp32, z_init's shape).

    The module carries its weights, so ``model`` stands where the JAX
    sampler takes ``params`` (and the JAX ``model`` argument of
    make_ddim_sampler has no counterpart). z_prompt: clean prompt
    latent (video latent if target == "audio", else audio latent); z_init:
    N(0, I) target latent. ``generator`` draws the eta > 0 noise.

    ``tok_mouth`` (v2a with the mouth-crop stream enabled): the raw tokens
    ``model.mouth_tokens(frames)``, zeroed on the null half like the prompt.
    Without them (a2v, or v2a without frames) zero tokens with keep 0 stand
    in, so the sequence has the layout of training's dropped-mouth state.

    ``sampler``: "ddim", or "dpmpp_2m" (2nd-order multistep ODE solver;
    deterministic, so eta must be 0).

    ``sync_guidance_scale`` > 0 (v2a only): eps_hat += k * scale *
    sqrt(1 - abar_t) * g, with g the gradient of the sync InfoNCE w.r.t. the
    audio latent, per-sample RMS-normalised (``sync_guidance_norm: rms``) or
    as it is (``raw``), and k converting an eps increment to ``param``'s
    space (x0: -sqrt(1-abar)/sqrt(abar); v: 1/sqrt(abar)).
    ``sync_guidance_source`` picks the feature stream: "mouth" (needs the
    stream and tok_mouth), "video" (the main latent grid) or "auto" (mouth
    when available). ``sync_guidance_min_abar`` gates the term to steps with
    abar_t at or above it.
    """
    if target not in {"audio", "video"}:
        raise ValueError("target must be 'audio' or 'video'")
    if sampler not in {"ddim", "dpmpp_2m"}:
        raise ValueError(f"sampler must be ddim|dpmpp_2m, got {sampler!r}")
    if sampler == "dpmpp_2m" and eta > 0.0:
        raise ValueError("dpmpp_2m is a deterministic ODE solver; sampling.ddim_eta must be 0")
    sync_g = float(sync_guidance_scale)
    if sync_g > 0.0 and target != "audio":
        raise ValueError("sync_guidance_scale is a v2a (audio-target) lever; build the "
                         "a2v sampler with 0")
    if sync_g > 0.0 and param not in {"eps", "x0", "v"}:
        raise ValueError(f"sync guidance: unknown param {param!r}")
    if sync_guidance_source not in {"auto", "mouth", "video"}:
        raise ValueError(f"sync_guidance_source must be auto|mouth|video, "
                         f"got {sync_guidance_source!r}")
    if sync_guidance_norm not in {"rms", "raw"}:
        raise ValueError(f"sync_guidance_norm must be rms|raw, got {sync_guidance_norm!r}")
    pairs = [(int(a), int(b)) for a, b in zip(sched[:-1], sched[1:])]
    abar_np = np.asarray(alpha_bar, np.float32)
    g = float(guidance_scale)
    phi = float(cfg_rescale)

    def sync_increment(a_t: float) -> float:
        """The factor of the (normalised) sync gradient in the prediction at
        a step with alpha_bar a_t: k * scale * sqrt(1 - a_t)."""
        if sync_guidance_min_abar > 0.0 and a_t < sync_guidance_min_abar:
            return 0.0
        coef = max(1.0 - a_t, 0.0) ** 0.5
        k = {"eps": 1.0, "x0": -coef / max(a_t, 1e-12) ** 0.5,
             "v": 1.0 / max(a_t, 1e-12) ** 0.5}[param]
        return k * sync_g * coef

    @torch.inference_mode()
    def sample(model: AVDiffusionModel, z_prompt: torch.Tensor, z_init: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               tok_mouth: Optional[torch.Tensor] = None) -> torch.Tensor:
        dev = z_init.device
        B = z_init.shape[0]
        abar = torch.as_tensor(abar_np, device=dev)
        mc = model.cfg

        if target == "audio":
            tok_prompt = model.tokenize_video(z_prompt)
            grid = model.video_grid(z_prompt.shape)
            T_frames = z_prompt.shape[2] * mc.vae.t_down
        else:
            tok_prompt = model.tokenize_audio(z_prompt)
            grid = model.video_grid(z_init.shape)
            T_frames = z_init.shape[2] * mc.vae.t_down
        tok_prompt2 = torch.cat([tok_prompt, tok_prompt], dim=0)

        # CFG keep-masks: first half = cond (keep prompt), second = null
        keep_prompt = torch.cat([torch.ones(B, device=dev), torch.zeros(B, device=dev)])
        keep_target = torch.ones(2 * B, device=dev)
        t_zero = torch.zeros(2 * B, dtype=torch.long, device=dev)

        mouth_kw = {}
        have_mouth = mc.mouth_enabled and tok_mouth is not None
        mgrid = None
        if mc.mouth_enabled:
            mgrid = model.mouth_grid(T_frames)
            if tok_mouth is None:
                # zero tokens = the trained dropped-mouth state
                tok_mouth = torch.zeros((B, mgrid[0] * mgrid[1] * mgrid[2], mc.token_dim_mouth),
                                        device=dev)
                keep_m2 = torch.zeros(2 * B, device=dev)
            else:
                keep_m2 = keep_prompt
            mouth_kw = {"tok_m": torch.cat([tok_mouth, tok_mouth], dim=0), "keep_m": keep_m2,
                        "mouth_grid": mgrid}

        sync_src = sync_guidance_source
        if sync_src == "auto":
            sync_src = "mouth" if have_mouth else "video"
        if sync_g > 0.0 and sync_src == "mouth" and not have_mouth:
            raise ValueError("sync_guidance_source: mouth needs conditioning.mouth_crop "
                             "enabled AND frames (tok_mouth) at the call site")

        if sync_g > 0.0:
            # The guided forward is differentiated, and tensors made under
            # inference_mode cannot enter autograd: take ordinary copies of
            # what it reads, once.
            with torch.inference_mode(False):
                g_prompt = tok_prompt.clone()
                onesB = torch.ones(B, device=dev)
                tzB = torch.zeros(B, dtype=torch.long, device=dev)
                kw1 = {}
                if mc.mouth_enabled:
                    kw1 = {"tok_m": tok_mouth.clone(),
                           "keep_m": onesB if have_mouth else torch.zeros(B, device=dev),
                           "mouth_grid": mgrid}

            def sync_grad(z: torch.Tensor, t_now: int) -> torch.Tensor:
                """d InfoNCE / d z of one B-sized forward at (t=0 video, t_now
                audio), everything kept: autograd.grad w.r.t. z only."""
                with torch.inference_mode(False), torch.enable_grad():
                    z_x = z.clone().requires_grad_(True)
                    t_tgtB = torch.full((B,), t_now, dtype=torch.long, device=dev)
                    out1 = model.denoise_tokens(g_prompt, model.tokenize_audio(z_x), tzB,
                                                t_tgtB, grid, onesB, onesB, **kw1)
                    if sync_src == "mouth":
                        h_sync, chunks = out1["h_m"], mgrid[0]
                    else:
                        h_sync, chunks = out1["h_v"], grid[0]
                    loss = sync_contrastive_loss(h_sync, out1["h_a"], chunks, weight=1.0,
                                                 tau=sync_tau)
                    (grad,) = torch.autograd.grad(loss, z_x)
                return grad

        z = z_init.to(torch.float32)
        # dpmpp_2m's multistep state; h_prev <= 0 says "no previous step"
        x0_prev = torch.zeros_like(z)
        h_prev = torch.zeros((B,) + (1,) * (z.ndim - 1), device=dev)
        for t_now, t_prev in pairs:
            with span("ddim.step"):
                t_tgt = torch.full((2 * B,), t_now, dtype=torch.long, device=dev)
                if target == "audio":
                    tok_tgt = model.tokenize_audio(z)
                    with span("ddim.denoiser"):
                        out = model.denoise_tokens(tok_prompt2, torch.cat([tok_tgt, tok_tgt]),
                                                   t_zero, t_tgt, grid, keep_prompt,
                                                   keep_target, **mouth_kw)
                    eps_tok = out["eps_a"]
                else:
                    tok_tgt = model.tokenize_video(z)
                    with span("ddim.denoiser"):
                        out = model.denoise_tokens(torch.cat([tok_tgt, tok_tgt]), tok_prompt2,
                                                   t_tgt, t_zero, grid, keep_target,
                                                   keep_prompt, **mouth_kw)
                    eps_tok = out["eps_v"]

                eps_cond, eps_null = eps_tok[:B], eps_tok[B:]
                eps_hat_tok = eps_null + g * (eps_cond - eps_null)
                if phi > 0.0:
                    # CFG rescale (Lin et al. 2023) toward eps_cond's std, blend by phi
                    ax = tuple(range(1, eps_hat_tok.ndim))
                    s_cond = torch.std(eps_cond, dim=ax, keepdim=True, correction=0)
                    s_hat = torch.std(eps_hat_tok, dim=ax, keepdim=True, correction=0)
                    rescaled = eps_hat_tok * (s_cond / torch.clamp(s_hat, min=1e-12))
                    eps_hat_tok = phi * rescaled + (1.0 - phi) * eps_hat_tok

                if target == "audio":
                    eps_lat = model.untokenize_audio(eps_hat_tok, z.shape)
                else:
                    eps_lat = model.untokenize_video(eps_hat_tok, z.shape)

                if sync_g > 0.0:
                    # classifier guidance on the model's own sync pathway:
                    # eps' = eps + sqrt(1 - abar_t) * grad_z InfoNCE(z)
                    grad_sync = sync_grad(z, t_now).to(torch.float32)
                    if sync_guidance_norm == "rms":
                        ax = tuple(range(1, z.ndim))
                        rms = torch.sqrt(torch.mean(torch.square(grad_sync), dim=ax, keepdim=True)
                                         + 1e-12)
                        grad_sync = grad_sync / rms
                    eps_lat = eps_lat + sync_increment(float(abar_np[t_now])) * grad_sync

                tb = torch.full((B,), t_now, dtype=torch.long, device=dev)
                pb = torch.full((B,), t_prev, dtype=torch.long, device=dev)
                if sampler == "dpmpp_2m":
                    z, x0_prev, h_prev = S.dpmpp_2m_step(z, tb, pb, eps_lat, abar, x0_prev, h_prev,
                                                         param=param)
                else:
                    z = S.ddim_step(z, tb, pb, eps_lat, abar, eta=eta, generator=generator,
                                    param=param)
        return z

    return sample


def sampler_from_config(cfg: Dict, target: str) -> Tuple[Callable, np.ndarray]:
    """Build the sampler for one direction from the merged YAML tree (keys:
    diffusion.{video,audio}.{steps,sampler_steps,schedule,min_beta,max_beta,
    param}, sampling.{ddim_eta,guidance_scale,cfg_rescale,sampler,
    sync_guidance_scale,sync_guidance_source,sync_tau,sync_guidance_norm,
    sync_guidance_min_abar}). Sync guidance is an audio-target lever: a shared
    config builds the a2v direction without it."""
    dc = cfg["diffusion"][target]
    T_train = int(dc["steps"])
    betas = S.make_beta_schedule(T_train, dc["schedule"], float(dc["min_beta"]),
                                 float(dc["max_beta"]))
    _, abar = S.alphas_cumprod_from_betas(betas)
    sched = S.make_sampling_schedule(T_train, int(dc["sampler_steps"]))
    samp = cfg["sampling"]
    sample = make_ddim_sampler(
        target=target, sched=sched, alpha_bar=abar,
        guidance_scale=float(samp["guidance_scale"].get(target, 3.0)),
        eta=float(samp.get("ddim_eta", 0.0)), param=str(dc.get("param", "eps")),
        sampler=str(samp.get("sampler", "ddim")),
        cfg_rescale=float(samp.get("cfg_rescale", 0.0)),
        sync_guidance_scale=(float(samp.get("sync_guidance_scale", 0.0))
                             if target == "audio" else 0.0),
        sync_guidance_source=str(samp.get("sync_guidance_source", "auto")),
        sync_tau=float(samp.get("sync_tau", 0.1)),
        sync_guidance_norm=str(samp.get("sync_guidance_norm", "rms")),
        sync_guidance_min_abar=float(samp.get("sync_guidance_min_abar", 0.0)))
    return sample, sched
