"""DDIM sampling with batched classifier-free guidance (counterpart of the JAX
``infer/ddim.py``).

The prompt latent is clean (embedded at t=0) and frozen; only the target
latent evolves. CFG is one batched forward per step: cond and null are
stacked on the batch axis (2B), null = the prompt's embedded tokens zeroed;
eps_hat = eps_null + g * (eps_cond - eps_null). The prompt's raw tokens are
computed once, outside the step loop. The JAX package's ``lax.scan`` is a
Python loop here.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.diffusion import AVDiffusionModel
from ..ops import schedule as S


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
) -> Callable:
    """Returns sample(model, z_prompt, z_init, generator=None) -> the final
    target latent (fp32, z_init's shape).

    The module carries its weights, so ``model`` stands where the JAX
    sampler takes ``params`` (and the JAX ``model`` argument of
    make_ddim_sampler has no counterpart). z_prompt: clean prompt
    latent (video latent if target == "audio", else audio latent); z_init:
    N(0, I) target latent. ``generator`` draws the eta > 0 noise.
    """
    if target not in {"audio", "video"}:
        raise ValueError("target must be 'audio' or 'video'")
    if sampler != "ddim":
        raise NotImplementedError(f"sampler {sampler!r} is not ported yet (only ddim)")
    pairs = [(int(a), int(b)) for a, b in zip(sched[:-1], sched[1:])]
    abar_np = np.asarray(alpha_bar, np.float32)
    g = float(guidance_scale)
    phi = float(cfg_rescale)

    @torch.inference_mode()
    def sample(model: AVDiffusionModel, z_prompt: torch.Tensor, z_init: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dev = z_init.device
        B = z_init.shape[0]
        abar = torch.as_tensor(abar_np, device=dev)

        if target == "audio":
            tok_prompt = model.tokenize_video(z_prompt)
            grid = model.video_grid(z_prompt.shape)
        else:
            tok_prompt = model.tokenize_audio(z_prompt)
            grid = model.video_grid(z_init.shape)
        tok_prompt2 = torch.cat([tok_prompt, tok_prompt], dim=0)

        # CFG keep-masks: first half = cond (keep prompt), second = null
        keep_prompt = torch.cat([torch.ones(B, device=dev), torch.zeros(B, device=dev)])
        keep_target = torch.ones(2 * B, device=dev)
        t_zero = torch.zeros(2 * B, dtype=torch.long, device=dev)

        z = z_init.to(torch.float32)
        for t_now, t_prev in pairs:
            t_tgt = torch.full((2 * B,), t_now, dtype=torch.long, device=dev)
            if target == "audio":
                tok_tgt = model.tokenize_audio(z)
                out = model.denoise_tokens(tok_prompt2, torch.cat([tok_tgt, tok_tgt]),
                                           t_zero, t_tgt, grid, keep_prompt, keep_target)
                eps_tok = out["eps_a"]
            else:
                tok_tgt = model.tokenize_video(z)
                out = model.denoise_tokens(torch.cat([tok_tgt, tok_tgt]), tok_prompt2,
                                           t_tgt, t_zero, grid, keep_target, keep_prompt)
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

            tb = torch.full((B,), t_now, dtype=torch.long, device=dev)
            pb = torch.full((B,), t_prev, dtype=torch.long, device=dev)
            z = S.ddim_step(z, tb, pb, eps_lat, abar, eta=eta, generator=generator,
                            param=param)
        return z

    return sample


def sampler_from_config(cfg: Dict, target: str) -> Tuple[Callable, np.ndarray]:
    """Build the sampler for one direction from the merged YAML tree (keys:
    diffusion.{video,audio}.{steps,sampler_steps,schedule,min_beta,max_beta},
    sampling.{ddim_eta,guidance_scale,cfg_rescale,sampler})."""
    dc = cfg["diffusion"][target]
    T_train = int(dc["steps"])
    betas = S.make_beta_schedule(T_train, dc["schedule"], float(dc["min_beta"]),
                                 float(dc["max_beta"]))
    _, abar = S.alphas_cumprod_from_betas(betas)
    sched = S.make_sampling_schedule(T_train, int(dc["sampler_steps"]))
    samp = cfg["sampling"]
    if float(samp.get("sync_guidance_scale", 0.0)) > 0.0 and target == "audio":
        raise NotImplementedError("sync guidance is not ported yet")
    sample = make_ddim_sampler(
        target=target, sched=sched, alpha_bar=abar,
        guidance_scale=float(samp["guidance_scale"].get(target, 3.0)),
        eta=float(samp.get("ddim_eta", 0.0)), param=str(dc.get("param", "eps")),
        sampler=str(samp.get("sampler", "ddim")),
        cfg_rescale=float(samp.get("cfg_rescale", 0.0)))
    return sample, sched
