"""Diffusion schedule math, always fp32.

Counterpart of the JAX package's ``ops/schedule.py``: schedule construction
is host-side numpy (static per config), the per-step math is torch on the
caller's device.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch


def make_beta_schedule(
    steps: int,
    kind: str = "cosine",
    min_beta: float = 1e-4,
    max_beta: float = 2e-2,
) -> np.ndarray:
    """Return betas[t], t = 0..steps-1, as fp32 numpy.

    kinds: "cosine" (Nichol-Dhariwal, s=0.008), "linear", "sigmoid".
    """
    kind = kind.lower()
    if kind == "linear":
        betas = np.linspace(min_beta, max_beta, steps, dtype=np.float32)
    elif kind == "sigmoid":
        xs = np.linspace(-6.0, 6.0, steps, dtype=np.float32)
        sig = 1.0 / (1.0 + np.exp(-xs))
        betas = (min_beta + (max_beta - min_beta) * sig).astype(np.float32)
    elif kind == "cosine":
        s = 0.008
        t = np.linspace(0.0, steps, steps + 1, dtype=np.float32)
        f = np.cos(((t / steps + s) / (1.0 + s)) * math.pi / 2.0) ** 2
        a_bar = f / f[0]
        betas = (1.0 - a_bar[1:] / a_bar[:-1]).astype(np.float32)
    else:
        raise ValueError(f"Unknown schedule kind: {kind}")
    return np.clip(betas, 1e-8, 0.999).astype(np.float32)


def alphas_cumprod_from_betas(betas: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Return (alphas[t], alpha_bar[t] = cumprod alphas)."""
    betas = np.asarray(betas, dtype=np.float32)
    alphas = 1.0 - betas
    return alphas, np.cumprod(alphas, axis=0).astype(np.float32)


def make_sampling_schedule(T_train: int, T_sample: int) -> np.ndarray:
    """Decreasing int schedule of length T_sample+1 from T_train-1 down to -1."""
    grid = np.linspace(T_train - 1, -1, T_sample + 1)
    return np.round(grid).astype(np.int32)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10_000) -> torch.Tensor:
    """Sinusoidal timestep embedding, [B] -> [B, dim], fp32, halves ordered
    [cos | sin]. Odd dims are right-padded with one zero."""
    t = t.to(torch.float32)
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=1)
    if dim % 2 == 1:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb


def _bcast_gather(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """table[t] with trailing singleton dims so it broadcasts to an ndim array."""
    v = table.to(torch.float32)[t.long()]
    return v.reshape(v.shape + (1,) * (ndim - v.ndim))


def q_sample(x0: torch.Tensor, t: torch.Tensor, alpha_bar: torch.Tensor,
             eps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_t = sqrt(a_bar_t) x0 + sqrt(1 - a_bar_t) eps; returns (x_t, eps).

    The noise is passed in (drawn by the caller from its generator). The
    math runs in fp32 and both results are cast back to x0.dtype, so bf16
    latents still see fp32-accurate schedule coefficients."""
    a_bar_t = _bcast_gather(alpha_bar, t, x0.ndim)
    x_t = (torch.sqrt(a_bar_t) * x0.to(torch.float32)
           + torch.sqrt(torch.clamp(1.0 - a_bar_t, min=0.0)) * eps.to(torch.float32))
    return x_t.to(x0.dtype), eps.to(x0.dtype)


def prediction_target(x0: torch.Tensor, eps: torch.Tensor, t: torch.Tensor,
                      alpha_bar: torch.Tensor, param: str = "eps") -> torch.Tensor:
    """The regression target for a model predicting under `param`:
    "eps" -> eps, "x0" -> x0, "v" -> sqrt(a_bar) eps - sqrt(1-a_bar) x0.
    Computed in fp32, returned in x0.dtype."""
    if param == "eps":
        return eps
    if param == "x0":
        return x0
    if param == "v":
        a_bar_t = _bcast_gather(alpha_bar, t, x0.ndim)
        v = (torch.sqrt(a_bar_t) * eps.to(torch.float32)
             - torch.sqrt(torch.clamp(1.0 - a_bar_t, min=0.0)) * x0.to(torch.float32))
        return v.to(x0.dtype)
    raise ValueError(f"param must be 'eps'|'x0'|'v', got {param!r}")


def to_x0_pred(x_t: torch.Tensor, pred: torch.Tensor, a_t: torch.Tensor,
               param: str = "eps") -> torch.Tensor:
    """Model prediction under `param` ('eps'|'x0'|'v') -> denoised estimate x0."""
    sqrt_a = torch.sqrt(a_t)
    sqrt_omb = torch.sqrt(torch.clamp(1.0 - a_t, min=0.0))
    if param == "eps":
        return (x_t - sqrt_omb * pred) / torch.clamp(sqrt_a, min=1e-8)
    if param == "x0":
        return pred
    if param == "v":
        return sqrt_a * x_t - sqrt_omb * pred
    raise ValueError(f"param must be 'eps'|'x0'|'v', got {param!r}")


def ddim_step(
    x_t: torch.Tensor,
    t_now: torch.Tensor,
    t_prev: torch.Tensor,
    eps_hat: torch.Tensor,
    alpha_bar: torch.Tensor,
    eta: float = 0.0,
    noise: Optional[torch.Tensor] = None,
    *,
    generator: Optional[torch.Generator] = None,
    clip_x0: Optional[Tuple[float, float]] = None,
    param: str = "eps",
) -> torch.Tensor:
    """One DDIM update x_{t_prev} <- x_t (x0-prediction form).

      x0_pred = (x_t - sqrt(1-a_t) eps) / sqrt(a_t)
      sigma   = eta * sqrt((1-a_prev)/(1-a_t) * (1 - a_t/a_prev))
      x_prev  = sqrt(a_prev) x0_pred + sqrt(1 - a_prev - sigma^2) eps + sigma z

    a_bar(-1) := 1 for the final step (t_prev == -1). With eta > 0 the noise
    z is `noise`, or drawn from `generator`.
    """
    xdtype = x_t.dtype
    x_t = x_t.to(torch.float32)
    eps_hat = eps_hat.to(torch.float32)
    nd = x_t.ndim

    a_t = _bcast_gather(alpha_bar, torch.clamp(t_now, min=0), nd)
    a_prev_raw = _bcast_gather(alpha_bar, torch.clamp(t_prev, min=0), nd)
    is_final = (t_prev < 0).reshape((-1,) + (1,) * (nd - 1))
    a_prev = torch.where(is_final, torch.ones_like(a_prev_raw), a_prev_raw)

    sqrt_a_t = torch.sqrt(a_t)
    sqrt_omb_t = torch.sqrt(torch.clamp(1.0 - a_t, min=0.0))
    sqrt_a_prev = torch.sqrt(a_prev)

    x0_pred = to_x0_pred(x_t, eps_hat, a_t, param=param)
    if param == "x0":
        eps_hat = (x_t - sqrt_a_t * x0_pred) / torch.clamp(sqrt_omb_t, min=1e-4)
    elif param == "v":
        eps_hat = sqrt_omb_t * x_t + sqrt_a_t * eps_hat
    if clip_x0 is not None:
        x0_pred = torch.clamp(x0_pred, clip_x0[0], clip_x0[1])

    if eta > 0.0:
        frac = torch.clamp((1.0 - a_prev) / torch.clamp(1.0 - a_t, min=1e-8), min=0.0)
        one_minus_ratio = torch.clamp(1.0 - a_t / torch.clamp(a_prev, min=1e-8), min=0.0)
        sigma = eta * torch.sqrt(frac * one_minus_ratio)
        if noise is None:
            if generator is None:
                raise ValueError("ddim_step with eta>0 needs `noise` or `generator`")
            noise = torch.randn(x_t.shape, generator=generator,
                                device=x_t.device, dtype=torch.float32)
        stoch = sigma * noise.to(torch.float32)
        coeff_eps = torch.sqrt(torch.clamp(1.0 - a_prev - sigma ** 2, min=0.0))
    else:
        stoch = 0.0
        coeff_eps = torch.sqrt(torch.clamp(1.0 - a_prev, min=0.0))

    x_prev = sqrt_a_prev * x0_pred + coeff_eps * eps_hat + stoch
    return x_prev.to(xdtype)
