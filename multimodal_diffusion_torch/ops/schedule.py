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

    kinds: "cosine" (Nichol-Dhariwal, s=0.008), "linear", "sigmoid",
    "scaled_linear" (Stable Diffusion's: linspace(sqrt(min_beta),
    sqrt(max_beta), steps)^2, taken in float64).
    """
    kind = kind.lower()
    if kind == "scaled_linear":
        betas = (np.linspace(math.sqrt(min_beta), math.sqrt(max_beta), steps,
                             dtype=np.float64) ** 2).astype(np.float32)
    elif kind == "linear":
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


def rescale_zero_terminal_snr(alpha_bar: np.ndarray) -> np.ndarray:
    """alpha_bar rescaled so the last step has zero SNR (Lin et al. 2024,
    "Common Diffusion Noise Schedules and Sample Steps are Flawed",
    Algorithm 1): sqrt(alpha_bar) shifted so its last value is 0 and scaled
    so its first is unchanged, then squared. Taken in float64; returns
    float32 with alpha_bar[-1] exactly 0."""
    s = np.sqrt(np.asarray(alpha_bar, dtype=np.float64))
    s0, sT = s[0], s[-1]
    s = (s - sT) * (s0 / (s0 - sT))
    return (s ** 2).astype(np.float32)


def make_sampling_schedule(T_train: int, T_sample: int,
                           spacing: str = "linspace") -> np.ndarray:
    """Decreasing int schedule of length T_sample+1 from the first step down
    to -1. "linspace": round(linspace(T_train-1, -1, T_sample+1)).
    "trailing" (Lin et al. 2024, section 3.3): round(arange(T_train, 0,
    -T_train / T_sample)) - 1 then -1, so the first step is T_train-1 (999,
    979, ..., 19, -1 for 1000 and 50)."""
    if spacing == "trailing":
        ts = np.round(np.arange(T_train, 0, -T_train / T_sample)).astype(np.int64) - 1
        return np.concatenate([ts, [-1]]).astype(np.int32)
    if spacing != "linspace":
        raise ValueError(f"spacing must be 'linspace' or 'trailing', got {spacing!r}")
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


def ddpm_step(
    x_t: torch.Tensor,
    t: torch.Tensor,
    eps_hat: torch.Tensor,
    betas: torch.Tensor,
    alpha_bar: torch.Tensor,
    noise: torch.Tensor,
    *,
    posterior_variance: bool = True,
    clip_x0: Optional[Tuple[float, float]] = None,
) -> torch.Tensor:
    """One ancestral DDPM step x_{t-1} <- x_t (Ho et al. 2020, eq. 11):

      mu = (x_t - beta_t / sqrt(1 - a_bar_t) * eps_hat) / sqrt(alpha_t)
      sigma^2 = (1 - a_bar_{t-1}) / (1 - a_bar_t) * beta_t
                (or beta_t when posterior_variance is False)
      x_{t-1} = mu + sigma * z   (no noise at t == 0)

    With `clip_x0` the mean is the posterior mean through the clipped x0
    estimate (Ho et al. eq. 7). t [B] int >= 0; `noise` is z, drawn by the
    caller. fp32 math, cast back to x_t.dtype."""
    xdtype = x_t.dtype
    x_t = x_t.to(torch.float32)
    eps_hat = eps_hat.to(torch.float32)
    nd = x_t.ndim

    beta_t = _bcast_gather(betas, t, nd)
    a_t = 1.0 - beta_t
    ab_t = _bcast_gather(alpha_bar, t, nd)
    ab_prev_raw = _bcast_gather(alpha_bar, torch.clamp(t - 1, min=0), nd)
    is_t0 = (t == 0).reshape((-1,) + (1,) * (nd - 1))
    ab_prev = torch.where(is_t0, torch.ones_like(ab_prev_raw), ab_prev_raw)

    if clip_x0 is not None:
        x0 = x_t - torch.sqrt(torch.clamp(1.0 - ab_t, min=0.0)) * eps_hat
        x0 = x0 / torch.sqrt(torch.clamp(ab_t, min=1e-20))
        x0 = torch.clamp(x0, clip_x0[0], clip_x0[1])
        denom = torch.clamp(1.0 - ab_t, min=1e-20)
        coef_x0 = torch.sqrt(ab_prev) * beta_t / denom
        coef_xt = torch.sqrt(a_t) * (1.0 - ab_prev) / denom
        mean = coef_x0 * x0 + coef_xt * x_t
    else:
        mean = x_t - beta_t / torch.sqrt(torch.clamp(1.0 - ab_t, min=1e-20)) * eps_hat
        mean = mean / torch.sqrt(a_t)
    if posterior_variance:
        var = (1.0 - ab_prev) / torch.clamp(1.0 - ab_t, min=1e-20) * beta_t
    else:
        var = beta_t
    sigma = torch.where(is_t0, torch.zeros_like(var), torch.sqrt(torch.clamp(var, min=0.0)))
    return (mean + sigma * noise.to(torch.float32)).to(xdtype)


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


def dpmpp_2m_step(
    x_t: torch.Tensor,
    t_now: torch.Tensor,
    t_prev: torch.Tensor,
    pred: torch.Tensor,
    alpha_bar: torch.Tensor,
    x0_prev: torch.Tensor,
    h_prev: torch.Tensor,
    *,
    param: str = "eps",
    clip_x0: Optional[Tuple[float, float]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One DPM-Solver++(2M) update (Lu et al. 2022: data prediction,
    multistep, the deterministic ODE form).

    With alpha_t = sqrt(a_bar), sigma_t = sqrt(1 - a_bar),
    lambda_t = log(alpha_t / sigma_t), h = lambda_prev - lambda_now:

        D = (1 + 1/(2 r)) x0_now - 1/(2 r) x0_last,  r = h_prev / h
        x_prev = (sigma_prev / sigma_now) x_t - alpha_prev (e^{-h} - 1) D

    The first step (h_prev <= 0) and the final step (t_prev == -1,
    a_bar(-1) := 1 as in ddim_step) use D = x0_now; the final step returns D
    itself (the sigma_prev -> 0 limit). `pred` is the model output under
    `param` ('eps'|'x0'|'v'). Returns (x_prev, x0_now, h): the caller carries
    x0_now and h [B, 1, ...] into the next step as x0_prev and h_prev. fp32
    math; x_prev is cast back to x_t.dtype."""
    xdtype = x_t.dtype
    x_t = x_t.to(torch.float32)
    pred = pred.to(torch.float32)
    nd = x_t.ndim

    a_t = _bcast_gather(alpha_bar, torch.clamp(t_now, min=0), nd)
    a_prev_raw = _bcast_gather(alpha_bar, torch.clamp(t_prev, min=0), nd)
    is_final = (t_prev < 0).reshape((-1,) + (1,) * (nd - 1))
    # a_bar(-1) := 1; the stand-in keeps lambda finite, the where() below
    # makes the final step exact
    a_prev = torch.where(is_final, torch.full_like(a_prev_raw, 1.0 - 1e-10), a_prev_raw)

    x0_now = to_x0_pred(x_t, pred, a_t, param=param)
    if clip_x0 is not None:
        x0_now = torch.clamp(x0_now, clip_x0[0], clip_x0[1])

    def lam(a: torch.Tensor) -> torch.Tensor:
        return 0.5 * (torch.log(torch.clamp(a, min=1e-20))
                      - torch.log(torch.clamp(1.0 - a, min=1e-20)))

    h = lam(a_prev) - lam(a_t)  # > 0 in the denoising direction
    r = h_prev / torch.clamp(h, min=1e-20)
    coef = torch.where((h_prev <= 0.0) | is_final, torch.zeros_like(r),
                       1.0 / (2.0 * torch.clamp(r, min=1e-20)))
    D = (1.0 + coef) * x0_now - coef * x0_prev.to(torch.float32)

    sigma_now = torch.sqrt(torch.clamp(1.0 - a_t, min=1e-20))
    sigma_prev = torch.sqrt(torch.clamp(1.0 - a_prev, min=0.0))
    x_prev = (sigma_prev / sigma_now) * x_t - torch.sqrt(a_prev) * (torch.exp(-h) - 1.0) * D
    x_prev = torch.where(is_final, D, x_prev)
    return x_prev.to(xdtype), x0_now, h
