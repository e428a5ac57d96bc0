"""Plain PyTorch reference of the audio-video model's training step, written
from the model's equations and kept apart from the program under test: it
imports nothing of it (the forward's layers come from the sampling
reference beside it, ``av_sampling.py``).

Everything runs in float32 with TF32 off; gradients come from autograd
over the loss written out below. A step is handed what the program draws
for it: the timesteps, latent noise and CFG / clean-conditioning uniforms
(``draws``), and the uniforms of every dropout site in the order the
forward reaches it (``masks``: site name -> the site's uniforms in the
order the steps drew them, the heads' sites twice a step, video first),
kept where u < 1 - rate and scaled by 1 / (1 - rate).

  x = video / 255 -> z_v (video VAE encoder, RMS-normalised); z_a (audio
      codec encoder: two GELU convs, the mean of each hop-long window, a 1x1
      conv; RMS-normalised); both detached (model.encoder_stopgrad)
  t forced to 0 for the conditioning modality where clean_u < clean_cond_prob
  z_t = sqrt(abar_t) z + sqrt(1 - abar_t) noise; the target per
      diffusion.<m>.param (eps or x0)
  tokens, embeddings, CFG keep masks (the non-target modality and the mouth
      stream dropped where cfg_u < cfg_drop_prob), the MMDiT core with
      residual dropout after attention, GELU and the second MLP product, the
      heads with dropout after each trunk block
  loss = MSE on the target modality's head + align_w (1 - cos of the
      time-pooled features) + sync_w InfoNCE between time buckets
  global-norm clip, AdamW (optax semantics: bias-corrected moments,
      decoupled weight decay on every parameter, warmup-cosine rate)

After each update the EMA shadow (training.ema: the core's parameters or
all of them) takes decay of itself and 1 - decay of the parameters; it
starts at zero here (the check starts the program's there too).

Departures from the program: the Adam moments stay float32 (the
configuration may keep them in bf16); the reconstruction decode is not
covered (the configuration's ``recon_every``-th step takes it, and the
check compares steps before it).
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import av_sampling as avs
from .flux_sampling import no_tf32

Weights = Mapping[str, torch.Tensor]


# ---------------------------------------------------------------------------
# the forward's parts the sampling reference lacks
# ---------------------------------------------------------------------------


def encode_audio(W: Weights, s: Dict, wav: torch.Tensor) -> torch.Tensor:
    """wav [B, 1, L] -> z_a [B, Ca, Fa]: zero-padded to Fa windows of
    round(L / Fa) samples (one more when that falls short), each averaged."""
    h = avs.gelu(avs.conv(W, "aud_codec.pre0", wav))
    h = avs.gelu(avs.conv(W, "aud_codec.pre1", h))
    L, Fa = h.shape[-1], s["Fa"]
    hop = max(1, int(round(L / Fa)))
    if Fa * hop < L:
        hop += 1
    h = F.pad(h, (0, Fa * hop - L))
    h = h.reshape(h.shape[0], h.shape[1], Fa, hop).mean(dim=-1)
    return avs.latent_norm(s, avs.conv(W, "aud_codec.to_lat", h))


class Masks:
    """The dropout uniforms of a run, each site's taken in turn."""

    def __init__(self, masks: Dict[str, List[torch.Tensor]], rate: float):
        self.masks, self.rate, self.used = masks, rate, {}

    def __call__(self, site: str, x: torch.Tensor) -> torch.Tensor:
        if self.rate <= 0.0:
            return x
        k = self.used[site] = self.used.get(site, -1) + 1
        u = self.masks[site][k].to(x.device)
        if tuple(u.shape) != tuple(x.shape):
            raise ValueError(f"{site}: uniforms {tuple(u.shape)} for {tuple(x.shape)}")
        return torch.where(u < 1.0 - self.rate, x / (1.0 - self.rate), torch.zeros_like(x))


def core(W: Weights, s: Dict, x: torch.Tensor, drop: Masks) -> torch.Tensor:
    for i in range(s["layers"]):
        p = f"core.blocks.{i}"
        a = avs.attention(W, f"{p}.attn", avs.rms_norm(W, f"{p}.norm1", x), s["heads"])
        x = x + drop(f"{p}.attn.resid_drop", a)
        h = drop(f"{p}.mlp.drop1", avs.gelu(avs.dense(W, f"{p}.mlp.fc1", avs.rms_norm(
            W, f"{p}.norm2", x)), s["gelu_exact"]))
        x = x + drop(f"{p}.mlp.drop2", avs.dense(W, f"{p}.mlp.fc2", h))
    return avs.rms_norm(W, "core.norm", x)


def head(W: Weights, s: Dict, modality: str, h: torch.Tensor, drop: Masks) -> torch.Tensor:
    h = avs.dense(W, f"head.input_proj_{modality}", h)
    for i in range(s["head_layers"]):
        h = avs.gelu(avs.layer_norm(W, f"head.shared.{i}.norm",
                                    avs.dense(W, f"head.shared.{i}.dense", h), 1e-5))
        h = drop(f"head.shared.{i}.drop", h)
    return avs.dense(W, f"head.out_proj_{modality}", h)


def q_sample(abar: np.ndarray, z: torch.Tensor, t: torch.Tensor, noise: torch.Tensor):
    a = torch.as_tensor(abar, device=z.device)[t].reshape(-1, *([1] * (z.ndim - 1)))
    return torch.sqrt(a) * z + torch.sqrt(torch.clamp(1.0 - a, min=0.0)) * noise


def unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def buckets(n: int, Tg: int, device) -> torch.Tensor:
    """[Tg, n]: position i averaged into bucket floor(i Tg / n)."""
    M = torch.zeros(Tg, n, device=device)
    M[(torch.arange(n) * Tg) // n, torch.arange(n)] = 1.0
    return M / M.sum(dim=1, keepdim=True)


def sync_loss(h_v: torch.Tensor, h_a: torch.Tensor, time_chunks: int, tau: float) -> torch.Tensor:
    """Symmetric InfoNCE within each clip between the video features pooled
    per time chunk and the audio features, both bucketed to
    min(chunks, audio tokens) positions."""
    B, Nv, d = h_v.shape
    Na = h_a.shape[1]
    Tv = max(1, min(time_chunks, Nv))
    v = h_v[:, :Tv * (Nv // Tv)].reshape(B, Tv, Nv // Tv, d).mean(dim=2)
    Tg = max(1, min(Tv, Na))
    v = buckets(Tv, Tg, h_v.device) @ v
    a = buckets(Na, Tg, h_v.device) @ h_a
    logits = unit(v) @ unit(a).transpose(1, 2) / tau
    pos = torch.diagonal(logits, dim1=1, dim2=2)
    per = ((torch.logsumexp(logits, 2) - pos).mean(1) + (torch.logsumexp(logits, 1) - pos).mean(1))
    return 0.5 * per.mean()


def loss(W: Weights, cfg: Dict, video_u8: torch.Tensor, audio: torch.Tensor,
         target_is_video: float, draws: Dict[str, torch.Tensor], drop: Masks) -> torch.Tensor:
    """The step's loss: video [B, T, H, W, 3] uint8, audio [B, 1, L]."""
    s, t_cfg = avs.sizes(cfg), cfg["training"]
    with torch.no_grad():  # model.encoder_stopgrad, no reconstruction
        x = video_u8.float().permute(0, 4, 1, 2, 3) / 255.0
        z_v, z_a = avs.encode_video(W, s, x), encode_audio(W, s, audio.float())
    t_v, t_a = draws["t_v"], draws["t_a"]
    clean = draws["clean_u"] < float(t_cfg.get("clean_cond_prob", 0.0))
    if target_is_video:
        t_a = torch.where(clean, torch.zeros_like(t_a), t_a)
    else:
        t_v = torch.where(clean, torch.zeros_like(t_v), t_v)
    keep = 1.0 - (draws["cfg_u"] < float(t_cfg.get("cfg_drop_prob", 0.1))).float()
    w = float(target_is_video)
    keep_v, keep_a, keep_m = w + (1 - w) * keep, w * keep + (1 - w), (1 - w) * keep
    dv, da = cfg["diffusion"]["video"], cfg["diffusion"]["audio"]
    zv_t = q_sample(avs.alpha_bar(dv), z_v, t_v, draws["noise_v"])
    za_t = q_sample(avs.alpha_bar(da), z_a, t_a, draws["noise_a"])
    target_v = z_v if dv.get("param", "eps") == "x0" else draws["noise_v"]
    target_a = z_a if da.get("param", "eps") == "x0" else draws["noise_a"]
    if "v" in (dv.get("param", "eps"), da.get("param", "eps")):
        raise ValueError("the training reference covers eps and x0 targets")

    t, h, w_ = s["tube"]
    tok_v, tok_a = avs.tube_tokens(zv_t, t, h, w_), avs.chunk_tokens(za_t, *s["chunk"])
    grid = (zv_t.shape[2] // t, zv_t.shape[3] // h, zv_t.shape[4] // w_)
    d, tab = s["d"], avs._w(W, "embed.modality.table")
    xv = avs.dense(W, "adapt_v.proj", tok_v) + tab[0] + avs.pos3d(W, "embed.pos_v", grid)
    xa = (avs.dense(W, "adapt_a.proj", tok_a) + tab[1]
          + avs._w(W, "embed.pos_a.table")[:tok_a.shape[1]])
    xv = (xv + avs.timestep_embedding(t_v, d)[:, None]) * keep_v[:, None, None]
    xa = (xa + avs.timestep_embedding(t_a, d)[:, None]) * keep_a[:, None, None]
    parts = [xv, xa]
    if s["mouth"]:
        h0, h1, w0, w1 = s["mouth_box"]
        mt, mh, mw = s["mouth_tube"]
        tok_m = avs.tube_tokens(x[:, :, :, h0:h1, w0:w1] - 0.5, mt, mh, mw)
        mgrid = (x.shape[2] // mt, (h1 - h0) // mh, (w1 - w0) // mw)
        xm = avs.dense(W, "adapt_m.proj", tok_m) + tab[2] + avs.pos3d(W, "embed.pos_m", mgrid)
        xm = (xm + avs.timestep_embedding(torch.zeros_like(t_v), d)[:, None])
        parts.append(xm * keep_m[:, None, None])
    H = core(W, s, torch.cat(parts, dim=1), drop)
    nv, na = tok_v.shape[1], tok_a.shape[1]
    h_v, h_a = H[:, :nv], H[:, nv:nv + na]
    eps_v, eps_a = head(W, s, "video", h_v, drop), head(W, s, "audio", h_a, drop)
    mse_v = ((eps_v - avs.tube_tokens(target_v, t, h, w_)) ** 2).mean()
    mse_a = ((eps_a - avs.chunk_tokens(target_a, *s["chunk"])) ** 2).mean()
    total = w * mse_v + (1 - w) * mse_a
    align_w = float(t_cfg.get("align_loss_weight", 0.0))
    if align_w > 0:
        total = total + align_w * (1.0 - (unit(h_v.mean(1)) * unit(h_a.mean(1))).sum(-1).mean())
    sync_w = float(t_cfg.get("sync_loss_weight", 0.0))
    if sync_w > 0:
        if str(t_cfg.get("sync_loss_source", "video")) != "video":
            raise ValueError("the training reference covers the video sync source")
        total = total + sync_w * sync_loss(h_v, h_a, zv_t.shape[2] // t,
                                           float(t_cfg.get("sync_tau", 0.1)))
    return total


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


def learning_rate(cfg: Dict, count: int) -> float:
    """The rate of update `count` (0-based): 0 rising linearly to lr over
    the warmup, then cosine to 0 at max_steps (or lr throughout)."""
    t = cfg["training"]
    lr = float(t["optimizer"]["lr"])
    sched = t.get("scheduler", {}) or {}
    if str(sched.get("name", "none")).lower() != "cosine":
        return lr
    warm = max(1, int(sched.get("warmup_steps", 0)))
    if count < warm:
        return lr * count / warm
    total = max(int(t.get("max_steps", 100_000)), warm + 1)
    return lr * 0.5 * (1.0 + math.cos(math.pi * min(count - warm, total - warm) / (total - warm)))


class Run(NamedTuple):
    """What steps of training leave: each step's loss, and after the last
    the parameters, Adam's first moments and the EMA shadow, by name."""

    losses: List[float]
    params: Dict[str, torch.Tensor]
    moments: Dict[str, torch.Tensor]
    ema: Dict[str, torch.Tensor]


def ema_names(cfg: Dict, names: Sequence[str]) -> List[str]:
    """The parameters the EMA shadows (none when it is off)."""
    ema = cfg["training"].get("ema", {"use_ema": True}) or {}
    if not bool(ema.get("use_ema", True)):
        return []
    scope = str(ema.get("scope", "core"))
    return [n for n in names if scope == "all" or n.startswith("core.")]


def train(W0: Weights, cfg: Dict, steps: Sequence[Tuple],
          masks: Dict[str, List[torch.Tensor]]) -> Run:
    """Steps of (video, audio, target_is_video, draws) from the weights W0,
    the dropout uniforms handed in `masks` (see the module docstring)."""
    no_tf32()
    opt = cfg["training"]["optimizer"]
    b1, b2 = (float(b) for b in opt.get("betas", (0.9, 0.95)))
    eps, wd = float(opt.get("eps", 1e-8)), float(opt.get("weight_decay", 0.05))
    clip = float(cfg["training"].get("grad_clip_norm", 1.0))
    rate = float(cfg["model"]["core"].get("dropout", 0.0))
    decay = float((cfg["training"].get("ema", {}) or {}).get("decay", 0.999))
    names = list(W0)
    P = avs.Fp8Weights() if avs._low(W0) else {}
    P.update({n: W0[n].detach().float().clone().requires_grad_(True) for n in names})
    m = {n: torch.zeros_like(P[n]) for n in names}
    v = {n: torch.zeros_like(P[n]) for n in names}
    ema = {n: torch.zeros_like(P[n]) for n in ema_names(cfg, names)}
    losses, drop = [], Masks(masks, rate)
    for k, (video, audio, tiv, draws) in enumerate(steps):
        value = loss(P, cfg, video, audio, tiv, draws, drop)
        grads = torch.autograd.grad(value, [P[n] for n in names], allow_unused=True)
        losses.append(float(value.detach()))
        with torch.no_grad():
            g = {n: torch.zeros_like(P[n]) if gr is None else gr for n, gr in zip(names, grads)}
            norm = torch.sqrt(sum((x * x).sum() for x in g.values()))
            scale = 1.0 if float(norm) < clip else clip / float(norm)
            lr = learning_rate(cfg, k)
            for n in names:
                m[n] = b1 * m[n] + (1 - b1) * scale * g[n]
                v[n] = b2 * v[n] + (1 - b2) * (scale * g[n]) ** 2
                upd = (m[n] / (1 - b1 ** (k + 1))) / (torch.sqrt(v[n] / (1 - b2 ** (k + 1)))
                                                      + eps)
                P[n] -= lr * (upd + wd * P[n])
            for n in ema:
                ema[n] = decay * ema[n] + (1 - decay) * P[n]
    return Run(losses, {n: p.detach() for n, p in P.items()}, m, ema)
