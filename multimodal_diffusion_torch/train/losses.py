"""Training losses (counterpart of the JAX ``train/losses.py``): pure
functions of tensors, fp32 inside.

  * ``mse_targets_only`` — eps-MSE on the target modality only, with
    per-sample validity masks (``has_video``/``has_audio``);
  * ``alignment_loss`` — cosine or L2 between mean-pooled features;
  * ``sync_contrastive_loss`` — temporal InfoNCE between per-time video and
    audio features with proportional time bucketing;
  * ``reconstruction_loss`` — the autoencoders' pixel/waveform MSE.

A ``weight`` of 0 returns a constant 0 without touching the inputs.

``group``: the data-parallel group whose ranks hold the rest of the batch.
Each rank then returns its rows' share of the global batch's loss: the
counts and batch sizes a loss divides by are the global batch's (summed
over the group, no gradient), so the sum over the group is the loss of the
whole batch and the sum of the ranks' gradients its gradient. None (one
rank) is the one-process loss.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..parallel import comm


def _zero(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=like.device)


def _total(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over the data group (a count: no gradient)."""
    return x if group is None else comm.all_reduce_(x.detach().float().clone(), group)


def _masked_mse(pred: torch.Tensor, true: torch.Tensor,
                sample_mask: Optional[torch.Tensor], group=None) -> torch.Tensor:
    err = torch.square(pred.float() - true.float())
    if sample_mask is None:
        return err.mean() / comm.group_size(group)
    m = sample_mask.float()  # [B]
    per_sample = err.reshape(err.shape[0], -1).mean(dim=-1)
    return (per_sample * m).sum() / torch.clamp(_total(m.sum(), group), min=1.0)


def mse_targets_only(eps_hat_v: torch.Tensor, eps_hat_a: torch.Tensor,
                     eps_true_v: torch.Tensor, eps_true_a: torch.Tensor,
                     target_is_video: Union[float, torch.Tensor],
                     has_video: Optional[torch.Tensor] = None,
                     has_audio: Optional[torch.Tensor] = None, group=None) -> torch.Tensor:
    """w * mse_v + (1 - w) * mse_a with w = target_is_video (0 or 1)."""
    w = torch.as_tensor(target_is_video, dtype=torch.float32, device=eps_hat_v.device)
    loss_v = _masked_mse(eps_hat_v, eps_true_v, has_video, group)
    loss_a = _masked_mse(eps_hat_a, eps_true_a, has_audio, group)
    return w * loss_v + (1.0 - w) * loss_a


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def alignment_loss(h_video: torch.Tensor, h_audio: torch.Tensor, weight: float = 0.0,
                   method: str = "cosine", group=None) -> torch.Tensor:
    """h_video [B, Nv, d], h_audio [B, Na, d]: weight * (1 - mean cosine) of
    the time-pooled features, or weight * their mean squared distance."""
    if weight <= 0.0:
        return _zero(h_video)
    v = h_video.float().mean(dim=1)
    a = h_audio.float().mean(dim=1)
    if method == "cosine":
        loss = 1.0 - (_unit(v) * _unit(a)).sum(dim=-1).mean()
    elif method == "l2":
        loss = torch.square(v - a).mean()
    else:
        raise ValueError("Unknown alignment method")
    return weight * loss / comm.group_size(group)


def _bucket_matrix(n: int, Tg: int) -> np.ndarray:
    """[Tg, n] averaging matrix: token i goes to bucket floor(i * Tg / n)."""
    bucket = (np.arange(n) * Tg) // n
    M = np.zeros((Tg, n), np.float32)
    M[bucket, np.arange(n)] = 1.0
    return M / M.sum(axis=1, keepdims=True)


def sync_contrastive_loss(h_video: torch.Tensor, h_audio: torch.Tensor,
                          video_time_chunks: int, weight: float = 0.0, tau: float = 0.1,
                          sample_weight: Optional[torch.Tensor] = None,
                          group=None) -> torch.Tensor:
    """Temporal InfoNCE within each clip. Video tokens are time-major: the
    spatial mean per time chunk gives [B, Tv, d]; both streams are then
    bucketed proportionally to Tg = min(Tv, Na) positions, L2-normalized and
    scored [B, Tg, Tg] / tau. Positives are the matching time bucket,
    negatives the same clip's other times; symmetric v->a / a->v
    cross-entropy, averaged over the batch or weighted by `sample_weight`."""
    if weight <= 0.0:
        return _zero(h_video)
    B, Nv, d = h_video.shape
    Na = h_audio.shape[1]
    Tv = max(1, min(int(video_time_chunks), Nv))
    S = Nv // Tv
    v = h_video[:, :Tv * S].float().reshape(B, Tv, S, d).mean(dim=2)  # [B, Tv, d]
    Tg = max(1, min(Tv, Na))
    dev = h_video.device
    v = torch.einsum("ts,bsd->btd", torch.from_numpy(_bucket_matrix(Tv, Tg)).to(dev), v)
    a = torch.einsum("ts,bsd->btd", torch.from_numpy(_bucket_matrix(Na, Tg)).to(dev),
                     h_audio.float())
    logits = torch.einsum("btd,bsd->bts", _unit(v), _unit(a)) / tau  # [B, Tg, Tg]
    pos = torch.diagonal(logits, dim1=1, dim2=2)  # [B, Tg]
    per_sample = ((torch.logsumexp(logits, dim=2) - pos).mean(dim=1)
                  + (torch.logsumexp(logits, dim=1) - pos).mean(dim=1))  # [B]
    if sample_weight is None:
        loss = per_sample.mean() / comm.group_size(group)
    else:
        w = sample_weight.float()
        loss = (per_sample * w).sum() / torch.clamp(_total(w.sum(), group), min=1e-6)
    return weight * 0.5 * loss


def reconstruction_loss(recon_v: torch.Tensor, video: torch.Tensor,
                        recon_a: torch.Tensor, audio: torch.Tensor, weight: float = 0.0,
                        has_video: Optional[torch.Tensor] = None,
                        has_audio: Optional[torch.Tensor] = None,
                        group=None) -> torch.Tensor:
    """weight * (video MSE + audio MSE); the codec's decode length can differ
    from the input's by a partial hop, so audio is compared over the common
    prefix."""
    if weight <= 0.0:
        return _zero(recon_v)
    L = min(recon_a.shape[-1], audio.shape[-1])
    return weight * (_masked_mse(recon_v, video, has_video, group)
                     + _masked_mse(recon_a[..., :L], audio[..., :L], has_audio, group))
