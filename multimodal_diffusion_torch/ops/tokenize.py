"""Latent <-> token transforms (counterpart of the JAX ``ops/tokenize.py``).

Token layout conventions:
  video: [B, C, T, H, W] -> [B, N, C*t*h*w], tokens raster-ordered t-major
         then h then w; within a token the feature order is (C, t, h, w).
  audio: [B, C, F] -> [B, N, C*l], feature order (C, l).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def tube_patch_video(z: torch.Tensor, t: int, h: int, w: int) -> torch.Tensor:
    """[B, C, T, H, W] -> [B, N, C*t*h*w], N = (T/t)(H/h)(W/w)."""
    B, C, T, H, W = z.shape
    if T % t or H % h or W % w:
        raise ValueError(f"tube sizes ({t},{h},{w}) must divide latent dims ({T},{H},{W})")
    z = z.reshape(B, C, T // t, t, H // h, h, W // w, w)
    z = z.permute(0, 2, 4, 6, 1, 3, 5, 7)  # [B, T', H', W', C, t, h, w]
    return z.reshape(B, (T // t) * (H // h) * (W // w), C * t * h * w)


def tube_unpatch_video(tokens: torch.Tensor, C: int, T: int, H: int, W: int,
                       t: int, h: int, w: int) -> torch.Tensor:
    """Inverse of tube_patch_video: [B, N, C*t*h*w] -> [B, C, T, H, W]."""
    B, N, D = tokens.shape
    if D != C * t * h * w:
        raise ValueError(f"token width {D} != C*t*h*w = {C * t * h * w}")
    Tt, Hh, Ww = T // t, H // h, W // w
    if N != Tt * Hh * Ww:
        raise ValueError(f"token count {N} != {Tt * Hh * Ww}")
    z = tokens.reshape(B, Tt, Hh, Ww, C, t, h, w)
    z = z.permute(0, 4, 1, 5, 2, 6, 3, 7)  # [B, C, T', t, H', h, W', w]
    return z.reshape(B, C, T, H, W)


def num_chunks(L: int, length: int, stride: int) -> int:
    """Window count for chunk_1d: floor((L - length)/stride) + 1 (>=1)."""
    if length <= 0 or stride <= 0 or L < length:
        return 1
    return (L - length) // stride + 1


def chunk_1d(x: torch.Tensor, length: int, stride: int, axis: int = -1) -> torch.Tensor:
    """Strided windows along `axis`: [..., L, ...] -> [..., N, length], the
    window pair at the end (window dim at -2). An input shorter than one
    window gives a single (shorter) window."""
    x = torch.movedim(x, axis, -1)
    L = x.shape[-1]
    if length <= 0 or stride <= 0 or L < length:
        out = x[..., : max(0, min(L, length))][..., None, :]
    else:
        out = x.unfold(-1, length, stride)  # [..., N, length]
    if axis not in (-1, x.ndim - 1):
        out = torch.movedim(out, -2, axis)
    return out


def _hann(W: int, dtype, device) -> torch.Tensor:
    """Periodic Hann window (== torch.hann_window(W))."""
    n = np.arange(W, dtype=np.float32)
    return torch.as_tensor(0.5 - 0.5 * np.cos(2.0 * np.pi * n / W),
                           dtype=dtype, device=device)


def overlap_add_1d(windows: torch.Tensor, stride: int, length: Optional[int] = None,
                   apply_hann: bool = False) -> torch.Tensor:
    """Overlap-add reconstruction: [..., N, W] -> [..., L], L = (N-1)*stride + W,
    normalized by the summed window weights."""
    *prefix, N, W = windows.shape
    if length is not None and length != W:
        windows = windows[..., :length]
        W = length
    L_out = (N - 1) * stride + W
    if apply_hann:
        win = _hann(W, windows.dtype, windows.device)
    else:
        win = torch.ones((W,), dtype=windows.dtype, device=windows.device)
    if stride == W and not apply_hann:
        return windows.reshape(*prefix, L_out)
    idx = (torch.arange(N, device=windows.device)[:, None] * stride
           + torch.arange(W, device=windows.device)[None, :]).reshape(-1)
    vals = (windows * win).reshape(*prefix, N * W)
    y = torch.zeros((*prefix, L_out), dtype=windows.dtype, device=windows.device)
    y = y.index_add(-1, idx, vals)
    norm = torch.zeros((L_out,), dtype=windows.dtype, device=windows.device)
    norm = norm.index_add(0, idx, win.repeat(N))
    return y / torch.clamp(norm, min=1e-8)


def pad_to_multiple(x: torch.Tensor, multiple: int, axis: int = -1,
                    value: float = 0.0) -> Tuple[torch.Tensor, int]:
    """Right-pad `axis` to a multiple of `multiple`; returns (padded, pad_amt)."""
    axis = axis % x.ndim
    pad_amt = (multiple - x.shape[axis] % multiple) % multiple
    if pad_amt == 0:
        return x, 0
    pads = [0, 0] * (x.ndim - 1 - axis) + [0, pad_amt]  # F.pad lists the last dim first
    return F.pad(x, pads, value=value), pad_amt


def audio_tokens_from_latent(z_a: torch.Tensor, length: int, stride: int) -> torch.Tensor:
    """[B, C, F] -> [B, N, C*length]; feature order (C, l)."""
    windows = chunk_1d(z_a, length=length, stride=stride, axis=-1)  # [B, C, N, l]
    B, C, N, l = windows.shape
    return windows.permute(0, 2, 1, 3).reshape(B, N, C * l)


def audio_latent_from_tokens(tokens: torch.Tensor, C: int, length: int, F_: int,
                             stride: int) -> torch.Tensor:
    """Inverse fold: [B, N, C*length] -> [B, C, F_] by overlap-add, then crop
    or zero-pad the time axis to exactly F_ (150 frames fold to 37 tokens of
    4; the last 2 frames come back as zeros)."""
    B, N, D = tokens.shape
    if D != C * length:
        raise ValueError(f"token width {D} != C*length = {C * length}")
    windows = tokens.reshape(B, N, C, length).permute(0, 2, 1, 3)  # [B, C, N, l]
    z = overlap_add_1d(windows, stride=stride, length=length)  # [B, C, L]
    L = z.shape[-1]
    if L > F_:
        z = z[..., :F_]
    elif L < F_:
        z = F.pad(z, (0, F_ - L))
    return z
