"""Resampling with an antialiased triangle kernel, as ``jax.image.resize(x,
shape, method="trilinear")`` does it with its default ``antialias=True``
(the JAX package's ``VideoVAE.decode`` resizes so).

``jax.image.resize`` is separable: along each axis whose size changes it
contracts the input with a weight matrix [in, out] (``compute_weight_mat``
in ``jax/_src/image/scale.py``): the triangle kernel max(0, 1 - |d|) at
distance d between an output sample's position in input pixels,
(j + 0.5) / scale - 0.5 with scale = out / in, and each input pixel, the
distance divided by max(1 / scale, 1) (the kernel widened when shrinking:
a low-pass filter), each column normalised to sum 1, and a column whose
sample falls outside the input zeroed. When no axis shrinks this is
trilinear interpolation with half-pixel centres, which ``F.interpolate``
computes (``align_corners=False``); ``F.interpolate(antialias=True)`` has
no trilinear mode, hence this plain version for a shrink.
"""

from __future__ import annotations

from typing import Sequence

import torch


def triangle_weights(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """The [n_in, n_out] fp32 weight matrix of one axis (jax.image's
    compute_weight_mat for the triangle kernel, antialiased, no
    translation)."""
    f32 = torch.float32
    scale = torch.tensor(n_out / n_in, dtype=f32, device=device)
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = (torch.arange(n_out, dtype=f32, device=device) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(n_in, dtype=f32, device=device)[:, None])
    w = torch.clamp(1.0 - torch.abs(x / kernel_scale), min=0.0)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(f32).eps
    w = torch.where(torch.abs(total) > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_antialiased(x: torch.Tensor, size: Sequence[int],
                       dims: Sequence[int]) -> torch.Tensor:
    """`x` resampled to `size` along `dims` (one size per dim), axis by
    axis with ``triangle_weights``, in fp32; the other dims are untouched."""
    out = x.float()
    for d, n_out in zip(dims, size):
        n_in = out.shape[d]
        if n_in == int(n_out):
            continue
        w = triangle_weights(n_in, int(n_out), out.device)
        out = torch.movedim(torch.tensordot(out, w, dims=([d], [0])), -1, d)
    return out.to(x.dtype)
