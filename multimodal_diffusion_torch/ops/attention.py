"""Multi-head attention compute op (counterpart of the JAX ``ops/attention.py``).

Two backends behind one function:

  * ``mha_reference`` — dense attention, fp32 scores and softmax;
  * ``flash_attention`` (ops/flash_attention.py) — the hand-written CUDA
    kernels, forward and backward (their plain versions for CPU tensors),
    masking keys in-kernel.

``multi_head_attention`` sends CUDA tensors to the kernels and CPU tensors
to the dense path, unless the caller chooses with ``use_kernel``. Both are
differentiable.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .flash_attention import NEG_SENTINEL, flash_attention


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  probs_dropout: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                  ) -> torch.Tensor:
    """Scaled dot-product attention. q, k, v: [B, H, N, Dh]; bias:
    broadcastable to [B, H, N, N] (additive); probs_dropout: applied to the
    fp32 probabilities (the training body with attention dropout). Returns
    [B, H, N, Dh] in q.dtype; scores, softmax and accumulation run in fp32."""
    dtype = q.dtype
    scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1)
    if probs_dropout is not None:
        probs = probs_dropout(probs)
    out = torch.einsum("bhnm,bhmd->bhnd", probs.to(dtype).float(), v.float())
    return out.to(dtype)


def padding_bias(key_padding_mask: torch.Tensor) -> torch.Tensor:
    """[B, N] bool (True = PAD) -> additive bias [B, 1, 1, N], finite -1e30
    at pads: padded keys are unattendable by every query."""
    bias = torch.zeros(key_padding_mask.shape, dtype=torch.float32,
                       device=key_padding_mask.device)
    return bias.masked_fill(key_padding_mask, NEG_SENTINEL)[:, None, None, :]


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         key_padding_mask: Optional[torch.Tensor] = None,
                         use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Attention over [B, H, N, Dh] with an optional [B, N] key-padding mask
    (True = PAD).

    ``use_kernel=None`` picks by device: the CUDA kernels for CUDA tensors,
    the dense path for CPU tensors; a CUDA tensor takes the dense path only
    when the caller passes ``use_kernel=False``, and a CPU tensor with
    ``use_kernel=True`` runs the kernels' plain versions, forward and
    backward. A batch row whose keys are all masked returns exact zeros on
    both paths.
    """
    if use_kernel is None:
        use_kernel = q.is_cuda
    if use_kernel:
        return flash_attention(q, k, v, key_padding_mask)
    if key_padding_mask is None:
        return mha_reference(q, k, v)
    out = mha_reference(q, k, v, padding_bias(key_padding_mask))
    # all keys masked: the finite bias cancels in softmax (uniform attention
    # over pads) where the kernel returns zeros; zero here too
    all_pad = key_padding_mask.all(dim=-1)[:, None, None, None]
    return torch.where(all_pad, torch.zeros_like(out), out)
