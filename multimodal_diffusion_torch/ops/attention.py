"""Multi-head attention compute op (counterpart of the JAX ``ops/attention.py``).

Two backends behind one function:

  * ``mha_reference`` — dense attention, fp32 scores and softmax;
  * ``flash_attention`` (ops/flash_attention.py) — the hand-written CUDA
    kernels, forward and backward (their plain versions for CPU tensors),
    masking keys in-kernel.

``multi_head_attention`` sends CUDA tensors to the kernels and CPU tensors
to the dense path. Both are differentiable. ``attention_path`` forces one of
them for every call inside its scope, wherever in a model the call is.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Optional

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


# module state, not thread-local: autograd runs a CUDA backward (and with it
# an activation-checkpointing recompute) on its own device thread
_forced: Optional[str] = None


@contextlib.contextmanager
def attention_path(path: Optional[str]) -> Iterator[None]:
    """Force ``multi_head_attention``'s path inside the scope: "kernel" (the
    kernels, or their plain versions for CPU tensors, forward and backward),
    "dense", or None (by device). Tests and on-card checks compare the two
    paths with it; nothing in the program sets it."""
    global _forced
    if path not in (None, "kernel", "dense"):
        raise ValueError(f"attention path must be 'kernel', 'dense' or None, got {path!r}")
    outer, _forced = _forced, path
    try:
        yield
    finally:
        _forced = outer


def forced_path() -> Optional[str]:
    """The path ``attention_path`` forces now, or None."""
    return _forced


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over [B, H, N, Dh] with an optional [B, N] key-padding mask
    (True = PAD): the CUDA kernels for CUDA tensors, the dense path for CPU
    tensors, unless ``attention_path`` forces one. A batch row whose keys are
    all masked returns exact zeros on both paths.
    """
    if (_forced or ("kernel" if q.is_cuda else "dense")) == "kernel":
        return flash_attention(q, k, v, key_padding_mask)
    if key_padding_mask is None:
        return mha_reference(q, k, v)
    out = mha_reference(q, k, v, padding_bias(key_padding_mask))
    # all keys masked: the finite bias cancels in softmax (uniform attention
    # over pads) where the kernel returns zeros; zero here too
    all_pad = key_padding_mask.all(dim=-1)[:, None, None, None]
    return torch.where(all_pad, torch.zeros_like(out), out)
