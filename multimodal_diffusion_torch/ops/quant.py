"""Dynamic int8 (W8A8) projections for inference: ``model.core.quant: "int8"``
(counterpart of the JAX package's ``ops/quant.py``).

The MMDiT core's four hot projections (fused qkv, attention out, MLP fc1 and
fc2) run as int8 x int8 -> int32 products on eval-mode (deterministic)
passes:

  * activations are quantized per row (per token, symmetric absmax over the
    contraction dim) on every call, in plain PyTorch;
  * weights per output channel, once per parameter version
    (``Int8Weight``): the JAX package gets the same from XLA hoisting the
    loop-invariant quantization out of the sampler's scan;
  * the int32 product is rescaled by the two scale vectors in fp32, cast to
    the layer's compute dtype, and only then is the bias added in that dtype
    (flax ``Dense``: ``promote_dtype`` -> ``dot_general`` -> ``y += bias``).
    flax hands the quantizer the weight already cast to the compute dtype,
    so under bf16 compute the bf16-rounded weight is quantized.

The integer product is ``torch._int_mm`` (cuBLASLt) on the card, where the
JAX package has an XLA ``dot_general`` (no Pallas kernel): it needs more
than 16 rows (short inputs are padded with zero rows, which quantize to
zero, so the result is exact), and K and N multiples of 8 (else ValueError:
no silent fallback). On the CPU it is an int32 matmul of the same integers,
so integers, scales and outputs are bit-equal to the JAX package's.

Under tensor parallelism a projection whose contraction dimension is split
over the 'model' group (attention out, fc2; ``models/mmdit.py``) passes the
`group`: each per-token and per-output-channel absmax is the maximum over
the group of the ranks' maxima, and the int32 products are summed over the
group (exact) before the rescale and the bias, so every integer, scale and
output is one process's. A projection whose output rows are split needs
nothing: its scales are local.

Gradients: round and the int8 cast have zero derivative, as in JAX, so a
gradient through an int8 pass (the sync-guided sampler's) flows only
through the activation scales; ``torch.amax`` and ``torch.maximum`` share a
tie's gradient evenly, as JAX's max reduction and ``maximum`` do.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel import comm
from ..utils.profiling import span

# torch._int_mm wants more than 16 rows in its first operand
INT_MM_MIN_ROWS = 17
INT_MM_MULTIPLE = 8


class _AbsMaxOverGroup(torch.autograd.Function):
    """The max of `a` (>= 0) along `dim`, over the group's parts of that dim;
    the gradient goes to the elements equal to it, shared evenly among all
    of them on every rank, as torch.amax shares a tie in one process."""

    @staticmethod
    def forward(ctx, a, dim, group):
        amax = comm.all_reduce_max_(torch.amax(a, dim=dim, keepdim=True), group)
        ctx.save_for_backward(a, amax)
        ctx.dim, ctx.group = dim, group
        return amax

    @staticmethod
    def backward(ctx, g):
        a, amax = ctx.saved_tensors
        hit = (a == amax).to(g.dtype)
        count = comm.all_reduce_(hit.sum(dim=ctx.dim, keepdim=True), ctx.group)
        return g * hit / count, None, None


def quantize_rowwise(x: torch.Tensor, dim: int = -1, eps: float = 1e-8,
                     group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax int8 quantization along `dim`: (q int8, scale fp32)
    with x ~= q * scale; scale keeps `dim` as size 1. amax in fp32 (over
    `group`'s parts of `dim` when given), scale = max(amax, eps) / 127,
    round half to even, clip to +-127."""
    xf = x.float()
    if group is None:
        amax = torch.amax(torch.abs(xf), dim=dim, keepdim=True)
    else:
        amax = _AbsMaxOverGroup.apply(torch.abs(xf), dim, group)
    # divide by a tensor: CUDA's `tensor / python_scalar` multiplies by the
    # rounded reciprocal, which is not the true quotient JAX computes
    scale = (torch.maximum(amax, torch.full_like(amax, eps))
             / torch.full_like(amax, 127.0))
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def int_mm_unservable(K: int, N: int) -> Optional[str]:
    """Why torch._int_mm cannot take a [M, K] x [K, N] product on the card,
    or None when it can (M is padded to INT_MM_MIN_ROWS rows)."""
    bad = [f"{name}={n}" for name, n in (("K", K), ("N", N)) if n % INT_MM_MULTIPLE]
    if bad:
        return (f"torch._int_mm needs K and N multiples of {INT_MM_MULTIPLE}, got "
                f"{', '.join(bad)}")
    return None


def int8_matmul(a8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """[M, K] int8 x [N, K] int8 -> [M, N] int32 (a8 @ w8.T), exact. On the
    card torch._int_mm with the weight as the column-major [K, N] view of its
    row-major [N, K] storage; on the CPU an int32 matmul."""
    if a8.device.type == "cpu":
        return torch.matmul(a8.to(torch.int32), w8.t().to(torch.int32))
    M, K = a8.shape
    why = int_mm_unservable(K, w8.shape[0])
    if why:
        raise ValueError(why)
    if M < INT_MM_MIN_ROWS:
        a8 = F.pad(a8, (0, 0, 0, INT_MM_MIN_ROWS - M))
    return torch._int_mm(a8, w8.t())[:M]


def quantize_weight(w: torch.Tensor, dtype: torch.dtype,
                    group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """A Dense weight [out, in] -> (int8 [out, in] contiguous, per-output-
    channel scale [out] fp32), quantized from its value in `dtype` (what the
    layer multiplies by); with `group`, w is this rank's columns and the
    scales are the whole rows'."""
    if w.ndim != 2:
        raise NotImplementedError(f"int8 weights are [out, in] matrices, got {tuple(w.shape)}")
    q, scale = quantize_rowwise(w.to(dtype), dim=1, group=group)
    return q.contiguous(), scale.reshape(-1)


class Int8Weight:
    """The quantized weight of one projection, remade only when the
    parameter changes: keyed by its storage, version counter (every in-place
    update bumps it: optimizer steps, ``load_state_dict``), dtype and device.

    It is always made outside inference mode, under no_grad, from the
    parameter (an ordinary tensor), so the cache holds ordinary tensors even
    when the first call comes from a sampler under ``torch.inference_mode()``:
    the guided sampler's autograd pass, which leaves inference mode, can
    then save them for its backward. With a `group` (a weight whose input
    columns are split over it) the scales are the group's: every rank of
    it remakes its part at the same call, as the ranks update their
    parameters in step."""

    def __init__(self, group=None):
        self.group = group
        self._key = None
        self._value: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def __call__(self, w: torch.Tensor, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        key = (w.data_ptr(), w._version, w.dtype, w.device, dtype)
        if key != self._key:
            with torch.inference_mode(False), torch.no_grad():
                self._value = quantize_weight(w, dtype, self.group)
            self._key = key
        return self._value


def int8_linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                dtype: torch.dtype,
                qweight: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                group=None) -> torch.Tensor:
    """W8A8 counterpart of ``F.linear(x.to(dtype), w.to(dtype), b.to(dtype))``
    for a Dense weight w [out, in]: per-token activation and per-output-
    channel weight scales, an exact int32 product, ``y.float() * s_a * s_w``,
    the cast to `dtype`, then the bias in `dtype`. `qweight` is the weight's
    ``quantize_weight`` when already made (``Int8Weight``, with the same
    `group`). With `group`, x and w hold this rank's part of the contraction
    dimension: the scales are the group's and the int32 products are summed
    over it before the rescale (b is whole)."""
    if w.ndim != 2 or x.shape[-1] != w.shape[1]:
        raise NotImplementedError(
            f"int8_linear supports the Dense pattern only (x [..., in] against w [out, in]), "
            f"got x {tuple(x.shape)} and w {tuple(w.shape)}")
    x = x.to(dtype)
    w8, s_w = qweight if qweight is not None else quantize_weight(w, dtype, group)
    lead = x.shape[:-1]
    with span("int8_quantize"):
        a8, s_a = quantize_rowwise(x.reshape(-1, x.shape[-1]), group=group)
    with span("int8_mm"):
        y = comm.all_reduce_(int8_matmul(a8, w8), group)
    with span("int8_rescale"):
        out = (y.float() * s_a * s_w).to(dtype)
        if b is not None:
            out = out + b.to(dtype)
    return out.reshape(*lead, w.shape[0])
