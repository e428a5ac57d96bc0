"""FLUX.1's per-head QK RMSNorm, adjacent-pair RoPE and bf16 rounding of q
and k as one hand-written CUDA kernel (``csrc/qk_norm_rope.cu``), and its
wrapper. For each (token, head) row x of q, and likewise of k (Dh = 128):

    y = (x rsqrt(mean(x^2) + 1e-6)) scale                  fp32
    (y0, y1) -> (cos y0 - sin y1, sin y0 + cos y1)          each adjacent pair
    one rounding to bf16

The kernel replaces no TPU kernel (the JAX package has no FLUX.1). Its plain
version is the chain it stands in for, in ``models/flux.py``
(``plain_roped_qk``: the ``RMSNorm`` modules, ``apply_rope`` and the cast),
which the model runs for CPU tensors and under autograd. It is built, loaded
and counted through ``cuda_kernels.py`` (nvcc at first use;
``LAUNCHES["qk_norm_rope"]``). The wrapper launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import cuda_kernels as ck

DH = 128  # the head dim the kernel takes: 16 lanes of 8 elements a row


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # qkv, q and k scales, cos, sin, q and k out, device, B, n, H, batch and
    # row strides, offset, N_total, stream
    lib.qk_norm_rope.argtypes = [ptr] * 7 + [i32, i64, i64, i32, i64, i64, i64, i64, ptr]
    lib.qk_norm_rope.restype = i32


def _check(qkv: torch.Tensor, q_scale: torch.Tensor, k_scale: torch.Tensor,
           cos: torch.Tensor, sin: torch.Tensor, offset: int,
           out: Optional[Tuple[torch.Tensor, torch.Tensor]]) -> None:
    """Raise on anything the kernel does not take."""
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * DH) or qkv.shape[-1] == 0:
        raise ValueError(f"qk_norm_rope: qkv must be [B, n, 3 H {DH}], got {tuple(qkv.shape)}")
    if qkv.dtype != torch.bfloat16:
        raise ValueError(f"qk_norm_rope: qkv must be bf16, got {qkv.dtype}")
    if qkv.stride(-1) != 1:
        raise ValueError("qk_norm_rope: qkv needs unit stride along its last dim")
    for name, w in (("q_scale", q_scale), ("k_scale", k_scale)):
        if tuple(w.shape) != (DH,) or not w.is_contiguous():
            raise ValueError(f"qk_norm_rope: {name} must be contiguous [{DH}] (the head "
                             f"dim), got {tuple(w.shape)} with strides {w.stride()}")
        if w.dtype != torch.bfloat16:
            raise ValueError(f"qk_norm_rope: {name} must be bf16 (FLUX.1's served "
                             f"weights), got {w.dtype}")
    n_total = cos.shape[0] if cos.dim() == 2 else -1
    for name, t in (("cos", cos), ("sin", sin)):
        if t.dtype != torch.float32 or tuple(t.shape) != (n_total, DH // 2) \
                or not t.is_contiguous():
            raise ValueError(f"qk_norm_rope: {name} must be contiguous fp32 [N_total, "
                             f"{DH // 2}] like cos, got {t.dtype} {tuple(t.shape)}")
    if not 0 <= offset <= n_total - qkv.shape[1]:
        raise ValueError(f"qk_norm_rope: rows {offset} .. {offset + qkv.shape[1]} are not "
                         f"inside the tables' N_total = {n_total}")
    operands = dict(qkv=qkv, q_scale=q_scale, k_scale=k_scale, cos=cos, sin=sin)
    if out is not None:
        B, H = qkv.shape[0], qkv.shape[-1] // (3 * DH)
        for name, t in zip(("q_out", "k_out"), out):
            if t.dtype != torch.bfloat16 or tuple(t.shape) != (B, H, n_total, DH) \
                    or not t.is_contiguous():
                raise ValueError(f"qk_norm_rope: {name} must be contiguous bf16 "
                                 f"{[B, H, n_total, DH]}, got {t.dtype} {tuple(t.shape)}")
            operands[name] = t
    if any(t.device != qkv.device for t in operands.values()):
        raise ValueError(f"qk_norm_rope: every operand must be on qkv's {qkv.device}")
    # the kernel copies 16 bytes at a time from and to each of them
    ck.require_aligned("qk_norm_rope", **operands)


def qk_norm_rope(qkv: torch.Tensor, q_scale: torch.Tensor, k_scale: torch.Tensor,
                 cos: torch.Tensor, sin: torch.Tensor, offset: int = 0,
                 out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q and k of one stream's qkv projection [B, n, 3 H 128] (bf16, any
    batch and row strides, read in place), normed by the scales [128]
    (bf16), rotated by the tables cos, sin [N_total, 64] (fp32) at rows
    ``offset .. offset + n`` and rounded to bf16, written at those rows of
    ``out`` = (q, k), each [B, H, N_total, 128] bf16 (the flash forward's
    fastest layout): new buffers by default, a joint sequence's when a
    second stream writes beside the first. Returns ``out``. Launches the
    kernel on the current stream, or raises (CPU tensors included: their
    path is ``models/flux.py::plain_roped_qk``)."""
    _check(qkv, q_scale, k_scale, cos, sin, offset, out)
    if qkv.device.type == "cpu":
        raise ValueError("qk_norm_rope: a CUDA kernel; CPU tensors take the model's plain chain")
    B, n, width = qkv.shape
    H, n_total = width // (3 * DH), cos.shape[0]
    if out is None:
        out = tuple(torch.empty((B, H, n_total, DH), dtype=torch.bfloat16, device=qkv.device)
                    for _ in range(2))
    err = ck.library("qk_norm_rope", _declare).qk_norm_rope(
        qkv.data_ptr(), q_scale.data_ptr(), k_scale.data_ptr(), cos.data_ptr(), sin.data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), qkv.device.index or 0, B, n, H, qkv.stride(0),
        qkv.stride(1), offset, n_total, torch.cuda.current_stream(qkv.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"qk_norm_rope launch failed with CUDA error {err}")
    ck.LAUNCHES["qk_norm_rope"] += 1
    return out
