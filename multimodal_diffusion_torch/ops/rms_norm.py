"""RMSNorm over the last axis: the hand-written CUDA kernel
(``csrc/rms_norm.cu``), its plain PyTorch version, and the wrapper that picks
between them by device.

    out = (weight * x) / (sqrt(mean(x^2) + 1e-12) + eps)   statistics in fp32

The kernel replaces no TPU kernel: the JAX package leaves its RMSNorm to XLA,
which fuses it. It is one pass over each row in place of the ten elementwise
launches the formula takes in eager PyTorch (the source has the design and
its bound). It is built, loaded and counted through ``cuda_kernels.py``
(nvcc at first use; ``LAUNCHES["rms_norm"]``). A wrapper runs the plain
version only for a tensor on the CPU; for any other tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_kernels as ck

_X_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_W_CODE = {torch.float32: 0, torch.bfloat16: 1}
VEC = 8  # elements the kernel loads at a time: d is a multiple of it


def rms_norm_reference(x: torch.Tensor, weight: torch.Tensor, eps: float,
                       out_dtype: torch.dtype) -> torch.Tensor:
    """The plain version: the norm in fp32 over x's last axis, eps outside
    the square root, the +1e-12 inside it keeping an all-zero row (a
    CFG-dropped token) finite and its gradient too; the output in
    `out_dtype`."""
    xf = x.float()
    norm = torch.sqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + 1e-12)
    return (weight.float() * xf / (norm + eps)).to(out_dtype)


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # x, weight, out, device, B, N, d, batch and row strides, the three
    # dtype codes, eps, stream
    lib.rms_norm.argtypes = [ptr, ptr, ptr, i32, i64, i64, i32, i64, i64, i32, i32, i32,
                             ctypes.c_float, ptr]
    lib.rms_norm.restype = i32


def _check(x: torch.Tensor, weight: torch.Tensor, out_dtype: torch.dtype) -> None:
    """Raise on anything the kernel does not take."""
    if x.dim() != 3:
        raise ValueError(f"rms_norm: x must be [B, N, d], got {tuple(x.shape)}")
    d = x.shape[-1]
    if d == 0 or d % VEC:
        raise ValueError(f"rms_norm: d={d} is not a positive multiple of {VEC}")
    if x.dtype not in _X_CODE or out_dtype not in _X_CODE:
        raise ValueError(f"rms_norm: x and out must be fp32, bf16 or fp16, got {x.dtype} "
                         f"and {out_dtype}")
    if weight.dtype not in _W_CODE:
        raise ValueError(f"rms_norm: weight must be fp32 or bf16, got {weight.dtype}")
    if tuple(weight.shape) != (d,) or not weight.is_contiguous():
        raise ValueError(f"rms_norm: weight must be contiguous [{d}], got "
                         f"{tuple(weight.shape)} with strides {weight.stride()}")
    if weight.device != x.device:
        raise ValueError(f"rms_norm: weight on {weight.device}, x on {x.device}")
    if x.stride(-1) != 1:
        raise ValueError("rms_norm: x needs unit stride along d")
    # the kernel reads 16 bytes at a time from x and the weight
    ck.require_aligned("rms_norm", x=x, weight=weight)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             out_dtype: torch.dtype) -> torch.Tensor:
    """RMSNorm of x [B, N, d] over d, as a new contiguous tensor in
    `out_dtype`. x takes any batch and row strides (a view such as
    ``x[:, :N]`` of a padded sequence is read in place) and fp32, bf16 or
    fp16; the weight [d] fp32 or bf16.

    CPU tensors take ``rms_norm_reference``. Any other tensor launches the
    kernel on the current stream, or raises (no fallback)."""
    if x.device.type == "cpu":
        return rms_norm_reference(x, weight, eps, out_dtype)
    _check(x, weight, out_dtype)
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    B, N, d = x.shape
    err = ck.library("rms_norm", _declare).rms_norm(
        x.data_ptr(), weight.data_ptr(), out.data_ptr(), x.device.index or 0, B, N, d,
        x.stride(0), x.stride(1), _X_CODE[x.dtype], _W_CODE[weight.dtype],
        _X_CODE[out_dtype], eps, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rms_norm launch failed with CUDA error {err}")
    ck.LAUNCHES["rms_norm"] += 1
    return out
