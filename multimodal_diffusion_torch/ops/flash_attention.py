"""Flash-attention forward: the hand-written CUDA kernel, its plain PyTorch
version, and the wrapper that picks between them by device.

The kernel (``csrc/flash_fwd.cu``) replaces the TPU kernel
``_flash_fwd_kernel`` of the JAX package's ``ops/flash_attention.py``. It is
built with ``nvcc`` for ``sm_90a`` at first use into ``_build/`` (listed in
.gitignore) and bound with ctypes. ``flash_forward`` runs the plain version
only for a tensor on the CPU; for a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import torch

NEG_SENTINEL = -1e30
# the plain version walks K/V in the TPU kernel's 128-key tiles
REFERENCE_BLOCK_K = 128
SUPPORTED_HEAD_DIMS = (32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "flash_fwd.cu"
BUILD_DIR = _PKG / "_build"


def flash_forward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            valid: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain blockwise PyTorch version of the kernel: the same online softmax
    over 128-key tiles, fp32 statistics and accumulation, the -1e30 sentinel,
    and exact zeros for a row whose keys are all masked.

    q, k, v: [B, H, N, Dh] (fp32 or bf16); valid: optional [B, N] bool,
    True = attendable key. Returns (out [B, H, N, Dh] in q.dtype,
    lse [B, H, N] fp32)."""
    B, H, N, Dh = q.shape
    scale = 1.0 / (Dh ** 0.5)
    qf = q.float()
    m = torch.full((B, H, N), NEG_SENTINEL, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, N), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, N, Dh), dtype=torch.float32, device=q.device)
    for lo in range(0, N, REFERENCE_BLOCK_K):
        hi = min(lo + REFERENCE_BLOCK_K, N)
        s = torch.matmul(qf, k[:, :, lo:hi].float().transpose(-1, -2)) * scale
        ok = None
        if valid is not None:
            ok = valid[:, None, None, lo:hi]
            s = torch.where(ok, s, NEG_SENTINEL)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        if ok is not None:
            p = torch.where(ok, p, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(
            p.to(v.dtype).float(), v[:, :, lo:hi].float())
        m = m_new
    l_safe = torch.clamp(l, min=1e-30)
    out = (acc / l_safe[..., None]).to(q.dtype)
    return out, m + torch.log(l_safe)


def _nvcc() -> Optional[str]:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    return str(default) if default.exists() else None


def build() -> Path:
    """Compile csrc/flash_fwd.cu for sm_90a into BUILD_DIR (once per source
    content) and return the shared library's path. The compiler's register
    and shared-memory report is kept beside it as a .log."""
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libflash_fwd_{tag}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA flash-attention kernel cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    lib.with_suffix(".log").write_text(res.stderr)
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_fwd.argtypes = ([ptr] * 6 + [i32] * 6 + [i64] * 12
                              + [ctypes.c_float, ptr])
    lib.flash_fwd.restype = i32
    return lib


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  valid: Optional[torch.Tensor]) -> None:
    """Raise on anything the kernel does not take."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_forward: {name} is on {t.device}, not CUDA")
        if t.dim() != 4:
            raise ValueError(f"flash_forward: {name} must be [B, H, N, Dh]")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_forward: {name} needs unit stride along Dh")
    if not (q.shape == k.shape == v.shape):
        raise ValueError(f"flash_forward: shapes differ {q.shape} {k.shape} {v.shape}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_forward: dtypes must match and be fp32 or bf16, "
                         f"got {q.dtype} {k.dtype} {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_forward: q, k, v on different devices")
    B, H, N, Dh = q.shape
    if Dh not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_forward: Dh={Dh} not in {SUPPORTED_HEAD_DIMS}")
    if N == 0 or B * H == 0:
        raise ValueError("flash_forward: empty input")
    if valid is not None:
        if valid.dtype != torch.bool or tuple(valid.shape) != (B, N):
            raise ValueError(f"flash_forward: valid must be bool [B, N]=({B}, {N}), "
                             f"got {valid.dtype} {tuple(valid.shape)}")
        if valid.device != q.device or not valid.is_contiguous():
            raise ValueError("flash_forward: valid must be contiguous on q's device")


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  valid: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention forward with its logsumexp: (out [B, H, N, Dh], lse [B, H, N]).

    CPU tensors take ``flash_forward_reference``. CUDA tensors launch the
    kernel on the current stream, or raise (no fallback). ``out`` is a
    [B, H, N, Dh] view of a [B, N, H, Dh] buffer, so merging the heads
    afterwards costs no copy."""
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, valid)
    _check_inputs(q, k, v, valid)
    lib = _library()
    B, H, N, Dh = q.shape
    out = torch.empty((B, N, H, Dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    err = lib.flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if valid is None else valid.data_ptr(),
        out.data_ptr(), lse.data_ptr(), q.device.index or 0,
        B, H, N, Dh, _DTYPE_CODE[q.dtype], *strides,
        1.0 / (Dh ** 0.5), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed with CUDA error {err}")
    flash_forward.launches += 1
    return out, lse


flash_forward.launches = 0
