"""Flash attention: the hand-written CUDA kernels, their plain PyTorch
versions, the wrappers that pick between them by device, and the
differentiable ``flash_attention`` over them.

  * ``csrc/flash_fwd.cu`` replaces the TPU kernel ``_flash_fwd_kernel`` of
    the JAX package's ``ops/flash_attention.py`` (``flash_forward``);
  * ``csrc/flash_bwd.cu`` replaces ``_flash_bwd_dkdv_kernel`` and
    ``_flash_bwd_dq_kernel`` (``flash_backward``, two launches per call).

Each source is built with ``nvcc`` for ``sm_90a`` at first use into
``_build/`` (listed in .gitignore), keyed by the content hash of the source
and of every header beside it, and bound with ctypes. The bf16 backward
kernels run on the tensor cores (``wgmma``) and copy 16 bytes at a time, so
their operands must be 16-byte aligned (``misaligned_operands``); fp32 keeps
FMA kernels, which take any alignment. A wrapper runs the plain version only
for a tensor on the CPU; for a CUDA tensor it launches its kernel or raises.
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
SOURCES = {name: _PKG / "csrc" / f"{name}.cu" for name in ("flash_fwd", "flash_bwd")}
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


def source_tag(source: Path) -> str:
    """Content hash of a .cu file and of every header in its directory (any
    of which it may include): the key of its built library."""
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")) + sorted(source.parent.glob("*.h")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    return digest.hexdigest()[:16]


def build(name: str = "flash_fwd") -> Path:
    """Compile csrc/<name>.cu for sm_90a into BUILD_DIR (once per content of
    the source and the headers beside it) and return the shared library's
    path. The compiler's register and shared-memory report is kept beside it
    as a .log. Safe to call for several sources at once from threads."""
    source = SOURCES[name]
    lib = BUILD_DIR / f"lib{name}_{source_tag(source)}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA flash-attention kernels cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-I", str(source.parent), "-o", str(tmp), str(source)]
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    lib.with_suffix(".log").write_text(res.stderr)
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def _library(name: str = "flash_fwd") -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build(name)))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if name == "flash_fwd":
        lib.flash_fwd.argtypes = ([ptr] * 6 + [i32] * 6 + [i64] * 12
                                  + [ctypes.c_float, ptr])
        lib.flash_fwd.restype = i32
    else:
        # q, k, v, dout, lse, delta, valid, outputs..., device, B, H, N, D,
        # dtype, strides (int64[21]), scale, stream
        strides = ctypes.POINTER(i64)
        lib.flash_bwd_dkdv.argtypes = [ptr] * 9 + [i32] * 6 + [strides, ctypes.c_float, ptr]
        lib.flash_bwd_dq.argtypes = [ptr] * 8 + [i32] * 6 + [strides, ctypes.c_float, ptr]
        lib.flash_bwd_dkdv.restype = lib.flash_bwd_dq.restype = i32
        lib.flash_bwd_occupancy.argtypes = [i32, i32, ctypes.POINTER(i32), ctypes.POINTER(i32)]
        lib.flash_bwd_occupancy.restype = i32
    return lib


def backward_occupancy() -> dict:
    """Of each bf16 backward kernel at each head dim, on the current card:
    the dynamic shared memory of one block and the blocks an SM holds at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; 128 threads a block)."""
    lib = _library("flash_bwd")
    table = {}
    for kernel in ("dkdv", "dq"):
        for head_dim in SUPPORTED_HEAD_DIMS:
            smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
            err = lib.flash_bwd_occupancy(int(kernel == "dq"), head_dim,
                                          ctypes.byref(smem), ctypes.byref(blocks))
            if err != 0:
                raise RuntimeError(f"flash_bwd_occupancy failed with CUDA error {err}")
            table[f"flash_bwd_{kernel}_bf16_dh{head_dim}"] = {
                "smem_bytes_per_block": smem.value, "blocks_per_sm": blocks.value}
    return table


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  valid: Optional[torch.Tensor], who: str = "flash_forward",
                  **more: torch.Tensor) -> None:
    """Raise on anything the kernel does not take. ``more`` names further
    [B, H, N, Dh] operands held to q's shape, dtype and device (dout)."""
    operands = {"q": q, "k": k, "v": v, **more}
    for name, t in operands.items():
        if not t.is_cuda:
            raise ValueError(f"{who}: {name} is on {t.device}, not CUDA")
        if t.dim() != 4:
            raise ValueError(f"{who}: {name} must be [B, H, N, Dh]")
        if t.stride(-1) != 1:
            raise ValueError(f"{who}: {name} needs unit stride along Dh")
    if any(t.shape != q.shape for t in operands.values()):
        raise ValueError(f"{who}: shapes differ "
                         f"{[tuple(t.shape) for t in operands.values()]}")
    if any(t.dtype != q.dtype for t in operands.values()) or q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{who}: dtypes must match and be fp32 or bf16, "
                         f"got {[t.dtype for t in operands.values()]}")
    if any(t.device != q.device for t in operands.values()):
        raise ValueError(f"{who}: operands on different devices")
    B, H, N, Dh = q.shape
    if Dh not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{who}: Dh={Dh} not in {SUPPORTED_HEAD_DIMS}")
    if N == 0 or B * H == 0:
        raise ValueError(f"{who}: empty input")
    if valid is not None:
        if valid.dtype != torch.bool or tuple(valid.shape) != (B, N):
            raise ValueError(f"{who}: valid must be bool [B, N]=({B}, {N}), "
                             f"got {valid.dtype} {tuple(valid.shape)}")
        if valid.device != q.device or not valid.is_contiguous():
            raise ValueError(f"{who}: valid must be contiguous on q's device")


def misaligned_operands(**operands: torch.Tensor) -> list:
    """Names of the [B, H, N, Dh] operands that the bf16 backward kernels
    cannot copy 16 bytes at a time: a base address or a batch, head or row
    stride (of a dim longer than 1) that is not a multiple of 16 bytes. Reads
    only addresses and strides, so it takes tensors on any device."""
    bad = []
    for name, t in operands.items():
        step = 16 // t.element_size()
        strides = [s for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
        if t.data_ptr() % 16 or any(s % step for s in strides):
            bad.append(name)
    return bad


def require_aligned(who: str, **operands: torch.Tensor) -> None:
    """Raise for operands that ``misaligned_operands`` names: there is no
    slower path behind the bf16 backward kernels."""
    bad = misaligned_operands(**operands)
    if bad:
        raise ValueError(f"{who}: {bad} not 16-byte aligned (base address and batch, "
                         f"head and row strides)")


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
    lib = _library("flash_fwd")
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


def flash_backward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                             valid: Optional[torch.Tensor] = None,
                             delta: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain blockwise PyTorch version of the two backward kernels: over
    128-key tiles, recompute P = where(ok, exp(S - lse), 0), then
    dV = P^T dO (P rounded to dout.dtype), dP = dO V^T,
    dS = P * (dP - D) rounded to q.dtype, dK = scale * dS^T Q and
    dQ = scale * dS K, accumulating in fp32.

    q, k, v, out, dout: [B, H, N, Dh]; lse: [B, H, N] fp32 (the forward's);
    valid: optional [B, N] bool, True = attendable key; delta: optional
    [B, H, N] fp32 rowsum(dout * out), computed from out and dout when not
    given. Returns (dq, dk, dv) in q.dtype."""
    B, H, N, Dh = q.shape
    scale = 1.0 / (Dh ** 0.5)
    qf, dof = q.float(), dout.float()
    if delta is None:
        delta = (dof * out.float()).sum(dim=-1)
    dq = torch.zeros((B, H, N, Dh), dtype=torch.float32, device=q.device)
    dk, dv = [], []
    for lo in range(0, N, REFERENCE_BLOCK_K):
        hi = min(lo + REFERENCE_BLOCK_K, N)
        kb, vb = k[:, :, lo:hi].float(), v[:, :, lo:hi].float()
        s = torch.matmul(qf, kb.transpose(-1, -2)) * scale
        p = torch.exp(s - lse[..., None])
        if valid is not None:
            # a select, not a product: exp(s - lse) is inf on a row whose
            # keys are all masked (lse = -1e30)
            p = torch.where(valid[:, None, None, lo:hi], p, 0.0)
        dv.append(torch.matmul(p.to(dout.dtype).float().transpose(-1, -2), dof))
        dp = torch.matmul(dof, vb.transpose(-1, -2))
        ds = (p * (dp - delta[..., None])).to(q.dtype).float()
        dk.append(torch.matmul(ds.transpose(-1, -2), qf) * scale)
        dq += torch.matmul(ds, kb)
    return ((dq * scale).to(q.dtype), torch.cat(dk, dim=2).to(q.dtype),
            torch.cat(dv, dim=2).to(q.dtype))


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                   valid: Optional[torch.Tensor] = None,
                   delta: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of attention with respect to q, k, v: (dq, dk, dv), each
    [B, H, N, Dh] in q.dtype.

    ``delta`` = rowsum(dout * out) [B, H, N] fp32 is computed here, outside
    the kernels, when not given; ``lse`` [B, H, N] fp32 is the forward's. Both
    are inputs of the kernels, which never recompute them (a ring attention
    hands in global ones). CPU tensors take ``flash_backward_reference``. CUDA
    tensors launch the dK/dV kernel, then the dQ kernel, on the current
    stream, or raise (no fallback). The three grads are [B, H, N, Dh] views of
    one [B, N, 3, H, Dh] buffer, the layout of the fused qkv projection."""
    if q.device.type == "cpu":
        return flash_backward_reference(q, k, v, out, lse, dout, valid, delta)
    _check_inputs(q, k, v, valid, "flash_backward", dout=dout)
    if q.dtype == torch.bfloat16:
        require_aligned("flash_backward", q=q, k=k, v=v, dout=dout)
    B, H, N, Dh = q.shape
    if delta is None:
        delta = (dout.float() * out.float()).sum(dim=-1)
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (B, H, N)
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"flash_backward: {name} must be contiguous fp32 "
                             f"[B, H, N]=({B}, {H}, {N}) on q's device, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    grads = torch.empty((B, N, 3, H, Dh), dtype=q.dtype, device=q.device)
    for kernel in ("dkdv", "dq"):
        launch_backward_kernel(kernel, q, k, v, dout, lse, delta, valid, grads)
    dq, dk, dv = (grads[:, :, i].transpose(1, 2) for i in range(3))
    return dq, dk, dv


def launch_backward_kernel(kernel: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           dout: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                           valid: Optional[torch.Tensor], grads: torch.Tensor) -> None:
    """Launch one backward kernel, "dkdv" or "dq", on the current stream and
    count the launch (``flash_backward.dkdv_launches``/``dq_launches``). It
    writes its grads into `grads` [B, N, 3, H, Dh] (q, k, v along axis 2).
    The operands are those ``flash_backward`` checked; chip_smoke.py calls
    this directly to time each kernel alone."""
    B, H, N, Dh = q.shape
    views = [grads[:, :, i].transpose(1, 2) for i in range(3)]
    if q.dtype == torch.bfloat16:
        require_aligned("flash_backward", dq=views[0], dk=views[1], dv=views[2])
    strides = (ctypes.c_longlong * 21)(
        *(s for t in (q, k, v, dout, *views) for s in t.stride()[:3]))
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
           delta.data_ptr(), None if valid is None else valid.data_ptr())
    outs = ((views[1].data_ptr(), views[2].data_ptr()) if kernel == "dkdv"
            else (views[0].data_ptr(),))
    fn = getattr(_library("flash_bwd"), f"flash_bwd_{kernel}")
    err = fn(*ins, *outs, q.device.index or 0, B, H, N, Dh, _DTYPE_CODE[q.dtype], strides,
             1.0 / (Dh ** 0.5), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd_{kernel} launch failed with CUDA error {err}")
    name = f"{kernel}_launches"
    setattr(flash_backward, name, getattr(flash_backward, name) + 1)


flash_backward.dkdv_launches = 0
flash_backward.dq_launches = 0


class _FlashAttention(torch.autograd.Function):
    """flash_forward with flash_backward as its gradient (the counterpart of
    the JAX package's custom_vjp pair ``_flash_plain``/``_flash_masked``).
    Saves q, k, v, out, lse and valid."""

    @staticmethod
    def forward(ctx, q, k, v, valid):
        out, lse = flash_forward(q, k, v, valid)
        ctx.save_for_backward(q, k, v, out, lse, valid)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, valid = ctx.saved_tensors
        # e.g. an expanded (stride 0) gradient, or a view off the 16-byte grid
        if dout.stride(-1) != 1 or (dout.dtype == torch.bfloat16
                                    and misaligned_operands(dout=dout)):
            dout = dout.contiguous()
        dq, dk, dv = flash_backward(q, k, v, out, lse, dout, valid)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable attention [B, H, N, Dh] x3 -> [B, H, N, Dh] through the
    kernels (their plain versions on the CPU). key_padding_mask: optional
    [B, N] bool, True = PAD, masked inside the kernels; a row whose keys are
    all masked gives exact zeros and zero grads. Without autograd (sampling)
    it is one flash_forward call and saves nothing."""
    valid = None if key_padding_mask is None else ~key_padding_mask
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, valid)
    return flash_forward(q, k, v, valid)[0]
