"""Flash attention: the hand-written CUDA kernels, their plain PyTorch
versions, the wrappers that pick between them by device, and the
differentiable ``flash_attention`` over them.

  * ``csrc/flash_fwd.cu`` replaces the TPU kernel ``_flash_fwd_kernel`` of
    the JAX package's ``ops/flash_attention.py`` (``flash_forward``, one
    launch per call, of the kernel ``forward_kernel`` picks by shape);
  * ``csrc/flash_bwd.cu`` replaces ``_flash_bwd_dkdv_kernel`` and
    ``_flash_bwd_dq_kernel`` (``flash_backward``, two launches per call).

Each source is built, loaded and counted through ``cuda_kernels.py`` (nvcc
at first use; ``LAUNCHES["flash_fwd"]`` counts every forward launch,
``["flash_fwd_ws"]`` those of the warp-specialised forward among them, and
``["flash_bwd_dkdv"]`` and ``["flash_bwd_dq"]`` the backward's). The bf16
kernels, forward and backward, run on the
tensor cores (``wgmma``) and copy 16 bytes at a time, so their operands must
be 16-byte aligned (``cuda_kernels.misaligned_operands``); fp32 keeps FMA
kernels, which take any alignment. A wrapper runs the plain version only for
a tensor on the CPU; for a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import cuda_kernels as ck

NEG_SENTINEL = -1e30
# the plain version walks K/V in the TPU kernel's 128-key tiles
REFERENCE_BLOCK_K = 128
SUPPORTED_HEAD_DIMS = (32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# The warp-specialised bf16 forward (csrc/flash_fwd.cu, flash_fwd_ws_kernel)
# takes head dim 64 from this many keys on: a block of three consumer
# warpgroups owns 192 query rows and walks 128-key stages that a TMA producer
# warp fills, one block an SM. On an H100 at [2, 48, N, 64] it ties the
# one-warpgroup kernel at N = 512 and is 24 % faster at 768 (PERF.md); below,
# the 64-row blocks fill the card better. Its layout is head dim 64's only.
WS_MIN_KEYS = 768
_DESIGN = {"flash_fwd": 0, "flash_fwd_ws": 1}


def forward_kernel(dtype: torch.dtype, head_dim: int, n: int) -> str:
    """The forward kernel for a [B, H, n, head_dim] call: "flash_fwd_ws" (the
    warp-specialised design) for bf16 at head dim 64 and n >= WS_MIN_KEYS,
    "flash_fwd" (the FMA kernel for fp32, the one-warpgroup tensor-core
    kernel for bf16) for every other shape. Pure: shape and dtype only."""
    if dtype == torch.bfloat16 and head_dim == 64 and n >= WS_MIN_KEYS:
        return "flash_fwd_ws"
    return "flash_fwd"


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


def _declare_forward(lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_fwd.argtypes = [ptr] * 6 + [i32] * 7 + [i64] * 12 + [ctypes.c_float, ptr]
    lib.flash_fwd.restype = i32
    lib.flash_fwd_occupancy.argtypes = [i32, i32, ctypes.POINTER(i32), ctypes.POINTER(i32)]
    lib.flash_fwd_occupancy.restype = i32


def _declare_backward(lib: ctypes.CDLL) -> None:
    # q, k, v, dout, lse, delta, valid, outputs..., device, B, H, N, D,
    # dtype, strides (int64[21]), scale, stream
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    strides = ctypes.POINTER(ctypes.c_longlong)
    lib.flash_bwd_dkdv.argtypes = [ptr] * 9 + [i32] * 6 + [strides, ctypes.c_float, ptr]
    lib.flash_bwd_dq.argtypes = [ptr] * 8 + [i32] * 6 + [strides, ctypes.c_float, ptr]
    lib.flash_bwd_dkdv.restype = lib.flash_bwd_dq.restype = i32
    lib.flash_bwd_occupancy.argtypes = [i32, i32, ctypes.POINTER(i32), ctypes.POINTER(i32)]
    lib.flash_bwd_occupancy.restype = i32


def _occupancy(fn, *args) -> dict:
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    err = fn(*args, ctypes.byref(smem), ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed with CUDA error {err}")
    return {"smem_bytes_per_block": smem.value, "blocks_per_sm": blocks.value}


def forward_occupancy() -> dict:
    """Of the bf16 forward kernels on the current card, the one-warpgroup
    kernel at each head dim (128 threads a block) and the warp-specialised
    one at head dim 64 (512): the dynamic shared memory of one block and the
    blocks an SM holds at once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    fn = ck.library("flash_fwd", _declare_forward).flash_fwd_occupancy
    occupancy = {f"flash_fwd_bf16_dh{head_dim}": _occupancy(fn, head_dim, 0)
                 for head_dim in SUPPORTED_HEAD_DIMS}
    occupancy["flash_fwd_ws_bf16_dh64"] = _occupancy(fn, 64, 1)
    return occupancy


def backward_occupancy() -> dict:
    """The same of each bf16 backward kernel."""
    fn = ck.library("flash_bwd", _declare_backward).flash_bwd_occupancy
    return {f"flash_bwd_{kernel}_bf16_dh{head_dim}": _occupancy(fn, int(kernel == "dq"), head_dim)
            for kernel in ("dkdv", "dq") for head_dim in SUPPORTED_HEAD_DIMS}


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


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  valid: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention forward with its logsumexp: (out [B, H, N, Dh], lse [B, H, N]).

    CPU tensors take ``flash_forward_reference``. CUDA tensors launch the
    kernel on the current stream, or raise (no fallback): bf16 operands must
    be 16-byte aligned (``cuda_kernels.misaligned_operands``). ``out`` is a
    [B, H, N, Dh] view of a [B, N, H, Dh] buffer, so merging the heads
    afterwards costs no copy."""
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, valid)
    _check_inputs(q, k, v, valid)
    B, H, N, Dh = q.shape
    return launch_forward_kernel(forward_kernel(q.dtype, Dh, N), q, k, v, valid)


def launch_forward_kernel(kernel: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          valid: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch one forward kernel, "flash_fwd" or "flash_fwd_ws" (bf16 at head
    dim 64 only), on the current stream: (out, lse) as ``flash_forward``.
    Counts ``LAUNCHES["flash_fwd"]``, and ``["flash_fwd_ws"]`` for the
    warp-specialised one. The operands are those ``flash_forward`` checked;
    tests and chip_smoke.py call this directly to hold the two designs
    against each other at one shape."""
    B, H, N, Dh = q.shape
    out = torch.empty((B, N, H, Dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    if q.dtype == torch.bfloat16:
        ck.require_aligned("flash_forward", q=q, k=k, v=v, out=out)
    lib = ck.library("flash_fwd", _declare_forward)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    err = lib.flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if valid is None else valid.data_ptr(),
        out.data_ptr(), lse.data_ptr(), q.device.index or 0,
        B, H, N, Dh, _DTYPE_CODE[q.dtype], _DESIGN[kernel], *strides,
        1.0 / (Dh ** 0.5), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed with CUDA error {err}")
    ck.LAUNCHES["flash_fwd"] += 1
    if kernel != "flash_fwd":
        ck.LAUNCHES[kernel] += 1
    return out, lse


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
        ck.require_aligned("flash_backward", q=q, k=k, v=v, dout=dout)
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
    count the launch (``LAUNCHES["flash_bwd_dkdv"]`` / ``["flash_bwd_dq"]``). It
    writes its grads into `grads` [B, N, 3, H, Dh] (q, k, v along axis 2).
    The operands are those ``flash_backward`` checked; chip_smoke.py calls
    this directly to time each kernel alone."""
    B, H, N, Dh = q.shape
    views = [grads[:, :, i].transpose(1, 2) for i in range(3)]
    if q.dtype == torch.bfloat16:
        ck.require_aligned("flash_backward", dq=views[0], dk=views[1], dv=views[2])
    strides = (ctypes.c_longlong * 21)(
        *(s for t in (q, k, v, dout, *views) for s in t.stride()[:3]))
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
           delta.data_ptr(), None if valid is None else valid.data_ptr())
    outs = ((views[1].data_ptr(), views[2].data_ptr()) if kernel == "dkdv"
            else (views[0].data_ptr(),))
    fn = getattr(ck.library("flash_bwd", _declare_backward), f"flash_bwd_{kernel}")
    err = fn(*ins, *outs, q.device.index or 0, B, H, N, Dh, _DTYPE_CODE[q.dtype], strides,
             1.0 / (Dh ** 0.5), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd_{kernel} launch failed with CUDA error {err}")
    ck.LAUNCHES[f"flash_bwd_{kernel}"] += 1


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
                                    and ck.misaligned_operands(dout=dout)):
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
