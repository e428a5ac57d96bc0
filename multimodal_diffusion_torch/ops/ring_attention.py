"""Ring attention: context-parallel attention over a process group
(counterpart of the JAX ``ops/ring_attention.py``).

Each rank of the context group holds one contiguous shard of the sequence:
its queries stay put while the K/V shards (and their key-validity rows)
travel the ring, each rank folding every block it sees into its output. No
rank ever holds the whole sequence's scores.

  * ``impl="einsum"`` — the JAX package's ``_ring_attention_local``: fp32
    online softmax over one [Nl, Nl] score block per ring step, plain
    PyTorch, differentiable through ``parallel/comm.py::ring_shift``;
  * ``impl="flash"`` — ``_ring_flash_fwd_core`` and its replayed backward:
    the flash forward kernel on each block, the per-block (out_i, lse_i)
    merged in fp32 by log-sum-exp algebra; the backward replays the ring
    through the flash backward kernels with the GLOBAL lse and
    D = rowsum(dO * O), accumulating dq locally while each block's dk/dv
    accumulators travel with it back home. On CUDA tensors the kernels
    launch (or raise), on CPU tensors their plain versions run.

``ring_attention_local`` takes this rank's shards; ``ring_attention_sharded``
takes the whole [B, H, N, Dh] on every rank of the group (as the JAX entry
point takes a global array), runs the ring on this rank's shard and returns
the whole output. A query row with no valid key anywhere gives exact zeros,
and zero grads.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..parallel import comm
from .flash_attention import NEG_SENTINEL, flash_backward, flash_forward

IMPLS = ("einsum", "flash")


def _exchange(group, members, *tensors):
    """One ring step for tensors that carry no gradient (None passes)."""
    live = [t for t in tensors if t is not None]
    moved = iter(comm.ring_exchange(live, group, members))
    return [None if t is None else next(moved) for t in tensors]


def _einsum_ring(q, k, v, kv_valid, group, members):
    """The einsum body: fp32 scores, a -1e30 fill for masked keys (the
    explicit product with the validity row is what zeroes them), running
    max, sum and accumulator."""
    n = comm.group_size(group)
    qf = q.float() / math.sqrt(q.shape[-1])
    m = torch.full(q.shape[:-1] + (1,), -math.inf, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    k_cur, v_cur, valid = k, v, kv_valid
    for step in range(n):
        s = torch.einsum("bhnd,bhmd->bhnm", qf, k_cur.float())
        vb = valid[:, None, None, :]
        s = torch.where(vb, s, NEG_SENTINEL)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new) * vb
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhnm,bhmd->bhnd", p, v_cur.float())
        m = m_new
        if step < n - 1:
            k_cur, v_cur = comm.ring_shift([k_cur, v_cur], group, members)
            (valid,) = _exchange(group, members, valid)
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def _flash_ring_forward(q, k, v, kv_valid, group, members):
    """Per ring step the flash forward on the current block; merge by
    lse_total = logaddexp(lse, lse_i), weights exp(lse - lse_total), with
    both weights 0 while lse_total is -inf. Returns (out, lse_total [B, H,
    Nl] fp32, contiguous)."""
    n = comm.group_size(group)
    lse = torch.full(q.shape[:-1], -math.inf, device=q.device)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    k_cur, v_cur, valid = k, v, kv_valid
    for step in range(n):
        out_i, lse_i = flash_forward(q, k_cur, v_cur, valid)
        lse_new = torch.logaddexp(lse, lse_i)
        dead = torch.isneginf(lse_new)
        w_old = torch.where(dead, 0.0, torch.exp(lse - lse_new))
        w_new = torch.where(dead, 0.0, torch.exp(lse_i - lse_new))
        acc = acc * w_old[..., None] + out_i.float() * w_new[..., None]
        lse = lse_new
        if step < n - 1:
            k_cur, v_cur, valid = _exchange(group, members, k_cur, v_cur, valid)
    return acc.to(q.dtype), lse.contiguous()


class _FlashRing(torch.autograd.Function):
    """The flash ring with its ring-replaying backward (the JAX custom_vjp
    pair ``_ring_flash_vjp_fwd`` / ``_ring_flash_vjp_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid, group, members):
        out, lse = _flash_ring_forward(q, k, v, kv_valid, group, members)
        ctx.group, ctx.members = group, members
        ctx.save_for_backward(q, k, v, kv_valid, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_valid, out, lse = ctx.saved_tensors
        group, members = ctx.group, ctx.members
        n = comm.group_size(group)
        dout = dout.contiguous()
        delta = (dout.float() * out.float()).sum(dim=-1).contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        k_cur, v_cur, valid = k, v, kv_valid
        for step in range(n):
            dq_i, dk_i, dv_i = flash_backward(q, k_cur, v_cur, out, lse, dout, valid, delta)
            dq += dq_i.float()
            dk += dk_i.float()
            dv += dv_i.float()
            # dk/dv travel WITH their block: after n hops each is home,
            # holding every rank's query contributions
            if step < n - 1:
                k_cur, v_cur, valid, dk, dv = _exchange(group, members, k_cur, v_cur,
                                                        valid, dk, dv)
            else:
                dk, dv = _exchange(group, members, dk, dv)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         group, members, kv_valid: Optional[torch.Tensor] = None,
                         impl: str = "einsum") -> torch.Tensor:
    """Attention of this rank's query shard [B, H, Nl, Dh] over the whole
    sequence, whose K/V shards circle `group` (`members`: its global ranks
    in ring order). kv_valid: this rank's [B, Nl] bool key-validity shard
    (True = real key), None for all valid. Differentiable."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be einsum|flash, got {impl!r}")
    B, _, Nl, _ = q.shape
    if kv_valid is not None and tuple(kv_valid.shape) != (B, Nl):
        raise ValueError(f"kv_valid shape {tuple(kv_valid.shape)} != (B, Nl) = {(B, Nl)}")
    if impl == "einsum":
        if kv_valid is None:
            kv_valid = torch.ones((B, Nl), dtype=torch.bool, device=q.device)
        return _einsum_ring(q, k, v, kv_valid, group, members)
    if kv_valid is not None:
        kv_valid = kv_valid.contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashRing.apply(q, k, v, kv_valid, group, members)
    return _flash_ring_forward(q, k, v, kv_valid, group, members)[0]


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                           axis: str = "context", kv_valid: Optional[torch.Tensor] = None,
                           impl: str = "einsum") -> torch.Tensor:
    """Sequence-parallel attention over [B, H, N, Dh] held whole by every rank
    of `mesh`'s `axis`: each rank takes its N / n shard, runs the ring and
    the shards are gathered back, so every rank returns the whole output
    (and, in the backward pass, the whole gradient). N must divide by the
    axis size; kv_valid [B, N] bool (True = real key) or None."""
    n = mesh.size(axis)
    B, _, N, _ = q.shape
    if N % n:
        raise ValueError(f"sequence {N} not divisible by {axis}={n}")
    if kv_valid is not None and tuple(kv_valid.shape) != (B, N):
        raise ValueError(f"kv_valid shape {tuple(kv_valid.shape)} != (B, N) = {(B, N)}")
    if impl not in IMPLS:
        raise ValueError(f"impl must be einsum|flash, got {impl!r}")
    group = mesh.group(axis)
    q, k, v = (comm.scatter_to_group(t, group, 2) for t in (q, k, v))
    if kv_valid is not None and group is not None:
        Nl = N // n
        kv_valid = kv_valid[:, mesh.index(axis) * Nl:(mesh.index(axis) + 1) * Nl]
    out = ring_attention_local(q, k, v, group, mesh.members(axis), kv_valid, impl)
    return comm.gather_from_group(out, group, 2)
