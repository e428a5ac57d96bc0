"""The collectives the layouts need, and their autograd pairs.

Four transfers: a sum over a group (``all_reduce_``; its maximum,
``all_reduce_max_``; ``sum_over`` for a list), a concatenation along
a dimension (``all_gather``), a broadcast (``broadcast_``; ``broadcast_over``
for a list) and the ring's
step, send to the next rank and receive from the previous one
(``ring_exchange``), plus the pipeline's one-way hop (``send`` / ``recv``).
A group of None (an axis of size 1) makes each of them the identity.

NCCL takes CUDA tensors only: a host tensor handed to an NCCL group is
refused here (``on_device``) with a ValueError. gloo has only broadcast,
all_reduce and barrier for CUDA tensors, so the other transfers of a CUDA tensor over a
gloo group go through host memory (decided by the group's backend name,
``via_host``); the kernels still run on the card, only the bytes travel
through the host. Transfers that do not add move bytes: bf16, fp16 and
bool go as uint8 (gloo's all_gather takes no 16-bit integer type either).

The autograd pairs: ``copy_to_group`` (identity forward, sum backward: the
input of a column-split projection), ``reduce_from_group`` (sum forward,
identity backward: the output of a row-split one), ``scatter_to_group``
(this rank's slice forward, gather backward) and ``gather_from_group``
(gather forward, this rank's slice backward), and ``ring_shift`` (the ring
step forward, the reverse step backward).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

_BITCAST = (torch.bfloat16, torch.float16, torch.bool)


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def via_host(t: torch.Tensor, group) -> bool:
    """Whether a transfer of `t` other than broadcast or all_reduce goes
    through host memory: a CUDA tensor over a gloo group."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def on_device(t: torch.Tensor, group) -> torch.Tensor:
    """`t`, after checking that `group` can take it: an NCCL group takes
    CUDA tensors only (gloo takes either)."""
    if not t.is_cuda and dist.get_backend(group) == "nccl":
        raise ValueError(f"a {t.device} tensor of {tuple(t.shape)} reached an NCCL group, "
                         f"which takes CUDA tensors only")
    return t


def _wire(t: torch.Tensor, host: bool) -> torch.Tensor:
    """`t` as the bytes that travel: contiguous, on the host when `host`,
    bf16/fp16/bool reinterpreted as uint8 (the last dim's bytes)."""
    t = t.contiguous()
    if t.dtype in _BITCAST:
        t = t.view(torch.uint8)
    return t.cpu() if host else t


def _unwire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.dtype in _BITCAST:
        w = w.view(like.dtype)
    return w.to(like.device, non_blocking=False)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` over `group` in place (fp32 or wider, or int32, which sums
    exactly; gloo and NCCL both take CUDA tensors for this)."""
    if group is not None:
        dist.all_reduce(on_device(t, group), group=group)
    return t


def all_reduce_max_(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of `t` over `group`, in place."""
    if group is not None:
        dist.all_reduce(on_device(t, group), op=dist.ReduceOp.MAX, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's tensors concatenated along `dim` in group-rank order."""
    if group is None:
        return t
    w = _wire(on_device(t, group), via_host(t, group))
    parts = [torch.empty_like(w) for _ in range(group_size(group))]
    dist.all_gather(parts, w, group=group)
    return torch.cat([_unwire(p, t) for p in parts], dim=dim)


def broadcast_(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """Overwrite `t` with global rank `src`'s copy, in place."""
    if group is None:
        return t
    w = _wire(on_device(t, group), False)
    dist.broadcast(w, src, group=group)
    if w.data_ptr() != t.data_ptr():
        t.copy_(_unwire(w, t))
    return t


def ring_exchange(tensors: Sequence[torch.Tensor], group, members: List[int],
                  shift: int = 1) -> List[torch.Tensor]:
    """Send each tensor to the rank `shift` places further along `members`
    and receive the same-shaped tensors from the rank `shift` places back,
    all in one batch of point-to-point transfers."""
    if group is None:
        return list(tensors)
    me = members.index(dist.get_rank())
    n = len(members)
    nxt, prv = members[(me + shift) % n], members[(me - shift) % n]
    sends = [_wire(on_device(t, group), via_host(t, group)) for t in tensors]
    recvs = [torch.empty_like(w) for w in sends]
    ops = [dist.P2POp(dist.isend, w, nxt, group) for w in sends]
    ops += [dist.P2POp(dist.irecv, w, prv, group) for w in recvs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [_unwire(w, t) for w, t in zip(recvs, tensors)]


def send(t: torch.Tensor, dst: int, group) -> None:
    dist.send(_wire(on_device(t, group), via_host(t, group)), dst, group=group)


def recv(like: torch.Tensor, src: int, group) -> torch.Tensor:
    """A tensor of `like`'s shape, dtype and device from global rank `src`."""
    shape, dtype = list(on_device(like, group).shape), like.dtype
    if dtype in _BITCAST:
        shape[-1] *= like.element_size()
        dtype = torch.uint8
    w = torch.empty(shape, dtype=dtype, device="cpu" if via_host(like, group) else like.device)
    dist.recv(w, src, group=group)
    return _unwire(w, like)


# ---------------------------------------------------------------------------
# autograd pairs
# ---------------------------------------------------------------------------


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.to(torch.float32, copy=True), ctx.group).to(g.dtype), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.to(torch.float32, copy=True), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n, i = group_size(group), group_rank(group)
        size = x.shape[dim] // n
        return x.narrow(dim, i * size, size).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        n, i = group_size(ctx.group), group_rank(ctx.group)
        size = g.shape[ctx.dim] // n
        return g.narrow(ctx.dim, i * size, size).contiguous(), None, None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, members, *tensors):
        ctx.group, ctx.members = group, members
        ctx.likes = [(t.shape, t.dtype, t.device) for t in tensors]
        return tuple(ring_exchange(tensors, group, members, 1))

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros(s, dtype=d, device=dev) if g is None else g
                 for g, (s, d, dev) in zip(grads, ctx.likes)]
        return (None, None, *ring_exchange(grads, ctx.group, ctx.members, -1))


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient is summed over `group` (fp32)."""
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over `group`, in fp32; identity backward."""
    return x if group is None else _ReduceFromGroup.apply(x, group)


def scatter_to_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's equal slice of `x` along `dim`; the gradient is gathered
    back to the whole of `x` on every rank."""
    return x if group is None else _ScatterToGroup.apply(x, group, dim)


def gather_from_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's slices concatenated along `dim`; the gradient is this
    rank's slice of it."""
    return x if group is None else _GatherFromGroup.apply(x, group, dim)


def ring_shift(tensors: Sequence[torch.Tensor], group, members: List[int]
               ) -> List[torch.Tensor]:
    """Differentiable ring step: each rank's tensors go to the next rank;
    their gradients come back the other way."""
    if group is None:
        return list(tensors)
    return list(_RingShift.apply(group, members, *tensors))


def _flat_(ts: Sequence[Optional[torch.Tensor]], group, transfer) -> None:
    """`transfer` of every tensor of `ts` over `group` as one flat fp32
    tensor, copied back in place (the tensors must be fp32 and equal in
    number and shape on every rank)."""
    ts = [t for t in ts if t is not None]
    if group is None or not ts:
        return
    flat = torch.cat([t.reshape(-1) for t in ts])
    transfer(flat)
    off = 0
    for t in ts:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


def sum_over(ts: Sequence[Optional[torch.Tensor]], group) -> None:
    """Sum every tensor of `ts` over `group` in place, as one transfer."""
    _flat_(ts, group, lambda flat: all_reduce_(flat, group))


def broadcast_over(ts: Sequence[Optional[torch.Tensor]], src: int, group) -> None:
    """Overwrite every tensor of `ts` with global rank `src`'s copy, in
    place, as one transfer."""
    _flat_(ts, group, lambda flat: broadcast_(flat, src, group))
