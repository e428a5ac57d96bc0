"""Pipeline parallelism, GPipe over a mesh axis (counterpart of the JAX
``parallel/pipeline.py``).

The batch is split into M microbatches. Stage p (the rank at index p of
the pipe group) applies its contiguous blocks to each microbatch in turn:
stage 0 takes the microbatch from the input, every later stage receives it
from the stage before, and every stage but the last sends its result on, so
stage p works on microbatch m while stage p + 1 works on m - 1. The last
stage's results are broadcast over the group: every rank returns the whole
output. A key-padding mask never travels: each stage takes its microbatch's
rows of the mask, which every rank holds.

The backward pass runs the schedule in reverse inside one autograd node:
the last stage starts from the output's gradient, each stage sends its
input's gradient back to the stage before, and the gradient of the input
(nonzero on stage 0 only) is summed over the group, so every rank gets it
whole. A stage's parameters get gradients on that stage's rank only (the
trainer sums them over the group).

Parameters stay where they are, whole on every rank, as the JAX package's
core integration keeps them replicated: a pipelined core holds the same
parameters as the sequential one and checkpoints move between the two.
``stack_stage_params`` / ``unstack_stage_params`` convert between per-stage
state dicts and one with a leading stage axis (the JAX package's stacked
layout; ``utils/convert.py`` cuts a rank's stage with them).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from . import comm


def stack_stage_params(stage_params: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """[P x {name: tensor}] -> {name: tensor with a leading n_stages axis}."""
    return {k: torch.stack([sp[k] for sp in stage_params]) for k in stage_params[0]}


def unstack_stage_params(stacked: Dict[str, torch.Tensor], n_stages: int
                         ) -> List[Dict[str, torch.Tensor]]:
    return [{k: v[i] for k, v in stacked.items()} for i in range(n_stages)]


class _Schedule:
    """One call's schedule: the stage function, the group and this rank's
    place in it, the microbatch count."""

    def __init__(self, stage_fn, mesh, axis: str, n_microbatches: int):
        self.stage_fn = stage_fn
        self.group = mesh.group(axis)
        self.members = mesh.members(axis)
        self.p, self.P = mesh.index(axis), mesh.size(axis)
        self.M = n_microbatches

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor], keep_graph: bool):
        """Returns (output, [(stage input, stage output)] per microbatch when
        keep_graph)."""
        p, P, M = self.p, self.P, self.M
        mb = x.shape[0] // M
        outs, saved = [], []
        for m in range(M):
            rows = slice(m * mb, (m + 1) * mb)
            h = x[rows] if p == 0 else comm.recv(x[rows], self.members[p - 1], self.group)
            mask_m = None if mask is None else mask[rows]
            if keep_graph:
                h = h.detach().requires_grad_(True)
                with torch.enable_grad():
                    y = self.stage_fn(h, mask_m)
                saved.append((h, y))
            else:
                y = self.stage_fn(h, mask_m)
            if p < P - 1:
                comm.send(y.detach(), self.members[p + 1], self.group)
            outs.append(y.detach())
        out = torch.cat(outs) if p == P - 1 else torch.empty_like(x)
        return comm.broadcast_(out, self.members[-1], self.group), saved


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched, x, mask, *params):
        out, ctx.saved = sched.forward(x, mask, keep_graph=True)
        ctx.sched, ctx.n_params = sched, len(params)
        ctx.params = params
        return out

    @staticmethod
    def backward(ctx, dout):
        s = ctx.sched
        params = [t for t in ctx.params if t.requires_grad]
        grads = {id(t): None for t in params}
        mb = dout.shape[0] // s.M
        dxs = []
        for m, (h, y) in enumerate(ctx.saved):
            rows = slice(m * mb, (m + 1) * mb)
            dy = (dout[rows].contiguous() if s.p == s.P - 1
                  else comm.recv(y, s.members[s.p + 1], s.group))
            gs = torch.autograd.grad(y, [h] + params, dy, allow_unused=True)
            if s.p > 0:
                comm.send(gs[0], s.members[s.p - 1], s.group)
            else:
                dxs.append(gs[0])
            for t, g in zip(params, gs[1:]):
                if g is not None:
                    grads[id(t)] = g if grads[id(t)] is None else grads[id(t)] + g
        ctx.saved = None
        dx = torch.cat(dxs).float() if s.p == 0 else torch.zeros(dout.shape, device=dout.device)
        dx = comm.all_reduce_(dx, s.group).to(dout.dtype)
        return (None, dx, None,
                *(grads.get(id(t)) if t.requires_grad else None for t in ctx.params))


def pipeline_apply(stage_fn: Callable[[torch.Tensor, Optional[torch.Tensor]], torch.Tensor],
                   params: Sequence[torch.Tensor], x: torch.Tensor, mesh, axis: str = "pipe",
                   n_microbatches: int = 4,
                   key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run `x` [B, ...] through the pipeline's stages; stage_fn(h, mask) is
    THIS rank's stage (shape-preserving, mask None or the microbatch's
    [b, N] rows, True = PAD) and `params` the tensors it differentiates.
    B must divide by n_microbatches. Differentiable in `x` and `params`;
    without grad the schedule runs without keeping a graph."""
    B = x.shape[0]
    if B % n_microbatches:
        raise ValueError(f"batch {B} not divisible by {n_microbatches}")
    if key_padding_mask is not None and key_padding_mask.shape[0] != B:
        raise ValueError(f"key_padding_mask batch {key_padding_mask.shape[0]} != {B}")
    sched = _Schedule(stage_fn, mesh, axis, n_microbatches)
    params = list(params)
    if torch.is_grad_enabled() and (x.requires_grad or any(t.requires_grad for t in params)):
        return _GPipe.apply(sched, x, key_padding_mask, *params)
    return sched.forward(x, key_padding_mask, keep_graph=False)[0]


def stage_blocks(core, mesh, axis: str) -> Tuple[Callable, List[torch.Tensor]]:
    """This rank's stage of an MMDiT core: blocks [s k, (s + 1) k) with
    k = n_layers / n_stages, as (stage_fn, its parameters)."""
    n_stages = mesh.size(axis)
    n_layers = len(core.blocks)
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers not divisible into {n_stages} pipeline stages")
    k = n_layers // n_stages
    s = mesh.index(axis)
    blocks = list(core.blocks[s * k:(s + 1) * k])

    def stage_fn(h, mask):
        for blk in blocks:
            h = blk(h, mask)
        return h

    return stage_fn, [p for blk in blocks for p in blk.parameters()]


def mmdit_pipeline_apply(core, x: torch.Tensor, mesh, axis: str = "pipe",
                         n_microbatches: int = 4,
                         key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """An ordinary (sequential) MMDiT core run as a pipeline: its blocks cut
    into mesh.size(axis) contiguous stages, the final norm applied after,
    on every rank (token-local)."""
    stage_fn, params = stage_blocks(core, mesh, axis)
    h = pipeline_apply(stage_fn, params, x.to(core.cfg.dtype), mesh, axis, n_microbatches,
                       key_padding_mask)
    return core.norm(h)
