"""A mesh of process groups (counterpart of the JAX ``parallel/mesh.py``).

JAX lays its devices out in one process as a ``Mesh`` with named axes. Here
one rank is one device (PyTorch's idiom): the mesh is a layout of
``torch.distributed`` process groups over ``WORLD_SIZE`` ranks, with the
same axes and the same order. Rank r sits where device r sits in
``np.arange(world)[:prod].reshape([data, model, (context), (pipe)])``.

  'data'    — batch (data parallel): each rank takes its rows of the global
              batch; gradients are summed over the group.
  'model'   — tensor parallel: attention heads and the MLP hidden dimension
              of the MMDiT core are split over the group (``LOGICAL_RULES``).
  'context' — sequence parallel (``parallel.context``): the core keeps the
              token axis split over the group and attention runs as a ring
              (``ops/ring_attention.py``).
  'pipe'    — pipeline parallel (``parallel.pipe``): contiguous layer groups
              of the core are GPipe stages (``parallel/pipeline.py``).

With one process every size is 1, no group exists and every code path is
the single-device one.
"""

from __future__ import annotations

import itertools
import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

# logical axis name -> mesh axis name (None = replicated)
LOGICAL_RULES = (
    ("batch", "data"),
    ("seq", None),
    ("embed", None),
    ("heads", "model"),
    ("mlp", "model"),
    ("kv", None),
)


class Mesh:
    """A layout of ranks over named axes: ``shape`` (axis -> size, as
    ``jax.sharding.Mesh.shape``), ``axis_names``, this rank's ``coords`` and
    one process group per axis of size > 1 holding the ranks that differ
    from this one only along it (``group``; ``members`` lists their global
    ranks in axis order). A rank outside a mesh smaller than the world has
    no coordinates and takes no part in it (``active`` is False)."""

    def __init__(self, shape: Dict[str, int], rank: int,
                 groups: Dict[str, object], members: Dict[str, List[int]],
                 coords: Optional[Dict[str, int]]):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.rank = rank
        self.coords = coords
        self._groups = groups
        self._members = members

    @property
    def active(self) -> bool:
        return self.coords is not None

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0) if self.coords else 0

    def group(self, axis: str):
        """The process group along `axis`; None when the axis has size 1."""
        return self._groups.get(axis)

    def members(self, axis: str) -> List[int]:
        return self._members.get(axis, [self.rank])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"


def world_size_and_rank():
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(data: int = -1, model: int = 1, context: int = 1, pipe: int = 1,
              world: Optional[int] = None, rank: Optional[int] = None) -> Mesh:
    """Lay `world` ranks (default: the initialized process group's, else 1)
    out as a ('data', 'model') mesh, with a 'context' axis when context > 1
    and a 'pipe' axis when pipe > 1. data = -1 takes the ranks the other
    axes leave. Raises ValueError when the world does not divide or the
    layout needs more ranks than there are, as the JAX ``make_mesh`` does.

    Process groups are made only when torch.distributed is initialized and
    the world is that group's; every rank must then call this with the same
    arguments (new_group is collective). A given `world`/`rank` without an
    initialized group lays the mesh out without groups (a test of the
    layout)."""
    init_world, init_rank = world_size_and_rank()
    n = init_world if world is None else int(world)
    rank = init_rank if rank is None else int(rank)
    model, context, pipe = (max(1, int(x)) for x in (model, context, pipe))
    rest = model * context * pipe
    if data == -1:
        if n % rest:
            raise ValueError(f"{n} devices not divisible by model*context*pipe={rest}")
        data = n // rest
    if data * rest > n:
        raise ValueError(f"mesh {data}x{model}x{context}x{pipe} needs more than {n} devices")
    shape = {"data": int(data), "model": model}
    if context > 1:
        shape["context"] = context
    if pipe > 1:
        shape["pipe"] = pipe
    arr = np.arange(int(np.prod(list(shape.values())))).reshape(list(shape.values()))
    names = list(shape)
    coords = None
    if rank < arr.size:
        coords = dict(zip(names, (int(c) for c in np.unravel_index(rank, arr.shape))))
    make_groups = dist.is_available() and dist.is_initialized() and n == init_world
    groups: Dict[str, object] = {}
    members: Dict[str, List[int]] = {}
    for ax, name in enumerate(names):
        if shape[name] == 1:
            continue
        others = [range(s) for i, s in enumerate(arr.shape) if i != ax]
        for idx in itertools.product(*others):
            sl = list(idx)
            sl.insert(ax, slice(None))
            ranks = [int(r) for r in arr[tuple(sl)]]
            # new_group is collective: every rank makes every group
            g = dist.new_group(ranks) if make_groups else None
            if rank in ranks:
                groups[name], members[name] = g, ranks
    return Mesh(shape, rank, groups, members, coords)


def make_mesh_from_config(cfg: dict, world: Optional[int] = None,
                          rank: Optional[int] = None) -> Mesh:
    par = cfg.get("parallel", {}) or {}
    return make_mesh(
        data=int(par.get("data", -1)),
        model=int(par.get("model", 1)),
        context=int(par.get("context", 1)),
        pipe=int(par.get("pipe", 1)),
        world=world, rank=rank,
    )


def init_distributed(backend: Optional[str] = None) -> bool:
    """Join the process group that a launcher such as ``torchrun`` describes
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); returns
    whether this process is one of several. `backend` defaults to ``nccl``
    with CUDA and ``gloo`` without; a caller that runs several ranks on one
    card names ``gloo`` (NCCL takes one rank per device)."""
    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if world <= 1:
        return False
    if dist.is_initialized():
        return True
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method="env://", world_size=world,
                            rank=int(os.environ["RANK"]))
    return True


def local_device(device="cuda") -> torch.device:
    """This rank's device: card ``LOCAL_RANK`` modulo the cards present for
    CUDA (several ranks share a card when there are fewer cards), the CPU
    otherwise."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", "0") or 0)
        return torch.device("cuda", local % torch.cuda.device_count())
    return dev


def is_lead() -> bool:
    return world_size_and_rank()[1] == 0
