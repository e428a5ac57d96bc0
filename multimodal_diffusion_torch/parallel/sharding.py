"""Which part of a batch or a parameter a rank takes (counterpart of the JAX
``parallel/sharding.py``).

JAX annotates parameters with logical axes ('embed', 'heads', 'mlp') and
maps them onto the mesh with ``LOGICAL_RULES``; XLA then inserts the
collectives. Here ``logical_axes`` gives the same annotation for the port's
[out, in] weights, ``param_mesh_axes`` maps it onto mesh axes, and
``tp_slice`` / ``tp_unslice`` cut and rejoin a rank's tensor-parallel part.
Under ``parallel.model: n`` a rank holds only its part of each split
parameter, as each JAX device holds its shard (``models/mmdit.py``), and so
do the parameter's Adam moments and EMA shadow; ``local_shape`` gives a
part's shape, ``tp_part`` cuts a whole tensor to this rank's part (a part
passes through) and ``tp_gather`` joins the group's parts into the whole
(a checkpoint holds whole tensors):

  * qkv and fc1 split by output rows ('heads' / 'mlp'; the fused qkv's
    rows are q, k and v, each split alike so a rank takes whole heads);
  * attention out and fc2 split by input columns, their bias replicated;
  * everything else replicated.

``shard_batch`` takes a rank's rows of the global batch along 'data'.
"""

from __future__ import annotations

import math
import re
from typing import Any, Iterable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from . import comm
from .mesh import LOGICAL_RULES

_CORE_LEAF = re.compile(r"(?:^|\.)blocks\.\d+\.(attn\.qkv|attn\.out|mlp\.fc1|mlp\.fc2)\.(weight|bias)$")
_LOGICAL = {
    ("attn.qkv", "weight"): ("heads", "embed"), ("attn.qkv", "bias"): ("heads",),
    ("attn.out", "weight"): ("embed", "heads"), ("attn.out", "bias"): ("embed",),
    ("mlp.fc1", "weight"): ("mlp", "embed"), ("mlp.fc1", "bias"): ("mlp",),
    ("mlp.fc2", "weight"): ("embed", "mlp"), ("mlp.fc2", "bias"): ("embed",),
}


def logical_axes(name: str) -> Optional[Tuple[str, ...]]:
    """The logical axes of an MMDiT block's projection parameter, dim by dim
    ([out, in] for a weight); None for a parameter JAX leaves unannotated
    or annotates 'embed' only (replicated either way)."""
    m = _CORE_LEAF.search(name)
    return None if m is None else _LOGICAL[(m[1], m[2])]


def param_mesh_axes(name: str) -> Tuple[Optional[str], ...]:
    """`name`'s dims mapped onto mesh axes by LOGICAL_RULES (None =
    replicated along that dim); () for a replicated parameter."""
    rules = dict(LOGICAL_RULES)
    return tuple(rules.get(a) for a in (logical_axes(name) or ()))


def is_split(name: str, axis: str = "model") -> bool:
    return axis in param_mesh_axes(name)


def _groups(name: str) -> int:
    return 3 if ".attn.qkv." in name else 1


def split_part(t: torch.Tensor, dim: int, groups: int, n: int, i: int) -> torch.Tensor:
    """Part i of n of each of `groups` equal blocks of `t` along `dim`,
    concatenated (groups = 3 for the fused qkv's q, k and v rows)."""
    shape = list(t.shape)
    parts = t.reshape(shape[:dim] + [groups, n, shape[dim] // (groups * n)] + shape[dim + 1:])
    return parts.select(dim + 1, i).reshape(shape[:dim] + [shape[dim] // n] + shape[dim + 1:])


def tp_slice(name: str, t: torch.Tensor, n: int, i: int) -> torch.Tensor:
    """Rank i of n's part of parameter `name` (the whole tensor when it is
    not split over 'model')."""
    axes = param_mesh_axes(name)
    if n == 1 or "model" not in axes:
        return t
    return split_part(t, axes.index("model"), _groups(name), n, i)


def tp_unslice(name: str, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The whole parameter from every rank's part, in rank order (inverse of
    tp_slice)."""
    axes = param_mesh_axes(name)
    n = len(parts)
    if n == 1 or "model" not in axes:
        return parts[0]
    dim = axes.index("model")
    g = _groups(name)
    shape = list(parts[0].shape)
    split = [p.reshape(shape[:dim] + [g, 1, shape[dim] // g] + shape[dim + 1:]) for p in parts]
    whole = torch.cat(split, dim=dim + 1)
    return whole.reshape(shape[:dim] + [shape[dim] * n] + shape[dim + 1:])


def local_shape(name: str, whole_shape: Sequence[int], n: int) -> Tuple[int, ...]:
    """The shape of one rank's part of parameter `name` of `whole_shape`
    over a 'model' group of n (the whole shape when it is not split)."""
    shape = list(whole_shape)
    axes = param_mesh_axes(name)
    if n > 1 and "model" in axes:
        dim = axes.index("model")
        if shape[dim] % (_groups(name) * n):
            raise ValueError(f"{name}: {shape[dim]} rows do not split into {n} parts")
        shape[dim] //= n
    return tuple(shape)


def tp_part(name: str, t: torch.Tensor, part_shape: Sequence[int], n: int,
            i: int) -> torch.Tensor:
    """Rank i of n's part of parameter `name`, of `part_shape`: `t` itself
    when it has that shape already, else `t` is the whole tensor and is cut
    by tp_slice (ValueError when it is neither)."""
    if tuple(t.shape) == tuple(part_shape):
        return t
    if local_shape(name, t.shape, n) != tuple(part_shape):
        raise ValueError(f"{name}: {tuple(t.shape)} is neither the part {tuple(part_shape)} "
                         f"nor the whole of it over {n} ranks")
    return tp_slice(name, t, n, i)


def tp_gather(name: str, part: torch.Tensor, group) -> torch.Tensor:
    """The whole parameter `name` from every rank's part over the 'model'
    `group` (all-gather, then tp_unslice; every rank of the group calls
    it). `part` itself without a group or when `name` is not split."""
    n = comm.group_size(group)
    if n == 1 or "model" not in param_mesh_axes(name):
        return part
    parts = comm.all_gather(part.unsqueeze(0), group, 0)
    return tp_unslice(name, list(parts.unbind(0)))


def _rows(x, n: int, i: int):
    b = x.shape[0] // n
    return x[i * b:(i + 1) * b]


def shard_batch(mesh, batch: Any, batch_size: Optional[int] = None) -> Any:
    """This rank's rows of a host or device batch along 'data' (a dict, list
    or single array). An array whose leading dim does not divide by the
    data size stays whole (replicated), as in the JAX package; with
    `batch_size` only arrays of exactly that leading dim are split (a
    loader that already yields this rank's rows passes through)."""
    n = 1 if mesh is None else mesh.size("data")
    if n == 1:
        return batch
    i = mesh.index("data")

    def put(x):
        if x is None or not hasattr(x, "shape") or len(x.shape) == 0:
            return x
        if batch_size is not None and x.shape[0] != batch_size:
            return x
        return _rows(x, n, i) if x.shape[0] % n == 0 else x

    if isinstance(batch, dict):
        return {k: put(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(put(v) for v in batch)
    return put(batch)


def replicated(mesh, named: Iterable[Tuple[str, torch.Tensor]]) -> None:
    """Make the named parameters equal on every rank of `mesh`: the lead
    rank's copy is broadcast over the world, in place (nothing to do for a
    mesh of one rank). Under 'model' > 1 a
    split parameter is a part that differs by rank and is left as it is."""
    if (mesh is None or math.prod(mesh.shape.values()) == 1 or not dist.is_initialized()
            or dist.get_world_size() == 1):
        return
    for name, t in named:
        if not (mesh.size("model") > 1 and is_split(name)):
            comm.broadcast_(t.data, 0, dist.group.WORLD)
