"""Carry weights from the JAX package to the port.

``jax_params_to_state_dict`` takes a JAX ``params`` tree (nested mapping of
numpy-convertible arrays) and returns the port's ``state_dict``:

  * Dense kernel  [in, out]              -> weight [out, in]
  * Conv1d kernel [k, in, out]           -> weight [out, in, k]
  * Conv3d kernel [kt, kh, kw, in, out]  -> weight [out, in, kt, kh, kw]
  * norm ``scale`` -> ``weight``; biases and embedding tables unchanged.

Module paths follow the JAX tree, except flax's automatic names
(``RMSNorm_0`` ... inside an MMDiT block become ``norm1``/``norm2``, other
norms ``norm``, ``Conv_0`` -> ``conv``, ``Dense_i`` -> ``fc{i+1}``) and
numbered siblings, which become list entries (``block_3`` -> ``blocks.3``,
``enc_0`` -> ``enc.0``, ``shared_1`` -> ``shared.1``). The flagship's leaves
need no rule of their own: ``vid_vae/patch_embed`` and ``unpatch_proj`` are
Dense kernels, ``patch_norm`` a norm, ``adapt_m/proj`` an adapter like its
siblings, ``embed/pos_m`` three position tables, and the modality table
simply has a third row.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

_NORM = re.compile(r"(RMSNorm|LayerNorm|GroupNorm)_(\d+)")
_DENSE = re.compile(r"Dense_(\d+)")
_LISTED = re.compile(r"(block|enc|dec|shared)_(\d+)")


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def torch_key(path: Tuple[str, ...]) -> str:
    """JAX parameter path -> the port's state_dict key."""
    parts = []
    for i, name in enumerate(path[:-1]):
        parent = path[i - 1] if i else ""
        if m := _NORM.fullmatch(name):
            in_core_block = path[0] == "core" and re.fullmatch(r"block_\d+", parent)
            parts.append(f"norm{int(m[2]) + 1}" if in_core_block else "norm")
        elif name == "Conv_0":
            parts.append("conv")
        elif m := _DENSE.fullmatch(name):
            parts.append(f"fc{int(m[1]) + 1}")
        elif m := _LISTED.fullmatch(name):
            parts.append(f"{'blocks' if m[1] == 'block' else m[1]}.{m[2]}")
        else:
            parts.append(name)
    leaf = path[-1]
    parts.append("weight" if leaf in ("kernel", "scale") else leaf)
    return ".".join(parts)


def _torch_layout(leaf: str, a: np.ndarray) -> np.ndarray:
    if leaf != "kernel":
        return a
    if a.ndim == 2:  # Dense [in, out]
        return a.T
    if a.ndim == 3:  # Conv1d [k, in, out]
        return a.transpose(2, 1, 0)
    if a.ndim == 5:  # Conv3d [kt, kh, kw, in, out]
        return a.transpose(4, 3, 0, 1, 2)
    raise ValueError(f"no torch layout for a {a.ndim}-D kernel")


def jax_params_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Convert every leaf of a JAX params tree; each leaf maps to exactly one
    key (a collision raises)."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _leaves(params):
        key = torch_key(path)
        if key in out:
            raise ValueError(f"two JAX leaves map to {key!r} (second: {'/'.join(path)})")
        a = _torch_layout(path[-1], np.asarray(value, dtype=np.float32))
        out[key] = torch.from_numpy(np.array(a, order="C"))  # own, writable copy
    return out


def load_jax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Load a JAX params tree into `model` (strict: every key on both sides)."""
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return model
