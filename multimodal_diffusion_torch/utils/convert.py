"""Carry weights between the JAX package and the port.

``jax_params_to_state_dict`` takes a JAX ``params`` tree (nested mapping of
numpy-convertible arrays or tensors) and returns the port's ``state_dict``:

  * Dense kernel  [in, out]              -> weight [out, in]
  * Conv1d kernel [k, in, out]           -> weight [out, in, k]
  * Conv2d kernel [kh, kw, in, out]      -> weight [out, in, kh, kw]
  * Conv3d kernel [kt, kh, kw, in, out]  -> weight [out, in, kt, kh, kw]
  * norm ``scale`` -> ``weight``; biases and embedding tables unchanged.

Module paths follow the JAX tree, except flax's automatic names and
numbered siblings. Automatic names: ``RMSNorm_0`` ... inside an MMDiT block
(a ``block_i`` of any ``core``: the denoiser's and the text encoder's) become
``norm1``/``norm2``, and inside an ImageVAE ResBlock (``enc_0_0``,
``dec_mid`` ...) ``GroupNorm_i`` and ``Conv_i`` become ``norm{i+1}`` and
``conv{i+1}``; other norms become ``norm``, ``Conv_0`` ``conv``, ``Dense_i``
``fc{i+1}`` and ``Embed_0`` ``token_embed``. Numbered siblings become list
entries (``block_3`` -> ``blocks.3``, ``enc_0`` -> ``enc.0``, ``shared_1`` ->
``shared.1``). The flagship's leaves
need no rule of their own: ``vid_vae/patch_embed`` and ``unpatch_proj`` are
Dense kernels, ``patch_norm`` a norm, ``adapt_m/proj`` an adapter like its
siblings, ``embed/pos_m`` three position tables, and the modality table
simply has a third row. Nor do PixelDiT's (``adapter/proj``, ``pos/table``,
``core``, ``head/block_0``, ``head/out``) or the variational VideoVAE's
``to_mu`` / ``to_logv`` (1x1 Conv3d kernels).

``state_dict_to_jax_params`` is the exact inverse (bit for bit): the port's
keys back to flax's names (a norm is ``GroupNorm`` inside the VideoVAE's
``enc``/``dec`` blocks and the ImageVAE's ResBlocks, ``LayerNorm`` where it
has a bias, else ``RMSNorm``;
``fc{k}`` is flax's ``Dense_{k-1}`` except in an MLP, where flax names it
``fc{k}`` too; a 1-D ``weight`` is a ``scale``, any other a ``kernel``), and
each kernel back to the JAX layout.

A layout over ranks cuts the same state_dict: a rank's tensor-parallel
part of each parameter (the qkv and fc1 rows, the attention out and fc2
columns of every core block) is ``parallel/sharding.py``'s ``tp_slice`` /
``tp_unslice`` by name, and the model cuts it as it loads;
``pipeline_stage_state_dict`` takes a pipeline stage's blocks (renumbered
from 0, as the JAX package's per-stage trees ``{block_i}``) and
``pipeline_gather_state_dicts`` joins the stages back. The fused qkv's part
is whole heads of q, k and v: the JAX package stores that kernel split into
contiguous column blocks instead (its XLA program moves what each device
needs), so only the other three projections' parts equal a JAX device's
shard.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn


_NORM = re.compile(r"(RMSNorm|LayerNorm|GroupNorm)_(\d+)")
_DENSE = re.compile(r"Dense_(\d+)")
_LISTED = re.compile(r"(block|enc|dec|shared)_(\d+)")
_RESBLOCK = re.compile(r"(enc|dec)_(\d+_\d+|mid)")  # an ImageVAE ResBlock2D
_CONV = re.compile(r"Conv_(\d+)")


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
        in_core_block = (i >= 2 and path[i - 2] == "core"
                         and re.fullmatch(r"block_\d+", parent))
        numbered = in_core_block or _RESBLOCK.fullmatch(parent)
        if m := _NORM.fullmatch(name):
            parts.append(f"norm{int(m[2]) + 1}" if numbered else "norm")
        elif (m := _CONV.fullmatch(name)) and numbered:
            parts.append(f"conv{int(m[1]) + 1}")
        elif name == "Conv_0":
            parts.append("conv")
        elif name == "Embed_0":
            parts.append("token_embed")
        elif m := _DENSE.fullmatch(name):
            parts.append(f"fc{int(m[1]) + 1}")
        elif m := _LISTED.fullmatch(name):
            parts.append(f"{'blocks' if m[1] == 'block' else m[1]}.{m[2]}")
        else:
            parts.append(name)
    leaf = path[-1]
    parts.append("weight" if leaf in ("kernel", "scale") else leaf)
    return ".".join(parts)


# JAX kernel axes -> torch weight axes, by kernel rank: Dense [in, out],
# Conv1d [k, in, out], Conv2d [kh, kw, in, out], Conv3d [kt, kh, kw, in, out]
_TO_TORCH = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}
_TO_JAX = {2: (1, 0), 3: (2, 1, 0), 4: (2, 3, 1, 0), 5: (2, 3, 4, 1, 0)}


def _permute(leaf: str, t: torch.Tensor, perms: Dict[int, Tuple[int, ...]]) -> torch.Tensor:
    if leaf != "kernel":
        return t
    if t.ndim not in perms:
        raise ValueError(f"no layout for a {t.ndim}-D kernel")
    return t.permute(perms[t.ndim])


def _tensor(value) -> torch.Tensor:
    """A CPU tensor of a leaf in its own dtype (numpy bfloat16 included)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    a = np.asarray(value)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a.view(np.uint16))).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def jax_params_to_state_dict(params: Mapping, dtype: Optional[torch.dtype] = torch.float32
                             ) -> Dict[str, torch.Tensor]:
    """Convert every leaf of a JAX params tree (or of a tree of the same
    layout, such as Adam moments) to `dtype` (None: each leaf's own); each
    leaf maps to exactly one key (a collision raises)."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _leaves(params):
        key = torch_key(path)
        if key in out:
            raise ValueError(f"two JAX leaves map to {key!r} (second: {'/'.join(path)})")
        t = _tensor(value)
        t = _permute(path[-1], t if dtype is None else t.to(dtype), _TO_TORCH)
        out[key] = t.contiguous().clone()  # own, writable copy
    return out


def _norm_kind(sd: Mapping[str, torch.Tensor], module: str, parent: str) -> str:
    if re.fullmatch(r"(enc|dec)\.\d+", parent) and module.startswith("vid_vae."):
        return "GroupNorm"
    if _RESBLOCK.fullmatch(parent.split(".")[-1]):
        return "GroupNorm"
    return "LayerNorm" if f"{module}.bias" in sd else "RMSNorm"


def _jax_path(key: str, sd: Mapping[str, torch.Tensor]) -> Tuple[str, ...]:
    """The port's state_dict key -> the JAX parameter path (the inverse of
    torch_key; `sd` tells a LayerNorm from an RMSNorm by its bias, and a
    norm's 1-D ``weight`` (flax ``scale``) from a kernel by its rank)."""
    parts = key.split(".")
    path, i = [], 0
    while i < len(parts) - 1:
        name = parts[i]
        nxt = parts[i + 1] if i + 1 < len(parts) - 1 else None
        if name in ("blocks", "enc", "dec", "shared") and nxt is not None and nxt.isdigit():
            path.append(f"{'block' if name == 'blocks' else name}_{nxt}")
            i += 2
            continue
        if m := re.fullmatch(r"norm(\d*)", name):
            module = ".".join(parts[:i + 1])
            parent = ".".join(parts[max(0, i - 2):i])
            path.append(f"{_norm_kind(sd, module, parent)}_{int(m[1]) - 1 if m[1] else 0}")
        elif m := re.fullmatch(r"conv(\d*)", name):
            path.append(f"Conv_{int(m[1]) - 1 if m[1] else 0}")
        elif name == "token_embed":
            path.append("Embed_0")
        elif (m := re.fullmatch(r"fc(\d+)", name)) and (i == 0 or parts[i - 1] != "mlp"):
            path.append(f"Dense_{int(m[1]) - 1}")
        else:
            path.append(name)
        i += 1
    leaf = parts[-1]
    if leaf == "weight":
        leaf = "kernel" if sd[key].ndim >= 2 else "scale"
    return tuple(path) + (leaf,)


def state_dict_to_jax_params(sd: Mapping[str, torch.Tensor]) -> Dict[str, object]:
    """The port's state_dict -> the JAX package's nested params tree of
    numpy arrays (bfloat16 tensors become uint16 words); the exact inverse
    of jax_params_to_state_dict."""
    tree: Dict[str, object] = {}
    for key, t in sd.items():
        path = _jax_path(key, sd)
        if torch_key(path) != key:
            raise ValueError(f"{key!r} has no JAX path ({'/'.join(path)} maps back to "
                             f"{torch_key(path)!r})")
        a = _permute(path[-1], t.detach().cpu(), _TO_JAX).contiguous()
        a = a.view(torch.uint16) if a.dtype == torch.bfloat16 else a
        node = tree
        for name in path[:-1]:
            node = node.setdefault(name, {})
        if path[-1] in node:
            raise ValueError(f"two keys map to {'/'.join(path)}")
        node[path[-1]] = a.numpy().copy()
    return tree


def load_jax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Load a JAX params tree into `model` (strict: every key on both sides)."""
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return model


_BLOCK = re.compile(r"^(.*?blocks\.)(\d+)(\..*)$")


def pipeline_stage_state_dict(sd: Mapping[str, torch.Tensor], n_stages: int, stage: int,
                              prefix: str = "core.") -> Dict[str, torch.Tensor]:
    """The blocks of `stage` (of n_stages contiguous stages) of the MMDiT
    core under `prefix`, renumbered from 0."""
    n_layers = len({m[2] for k in sd if k.startswith(prefix) and (m := _BLOCK.match(k))})
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers not divisible into {n_stages} stages")
    k = n_layers // n_stages
    out = {}
    for key, v in sd.items():
        m = _BLOCK.match(key)
        if key.startswith(prefix) and m and stage * k <= int(m[2]) < (stage + 1) * k:
            out[f"{m[1]}{int(m[2]) - stage * k}{m[3]}"] = v
    return out


def pipeline_gather_state_dicts(stages: Sequence[Mapping[str, torch.Tensor]],
                                rest: Mapping[str, torch.Tensor], prefix: str = "core."
                                ) -> Dict[str, torch.Tensor]:
    """Every stage's blocks renumbered back into place, beside `rest` (the
    parameters outside the blocks)."""
    out = {k: v for k, v in rest.items() if not (k.startswith(prefix) and _BLOCK.match(k))}
    for s, sd in enumerate(stages):
        k = len({_BLOCK.match(key)[2] for key in sd})
        for key, v in sd.items():
            m = _BLOCK.match(key)
            out[f"{m[1]}{int(m[2]) + s * k}{m[3]}"] = v
    return out
