"""Write a port checkpoint's weights as the JAX package's params tree, one
``.npz`` with ``/``-joined paths (``core/block_0/attn/qkv/kernel``), so a
model trained with the port samples in the JAX package:

    python -m multimodal_diffusion_torch.tools.export_jax_params \\
        --ckpt runs/x/checkpoints[/<step>|/latest] --out params.npz [--ema]

``--ckpt`` is a directory of the port's checkpoints (``train/checkpoint.py``)
or one step of it. The weights go through
``utils/convert.py::state_dict_to_jax_params`` (bit for bit the inverse of
the import). On the JAX side::

    tree = {}
    for path, a in np.load("params.npz").items():
        node = tree
        for k in path.split("/")[:-1]:
            node = node.setdefault(k, {})
        node[path.split("/")[-1]] = a

is the ``params`` of ``AVDiffusionModel.apply``. Orbax output is out of
scope: it needs tensorstore, which the card's machine does not have.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, Mapping

import numpy as np
import torch

from ..infer.sample_clip import split_checkpoint_path
from ..train.checkpoint import CheckpointManager, params_only_tree
from ..utils.convert import state_dict_to_jax_params


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested params tree -> {'a/b/leaf': array}."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten(v, path + "/"))
        else:
            out[path] = v
    return out


def export_params(state_dict: Mapping[str, torch.Tensor], out) -> Dict[str, np.ndarray]:
    """Write `state_dict` as the JAX params tree to the .npz `out`; returns
    the flat arrays written."""
    flat = flatten(state_dict_to_jax_params(state_dict))
    np.savez(out, **flat)
    return flat


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", type=Path, required=True,
                    help="the port's checkpoint directory, <dir>/<step> or <dir>/latest")
    ap.add_argument("--out", type=Path, required=True, help="output .npz")
    ap.add_argument("--ema", action="store_true", help="export the EMA weights")
    args = ap.parse_args(argv)

    ckpt_dir, step = split_checkpoint_path(args.ckpt)
    mgr = CheckpointManager(ckpt_dir)
    step = step if step is not None else mgr.latest_step()
    if step is None:
        raise SystemExit(f"no checkpoints under {ckpt_dir}")
    flat = export_params(params_only_tree(mgr.restore(step), use_ema=args.ema), args.out)
    print(f"[ok] step {step}: {len(flat)} arrays -> {args.out}")


if __name__ == "__main__":
    main()
