"""Checkpoints of the port, torch-native, with the JAX package's schema
(its ``train/checkpoint.py``): one step-numbered directory per save,

    <dir>/<step>/step.pt        int
                 params.pt      the model's state_dict (fp32)
                 opt_state.pt   AdamW count, mini-step, moments (+ accumulator)
                 ema_core.pt    EMA shadow, keyed by parameter name
                 rng.pt         the trainer's generator state

plus a JSON sidecar ``<dir>/meta_<step>.json``. ``latest_step()`` gives the
"latest" semantics, ``save`` is idempotent per step, and a directory is
renamed into place only once complete. Saves are synchronous: ``save``'s
``wait`` and the ``wait()`` / ``close()`` methods exist so that callers read
as the JAX package's (whose orbax saves run in the background), and a config
with ``training.ckpt_async: true`` gets the same files, written before
``save`` returns. Restoring the JAX package's orbax checkpoints is not
ported.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, Optional

import torch


class CheckpointManager:
    def __init__(self, ckpt_dir, max_to_keep: Optional[int] = None):
        self.dir = Path(ckpt_dir).resolve()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def all_steps(self):
        return sorted(int(p.name) for p in self.dir.iterdir()
                      if p.is_dir() and p.name.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Dict[str, Any], meta: Optional[Dict] = None,
             wait: bool = False) -> None:
        """Write each top-level entry of `tree` as <key>.pt under <dir>/<step>/
        before returning, whatever `wait` says. A step that already exists is
        skipped, not an error."""
        step = int(step)
        final = self.dir / str(step)
        if final.exists():
            return
        tmp = self.dir / f".{step}.tmp.{os.getpid()}"
        tmp.mkdir(parents=True)
        for key, value in tree.items():
            torch.save(value, tmp / f"{key}.pt")
        os.replace(tmp, final)
        if meta is not None:
            (self.dir / f"meta_{step}.json").write_text(json.dumps(meta, indent=2))
        if self.max_to_keep is not None:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self.dir / str(old))
                (self.dir / f"meta_{old}.json").unlink(missing_ok=True)

    def restore(self, step: Optional[int] = None) -> Dict[str, Any]:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = self.dir / str(int(step))
        return {p.stem: torch.load(p, map_location="cpu", weights_only=True)
                for p in sorted(path.glob("*.pt"))}

    def meta(self, step: int) -> Optional[Dict]:
        p = self.dir / f"meta_{int(step)}.json"
        return json.loads(p.read_text()) if p.exists() else None

    def wait(self) -> None:
        """Every save has finished when it returns: nothing to wait for."""

    def close(self) -> None:
        """No background writer to stop."""


def state_to_tree(state) -> Dict[str, Any]:
    """TrainState -> checkpoint tree (CPU tensors)."""
    return {
        "step": int(state.step),
        "params": {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()},
        "opt_state": state.optimizer.state_dict(),
        "ema_core": {k: v.detach().cpu().clone() for k, v in state.ema.items()},
        "rng": state.generator.get_state(),
    }


@torch.no_grad()
def restore_state(state, tree: Dict[str, Any]) -> None:
    """Load a checkpoint tree into a TrainState built by create_trainer for
    the same config, in place: the next step continues exactly."""
    state.step = int(tree["step"])
    state.model.load_state_dict(tree["params"], strict=True)
    state.optimizer.load_state_dict(tree["opt_state"])
    for k, v in state.ema.items():
        v.copy_(tree["ema_core"][k])
    state.generator.set_state(tree["rng"])


def params_only_tree(tree: Dict[str, Any], use_ema: bool = False) -> Dict[str, torch.Tensor]:
    """The inference state_dict of a checkpoint tree, with the EMA weights
    swapped in when `use_ema`: the shadow names the parameters it holds (the
    core's under `training.ema.scope: core`, all under `all`)."""
    params = dict(tree["params"])
    if use_ema and tree.get("ema_core"):
        params.update(tree["ema_core"])
    return params
