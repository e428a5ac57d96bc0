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
``save`` returns.

A checkpoint always holds whole tensors. Under ``parallel.model: n`` each
rank holds parts of the split parameters, of their moments and of their
EMA: ``state_to_tree`` gathers them over the 'model' group (every rank of
the group calls it; the lead rank writes) and ``restore_state`` cuts this
rank's parts again, so a checkpoint crosses between layouts and one
process bit for bit.

The JAX package's orbax step directories (``<dir>/<step>/default/``) are
read by ``train/orbax_reader.py``; ``restore_jax_state`` loads such a tree
into a TrainState and ``checkpoint_format`` tells the two kinds apart.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from ..parallel.sharding import tp_gather, tp_part
from ..utils.convert import jax_params_to_state_dict
from .orbax_reader import is_orbax_step


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


def _model_group(state):
    mesh = getattr(state, "mesh", None)
    return None if mesh is None else mesh.group("model")


def _tp_coords(state):
    mesh = getattr(state, "mesh", None)
    return (1, 0) if mesh is None else (mesh.size("model"), mesh.index("model"))


def _whole_cpu(named, group) -> Dict[str, torch.Tensor]:
    """CPU copies of the whole tensors of `named` (parts gathered over the
    'model' `group` where they live, then copied to the host)."""
    return {k: tp_gather(k, v.detach(), group).cpu().clone() for k, v in named.items()}


def state_to_tree(state) -> Dict[str, Any]:
    """TrainState -> checkpoint tree (CPU tensors, whole). Under
    ``parallel.model`` > 1 it gathers over the 'model' group: every rank of
    the group must call it."""
    group = _model_group(state)
    return {
        "step": int(state.step),
        "params": _whole_cpu(state.model.state_dict(), group),
        "opt_state": state.optimizer.state_dict(),
        "ema_core": _whole_cpu(state.ema, group),
        "rng": state.generator.get_state(),
    }


@torch.no_grad()
def restore_state(state, tree: Dict[str, Any]) -> None:
    """Load a checkpoint tree into a TrainState built by create_trainer for
    the same config, in place: the next step continues exactly (each rank
    keeps its part of the split parameters, moments and EMA)."""
    state.step = int(tree["step"])
    state.model.load_state_dict(tree["params"], strict=True)
    state.optimizer.load_state_dict(tree["opt_state"])
    _load_ema(state, tree["ema_core"])
    state.generator.set_state(tree["rng"])


def _load_ema(state, ema: Dict[str, torch.Tensor]) -> None:
    n, i = _tp_coords(state)
    for k, v in state.ema.items():
        v.copy_(tp_part(k, ema[k], v.shape, n, i))


def params_only_tree(tree: Dict[str, Any], use_ema: bool = False) -> Dict[str, torch.Tensor]:
    """The inference state_dict of a checkpoint tree, with the EMA weights
    swapped in when `use_ema`: the shadow names the parameters it holds (the
    core's under `training.ema.scope: core`, all under `all`)."""
    params = dict(tree["params"])
    if use_ema and tree.get("ema_core"):
        params.update(tree["ema_core"])
    return params


@torch.no_grad()
def cast_params_bf16(model: torch.nn.Module) -> torch.nn.Module:
    """Serving weights: every fp32 parameter of `model` becomes bf16, once,
    in place (the JAX package's ``cast_params_bf16`` of the params tree);
    other parameters (already bf16) and buffers pass through. Inference
    only: halves the weight traffic and makes a bf16 layer's per-use weight
    cast a no-op; layers that compute in fp32 (norms) upcast at use, as
    flax promotes. Returns `model`."""
    for p in model.parameters():
        if p.dtype == torch.float32:
            p.data = p.data.to(torch.bfloat16)
    return model


def checkpoint_format(step_dir) -> Optional[str]:
    """'port' for a step directory of this port (``params.pt``), 'jax' for
    one of the JAX package's orbax checkpoints (``default/_METADATA``),
    None otherwise."""
    step_dir = Path(step_dir)
    if (step_dir / "params.pt").is_file():
        return "port"
    if is_orbax_step(step_dir):
        return "jax"
    return None


def jax_ema_state_dict(params: Dict[str, Any], ema: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The EMA shadow of a JAX tree keyed by the port's parameter names. Its
    own keys tell the scope, as the JAX package's ``params_only_tree`` reads
    them: the keys of ``params`` (scope all) or the core's subtree (scope
    core)."""
    return jax_params_to_state_dict(ema if set(ema) == set(params) else {"core": ema})


def jax_params_only(tree: Dict[str, Any], use_ema: bool = False) -> Dict[str, torch.Tensor]:
    """The inference state_dict of a JAX checkpoint tree, with the EMA
    weights swapped in when `use_ema` (``params_only_tree`` of the JAX
    package)."""
    params = jax_params_to_state_dict(tree["params"])
    if use_ema and tree.get("ema_core"):
        params.update(jax_ema_state_dict(tree["params"], tree["ema_core"]))
    return params


def _nodes_with(tree, keys) -> list:
    """The dict nodes of `tree` (dicts and lists) that hold all of `keys`."""
    found = []
    if isinstance(tree, dict):
        if keys <= set(tree):
            found.append(tree)
        for v in tree.values():
            found += _nodes_with(v, keys)
    elif isinstance(tree, list):
        for v in tree:
            found += _nodes_with(v, keys)
    return found


@torch.no_grad()
def restore_jax_state(state, tree: Dict[str, Any]) -> None:
    """Load the JAX package's training state (``state_to_tree`` of its
    ``train/checkpoint.py``, as ``orbax_reader.read_orbax_step`` returns it)
    into a TrainState built by create_trainer for the same config, in place.

    * params: through ``jax_params_to_state_dict``, strictly;
    * EMA: keyed by the port's parameter names, scope core or all as the
      tree's keys say; it must be the scope the config gives;
    * optimizer: the optax state of the JAX ``make_optimizer`` --
      ``chain(clip_by_global_norm, adamw)`` (fp32 moments) or
      ``chain(clip, chain(scale_by_adam_mv, add_decayed_weights,
      scale_by_learning_rate))`` (bf16 moments), wrapped in
      ``optax.MultiSteps`` when ``data.grad_accum_steps > 1``:
      ``ScaleByAdamState.count``, ``mu`` and ``nu`` (each in its stored dtype)
      become AdamW's count and moments, ``MultiStepsState.mini_step`` and
      ``acc_grads`` its accumulator;
    * step.

    The JAX tree holds no generator state (its rng is not saved), so the
    trainer's generator stays as create_trainer seeded it from the config:
    the run continues as a fresh run from the seed would draw, not as the
    JAX run would have."""
    opt = state.optimizer
    adam = _nodes_with(tree["opt_state"], {"count", "mu", "nu"})
    multi = _nodes_with(tree["opt_state"], {"mini_step", "gradient_step", "inner_opt_state",
                                            "acc_grads"})
    if len(adam) != 1 or len(multi) > 1:
        raise ValueError(f"not the JAX package's optimizer state: {len(adam)} Adam states, "
                         f"{len(multi)} MultiSteps states")
    if bool(multi) != (opt.acc is not None):
        raise ValueError("data.grad_accum_steps differs between the config and the checkpoint "
                         f"(optax.MultiSteps {'present' if multi else 'absent'})")
    mu, nu = (jax_params_to_state_dict(adam[0][k], dtype=None) for k in ("mu", "nu"))
    for name, moments in (("mu", mu), ("nu", nu)):
        dtypes = {t.dtype for t in moments.values()}
        if set(moments) != set(opt.names) or dtypes != {opt.mv_dtype}:
            raise ValueError(f"the checkpoint's {name} ({sorted(map(str, dtypes))}) does not "
                             f"fit the optimizer (mv_dtype {opt.mv_dtype})")
    params = jax_params_to_state_dict(tree["params"])
    ema = {}
    if state.ema:
        if not tree.get("ema_core"):
            raise ValueError("the config keeps an EMA; the checkpoint has none")
        ema = jax_ema_state_dict(tree["params"], tree["ema_core"])
        if set(ema) != set(state.ema):
            raise ValueError("training.ema.scope differs between the config and the checkpoint")
    state.model.load_state_dict(params, strict=True)
    opt.load_state_dict({
        "count": int(adam[0]["count"]), "mu": mu, "nu": nu,
        "mini_step": int(multi[0]["mini_step"]) if multi else 0,
        "acc": jax_params_to_state_dict(multi[0]["acc_grads"]) if multi else None})
    _load_ema(state, ema)
    state.step = int(tree["step"])
