"""Orbax checkpoints written by the JAX package, for the port's reader.

``write_jax_checkpoint`` trains the JAX package's trainer for a few steps on
seeded synthetic batches and saves its state with the JAX package's
``CheckpointManager``, as ``train_joint`` does. Run as a script it rewrites
the committed fixture that ``chip_smoke.py`` reads on the card (where
neither JAX nor orbax is installed):

    JAX_PLATFORMS=cpu python tests/_torch_orbax.py

    tests/torch_fixtures/orbax_spec8_tiny/
        ckpt/2/...        the step-2 checkpoint (orbax, OCDBT, zarr v2)
        ckpt/meta_2.json  the trainer's sidecar
        config.yaml       the config it was trained with
        leaves.json       each leaf's path, shape, dtype and sha256, from orbax's restore

The fixture's config is ``_torch_parity.shrunk_flagship_cfg()`` (the
flagship's options at d=64, 2 layers; bf16 Adam moments) with 2 heads of 32
(a head width the card's attention kernels take) and sinusoidal position
tables, which keep the directory under 2 MB.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
FIXTURE = HERE / "torch_fixtures" / "orbax_spec8_tiny"
FIXTURE_STEPS = 2


def fixture_cfg() -> dict:
    from _torch_parity import shrunk_flagship_cfg
    from multimodal_diffusion_tpu.utils.io import deep_update

    cfg = shrunk_flagship_cfg()
    deep_update(cfg, {"embeddings": {"posenc": {"video": "sin", "audio": "sin"}},
                      "model": {"core": {"n_heads": 2}},
                      "training": {"max_steps": 20, "log_every": 1}})
    return cfg


def synthetic_batches(shapes, seed: int = 0):
    """Seeded float video [B, 3, T, H, W] in [0, 1] and audio [B, 1, L] in
    [-1, 1]; the second sample has no audio."""
    rng = np.random.default_rng(seed)
    B = shapes["video"][0]
    while True:
        yield {"video": rng.uniform(0, 1, shapes["video"]).astype(np.float32),
               "audio": rng.uniform(-1, 1, shapes["audio"]).astype(np.float32),
               "has_video": np.ones(B, bool),
               "has_audio": np.arange(B) != 1}


def write_jax_checkpoint(cfg: dict, ckpt_dir, steps: int = FIXTURE_STEPS, batch_size: int = 2,
                         seed: int = 0):
    """Train the JAX trainer `steps` steps and save its state at step
    `steps` under `ckpt_dir`; returns (bundle, state)."""
    import jax

    from multimodal_diffusion_tpu.parallel.mesh import make_mesh
    from multimodal_diffusion_tpu.train import checkpoint as JC
    from multimodal_diffusion_tpu.train import trainer as JT

    mesh = make_mesh(data=1, model=1, devices=jax.devices()[:1])
    bundle = JT.create_trainer(cfg, mesh=mesh, batch_size=batch_size)
    state = JT.run_training(cfg, bundle, synthetic_batches(bundle.latent_shapes, seed),
                            max_steps=steps)
    mgr = JC.CheckpointManager(ckpt_dir)
    mgr.save(steps, JC.state_to_tree(state), meta={"experiment": cfg.get("experiment", ""),
                                                   "final": True}, wait=True)
    mgr.close()
    return bundle, state


def leaf_records(tree) -> list:
    """[{path, shape, dtype, sha256}] of every array leaf of an orbax
    restore, sha256 over its little-endian bytes (bfloat16 as its 2-byte
    words)."""
    import jax

    out = []
    for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        a = np.ascontiguousarray(np.asarray(leaf))
        path = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)
        out.append({"path": path, "shape": list(a.shape), "dtype": str(a.dtype),
                    "sha256": hashlib.sha256(a.tobytes()).hexdigest()})
    return sorted(out, key=lambda r: r["path"])


def write_fixture(out: Path = FIXTURE) -> int:
    """Rewrite the committed fixture; returns its size in bytes."""
    import shutil

    import yaml

    from multimodal_diffusion_tpu.train.checkpoint import CheckpointManager

    cfg = fixture_cfg()
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    write_jax_checkpoint(cfg, out / "ckpt")
    (out / "config.yaml").write_text(yaml.safe_dump(cfg, sort_keys=True))
    mgr = CheckpointManager(out / "ckpt")
    tree = mgr.restore(FIXTURE_STEPS)
    mgr.close()
    (out / "leaves.json").write_text(json.dumps(leaf_records(tree), indent=1) + "\n")
    return sum(p.stat().st_size for p in out.rglob("*") if p.is_file())


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(HERE.parent))
    import jax

    jax.config.update("jax_platforms", "cpu")
    print(f"wrote {FIXTURE}: {write_fixture()} bytes")
