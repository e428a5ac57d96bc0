"""The multi-rank dry run (counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``): n ranks, each its own process, run
at the shrunk mvp config (``utils/io.py::shrunk_config``):

  * one train step on a data x model mesh (model = 2 when n is even);
  * 2-step v2a sampling with the batch split over 'data';
  * for n >= 4: one pipelined train step on (n/2) x pipe 2 (2 microbatches)
    and one flash-ring train step on (n/2) x context 2.

    python -m multimodal_diffusion_torch.tools.dryrun_multichip --n 4 [--device cpu]
        [--backend gloo|nccl]

The ranks join one process group (gloo unless --backend says otherwise;
NCCL takes one card per rank). On CUDA every rank takes card
``rank % device_count``, so several ranks may share one card under gloo,
and the core has 2 heads of 32 instead of 4 of 16: the attention kernels
take head dims 32, 64 and 128 only (on the CPU attention is dense).
Prints the JAX dry run's ``OK:`` line, from rank 0.
"""

from __future__ import annotations

import argparse
from typing import List

import numpy as np
import torch


def _one_batch(shapes, seed: int = 0):
    rng = np.random.default_rng(seed)
    B = shapes["video"][0]
    yield {"video": rng.uniform(0, 1, shapes["video"]).astype(np.float32),
           "audio": rng.uniform(-1, 1, shapes["audio"]).astype(np.float32),
           "has_video": np.ones(B, bool), "has_audio": np.ones(B, bool)}


def _train_one_step(cfg, device, batch_size: int) -> None:
    from ..parallel.mesh import make_mesh_from_config
    from ..train.trainer import create_trainer, run_training

    bundle = create_trainer(cfg, device=device, batch_size=batch_size,
                            mesh=make_mesh_from_config(cfg))
    state = run_training(cfg, bundle, _one_batch(bundle.latent_shapes), max_steps=1)
    if state.step != 1:
        raise AssertionError("train step did not run")
    if not all(torch.isfinite(p).all() for p in bundle.model.parameters()):
        raise AssertionError("non-finite parameters after the step")


def rank_main(rank: int, world: int, device: str) -> List[str]:
    """The dry run on this rank; returns the parts of the OK line."""
    from ..infer.sample_clip import build_components, sample_one_direction
    from ..parallel.mesh import local_device, make_mesh
    from ..utils.io import shrunk_config as shrunk

    dev = local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)

    def shrunk_config():
        cfg = shrunk()
        if dev.type == "cuda":
            cfg["model"]["core"]["n_heads"] = 2
        return cfg

    model_ax = 2 if world % 2 == 0 else 1
    data_ax = world // model_ax
    cfg = shrunk_config()
    cfg["parallel"] = {"data": data_ax, "model": model_ax}
    _train_one_step(cfg, dev, max(2, data_ax))

    # batch-sharded sampling over 'data'
    scfg = shrunk_config()
    scfg["diffusion"]["audio"]["sampler_steps"] = 2
    mesh = make_mesh(data=data_ax, model=model_ax)
    model = build_components(scfg, device=dev)
    B = max(2, data_ax)
    frames = np.zeros((B, 8, 32, 32, 3), np.uint8)
    out = sample_one_direction(cfg=scfg, model=model, prompt_modality="video",
                               prompt_video=frames, device=dev, mesh=mesh)
    if out["audio"].shape[0] != B or not np.isfinite(out["audio"]).all():
        raise AssertionError("sharded sampling produced a wrong or non-finite batch")
    msg = [f"1 train step + 2-step sharded sampling on mesh data={data_ax} x "
           f"model={model_ax} ({world} devices)"]

    if world >= 4 and world % 2 == 0:
        pcfg = shrunk_config()
        pcfg["parallel"] = {"data": world // 2, "model": 1, "pipe": 2, "pipe_microbatches": 2}
        _train_one_step(pcfg, dev, world)
        msg.append(f" + 1 pipelined train step on mesh data={world // 2} x pipe=2")
        ccfg = shrunk_config()
        ccfg["parallel"] = {"data": world // 2, "model": 1, "context": 2,
                            "context_flash": True}
        _train_one_step(ccfg, dev, world // 2)
        msg.append(f" + 1 flash-ring CP train step on mesh data={world // 2} x context=2")
    return msg


def dryrun_multichip(n: int, device: str = "cuda", backend: str = "gloo",
                     timeout: float = 900.0) -> str:
    """Run the dry run on n new ranks; returns the OK line."""
    from ..parallel.launch import run_ranks

    parts = run_ranks(rank_main, n, device, backend=backend, timeout=timeout)[0]
    return "[dryrun_multichip] OK: " + "".join(parts)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--backend", default="gloo", help="gloo (default) or nccl")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
    print(dryrun_multichip(args.n, args.device, args.backend), flush=True)


if __name__ == "__main__":
    main()
