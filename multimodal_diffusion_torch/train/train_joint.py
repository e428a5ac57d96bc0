"""Joint A<->V training entry point on one CUDA card (counterpart of the JAX
package's ``train/train_joint.py``).

    python -m multimodal_diffusion_torch.train.train_joint \\
        --config configs/mvp.yaml [overlay.yaml ...] [--resume] [--max-steps N] \\
        [--device cpu]

The configs merge left to right. The input is `.avrec` record shards when
``data.records_dir`` is set (``tools/build_records.py`` makes them), else
the clips.json manifest ``data.train_split_glob``; with records and
``data.device_resident`` the corpus goes to the card once and each batch is
gathered there, otherwise a threaded loader streams collated batches that
``run_training`` copies to the card ahead of each step. Metrics go to
``paths.log_dir``, checkpoints to ``paths.ckpt_dir`` every
``training.ckpt_every`` steps and once at the end; ``--resume`` continues
from the latest one (params, AdamW moments, EMA, step and the trainer's
generator; the data stream and the target schedule start again from the
seed). The latest step may also be one the JAX package wrote (orbax): it
restores through ``checkpoint.restore_jax_state``, and the generator starts
from the seed, as that tree holds no generator state. SIGTERM or SIGINT ends the run after the step in flight, with a
checkpoint.

Runs on CUDA unless ``--device cpu``, and raises without a card. Under a
launcher that starts several processes (``torchrun --nproc-per-node=N``:
``WORLD_SIZE > 1``) each rank joins the process group (``nccl`` on cards,
one card per rank by ``LOCAL_RANK``; ``gloo`` with ``--device cpu``) and
the ``parallel.*`` keys lay the step out over the ranks
(``parallel/mesh.py``); the streamed loader gives each data rank its shard
of the clips and its rows of each global batch, and only rank 0 writes logs
and checkpoints. A checkpoint holds the whole state: under
``parallel.model`` every rank joins the gather of the split parameters',
moments' and EMA's parts before rank 0 writes (``checkpoint.state_to_tree``),
and a restore cuts each rank's parts again. The device-resident input stays
one process, as in the JAX package.
"""

from __future__ import annotations

import argparse
import signal

import torch

from ..datasets.collate import collate_batch
from ..datasets.loader import DataLoader
from ..parallel.mesh import (init_distributed, is_lead, local_device, make_mesh_from_config,
                             world_size_and_rank)
from ..utils.io import load_config, resolve_device
from .checkpoint import (CheckpointManager, checkpoint_format, restore_jax_state, restore_state,
                         state_to_tree)
from .metrics import MetricWriter
from .orbax_reader import read_orbax_step
from .trainer import create_trainer, run_training, run_validation


def maybe_init_distributed(device) -> bool:
    """Join the launcher's process group when ``WORLD_SIZE > 1`` (nccl for
    CUDA, gloo for the CPU); returns whether there are several processes."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return init_distributed("nccl" if device.type == "cuda" else "gloo")


def _manifest_dataset(cfg, manifest):
    from ..datasets.av_manifest import AVClipsDataset

    return AVClipsDataset(
        manifest_path=manifest,
        clip_seconds=float(cfg["data"]["clip_seconds"]),
        fps=int(cfg["video"]["fps"]),
        sr=int(cfg["audio"]["sr"]),
        size_hw=tuple(cfg["video"]["size"]),
        video_root=cfg.get("paths", {}).get("video_root"),
        audio_root=cfg.get("paths", {}).get("audio_root"),
        device_preprocess=bool(cfg["data"].get("device_preprocess", False)),
    )


def _log_line(step, metrics) -> str:
    return f"step {step}: " + " ".join(f"{k}={v:.4f}" for k, v in metrics.items())


def main(argv=None):
    """Train as the configs say; returns the final TrainState."""
    ap = argparse.ArgumentParser(description="Joint A<->V diffusion training")
    ap.add_argument("--config", type=str, nargs="+", required=True,
                    help="One or more YAML configs (merged left->right)")
    ap.add_argument("--resume", action="store_true",
                    help="Resume from the latest checkpoint in paths.ckpt_dir")
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--device", type=str, default=None,
                    help="cpu to run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = local_device(resolve_device(args.device.lower() if args.device else "cuda"))
    several = maybe_init_distributed(device)
    lead = is_lead()
    cfg = load_config(*args.config)

    # ---- data ----
    # pre-decoded record shards are the production path: memmap reads, no
    # JPEG decode in the input loop
    records = cfg["data"].get("records_dir")
    if records:
        from ..datasets.records import RecordDataset

        dataset = RecordDataset(
            records, device_preprocess=bool(cfg["data"].get("device_preprocess", True)))
    else:
        dataset = _manifest_dataset(cfg, cfg["data"]["train_split_glob"])
    T_target, L_target = dataset.T, dataset.L

    mesh = make_mesh_from_config(cfg)
    bundle = create_trainer(cfg, device=device, mesh=mesh)
    global_batch = bundle.latent_shapes["video"][0]
    n_data, rank_in_data = mesh.size("data"), mesh.index("data")
    seed = int(cfg.get("seed", 0))
    resident = bool(cfg["data"].get("device_resident", False)) and bool(records)
    if resident:
        # the corpus fits on the card: upload once, gather batches there
        from ..datasets.records import device_resident_batches

        loader = device_resident_batches(
            dataset, device, global_batch, seed=seed,
            max_clips=cfg["data"].get("resident_max_clips"))
    else:
        # each data rank streams its shard of the clips, its rows of a batch
        loader = DataLoader(
            dataset,
            batch_size=global_batch // n_data,
            collate_fn=lambda items: collate_batch(items, T_target, L_target),
            shuffle=True,
            drop_last=True,
            num_workers=int(cfg["data"].get("num_workers", 2)) or 2,
            prefetch=int(cfg["data"].get("prefetch_factor", 2)),
            seed=seed,
            shard_id=rank_in_data,
            num_shards=n_data,
        )
    if lead:
        print(f"[data] {len(dataset)} clips; global batch {global_batch}; device {device}; "
              f"{'device-resident' if resident else 'streamed'} input", flush=True)
        if several:
            print(f"[mesh] {mesh.shape} over {world_size_and_rank()[0]} ranks", flush=True)

    # ---- logging / checkpoints (the lead rank only) ----
    writer = MetricWriter(cfg["paths"]["log_dir"]) if lead else None
    ckpt = CheckpointManager(cfg["paths"]["ckpt_dir"])

    latest = ckpt.latest_step() if args.resume else None
    if latest is not None:
        # the port's own step directory, or one the JAX package wrote
        if checkpoint_format(ckpt.dir / str(latest)) == "jax":
            restore_jax_state(bundle.state, read_orbax_step(ckpt.dir / str(latest)))
        else:
            restore_state(bundle.state, ckpt.restore())
        print(f"[resume] restored step {bundle.state.step} from {ckpt.dir}", flush=True)

    def log_fn(step, metrics):
        if lead:
            writer.write(step, metrics)
            print(_log_line(step, metrics), flush=True)

    # accepted for the JAX configs; the port's saves are synchronous either way
    ckpt_async = bool(cfg["training"].get("ckpt_async", True))

    # every rank of a 'model' group joins the gather of its parts
    gathers = lead or mesh.size("model") > 1

    def ckpt_fn(step, state):
        tree = state_to_tree(state) if gathers else None
        if lead:
            ckpt.save(step, tree, meta={"experiment": cfg.get("experiment", "")},
                      wait=not ckpt_async)

    val_fn = None
    val_manifest = cfg["data"].get("val_split_glob")
    if val_manifest and int(cfg["training"].get("val_every", 0) or 0) > 0:
        val_loader = DataLoader(
            _manifest_dataset(cfg, val_manifest), batch_size=global_batch,
            collate_fn=lambda items: collate_batch(items, T_target, L_target),
            shuffle=False, drop_last=True,
            num_workers=int(cfg["data"].get("num_workers", 2)) or 2,
        )

        def val_fn(step, state):
            metrics = run_validation(bundle, val_loader.epoch(0), n_batches=8)
            if lead:
                writer.write(step, metrics)
                print(_log_line(step, metrics), flush=True)

    # Preemption: SIGTERM/SIGINT request a clean stop; the loop exits after
    # the step in flight and the final checkpoint below is written before
    # the process ends.
    stop_requested = {"v": False}
    loop_started = {"v": False}

    def _request_stop(signum, frame):
        if not loop_started["v"] or stop_requested["v"]:
            # nothing to checkpoint yet (corpus upload, first step), or a
            # second signal: exit now
            print(f"[preempt] signal {signum} before first step (or "
                  f"repeated); exiting immediately", flush=True)
            raise SystemExit(1)
        stop_requested["v"] = True
        print(f"[preempt] signal {signum} received; will checkpoint and exit", flush=True)

    def _should_stop():
        loop_started["v"] = True
        return stop_requested["v"]

    prev_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers[sig] = signal.signal(sig, _request_stop)
        except ValueError:  # not the main thread (e.g. under a test runner)
            pass

    try:
        state = run_training(
            cfg, bundle, iter(loader),
            max_steps=args.max_steps,
            log_fn=log_fn, checkpoint_fn=ckpt_fn, val_fn=val_fn,
            should_stop=_should_stop,
        )
    finally:
        for sig, h in prev_handlers.items():
            signal.signal(sig, h)

    tree = state_to_tree(state) if gathers else None
    if lead:
        ckpt.save(state.step, tree,
                  meta={"experiment": cfg.get("experiment", ""), "final": True}, wait=True)
        print(f"[done] step {state.step}; checkpoints in {ckpt.dir}", flush=True)
        writer.close()
    ckpt.close()
    return state


if __name__ == "__main__":
    main()
