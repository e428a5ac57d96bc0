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
seed). SIGTERM or SIGINT ends the run after the step in flight, with a
checkpoint.

Runs on CUDA unless ``--device cpu``, and raises without a card. One process
only: ``WORLD_SIZE > 1`` raises until the multi-process slice.
"""

from __future__ import annotations

import argparse
import os
import signal

from ..datasets.collate import collate_batch
from ..datasets.loader import DataLoader
from ..utils.io import load_config, resolve_device
from .checkpoint import CheckpointManager, restore_state, state_to_tree
from .metrics import MetricWriter
from .trainer import create_trainer, run_training, run_validation


def maybe_init_distributed() -> None:
    """One process: nothing to set up. A launcher that asks for more
    (``WORLD_SIZE > 1``) gets NotImplementedError until the multi-process
    path is ported."""
    if int(os.environ.get("WORLD_SIZE", "1") or 1) > 1:
        raise NotImplementedError(
            "multi-process training (WORLD_SIZE > 1) is not ported yet; run one process")


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

    device = resolve_device(args.device.lower() if args.device else "cuda")
    maybe_init_distributed()
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

    bundle = create_trainer(cfg, device=device)
    global_batch = bundle.latent_shapes["video"][0]
    seed = int(cfg.get("seed", 0))
    resident = bool(cfg["data"].get("device_resident", False)) and bool(records)
    if resident:
        # the corpus fits on the card: upload once, gather batches there
        from ..datasets.records import device_resident_batches

        loader = device_resident_batches(
            dataset, device, global_batch, seed=seed,
            max_clips=cfg["data"].get("resident_max_clips"))
    else:
        loader = DataLoader(
            dataset,
            batch_size=global_batch,
            collate_fn=lambda items: collate_batch(items, T_target, L_target),
            shuffle=True,
            drop_last=True,
            num_workers=int(cfg["data"].get("num_workers", 2)) or 2,
            prefetch=int(cfg["data"].get("prefetch_factor", 2)),
            seed=seed,
        )
    print(f"[data] {len(dataset)} clips; global batch {global_batch}; device {device}; "
          f"{'device-resident' if resident else 'streamed'} input", flush=True)

    # ---- logging / checkpoints ----
    writer = MetricWriter(cfg["paths"]["log_dir"])
    ckpt = CheckpointManager(cfg["paths"]["ckpt_dir"])

    if args.resume and ckpt.latest_step() is not None:
        restore_state(bundle.state, ckpt.restore())
        print(f"[resume] restored step {bundle.state.step} from {ckpt.dir}", flush=True)

    def log_fn(step, metrics):
        writer.write(step, metrics)
        print(_log_line(step, metrics), flush=True)

    # accepted for the JAX configs; the port's saves are synchronous either way
    ckpt_async = bool(cfg["training"].get("ckpt_async", True))

    def ckpt_fn(step, state):
        ckpt.save(step, state_to_tree(state), meta={"experiment": cfg.get("experiment", "")},
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

    ckpt.save(state.step, state_to_tree(state),
              meta={"experiment": cfg.get("experiment", ""), "final": True}, wait=True)
    ckpt.close()
    print(f"[done] step {state.step}; checkpoints in {ckpt.dir}", flush=True)
    writer.close()
    return state


if __name__ == "__main__":
    main()
