"""Where the device time of one train step goes, on one CUDA card.

    python -m multimodal_diffusion_torch.tools.profile_train [--clips 8]
        [--config mvp|specificity8] [--input fixed|fixed_uint8|resident|streamed ...]

Builds the `bench.py --task train` workload (mvp at full width: d=512,
8 layers, 8 heads; or with `--config specificity8` the flagship: d=1024, 16
layers, the patch VideoVAE, 288 mouth-crop tokens, reconstruction every 8th
step, bf16 moments; B clips of 48x128x128 video and 48000 audio samples,
uniform from np.random.default_rng(0), placed on the card once as bench.py
does; seeded random weights, bf16 compute with fp32 parameters, AdamW + EMA)
through create_trainer + run_training, warms up, then runs one step under
torch.profiler, and prints one JSON line: that step's wall time, the
device's busy time in it (sum of the CUDA kernels' self time), the idle
share 1 - busy / wall of that same step, its kernel launches, the flash
kernels' device time, the kernels with the most device time, and each layer
run alone (VAE and codec encode, denoiser, optimizer and EMA; `layer_ms`).
Where the config decodes on every K-th step only, a step without the decode
and a step with it are profiled apart (the latter under `recon_step`). The
profiler slows the host, so a profiled step is slower than an unprofiled
one; `chip_smoke.py` times those.

`--input` says where the batches come from, one JSON line each, in one
process: `fixed` (the default) is the batch above, already on the card
(`fixed_uint8`: its video as uint8 frames, normalised in the step);
`resident` and `streamed` are the train_joint CLI's inputs over a corpus of
64 flagship-sized clips written into a temporary directory
(`datasets/records.py::device_resident_batches`, or the DataLoader's
collated batches copied by `run_training`'s prefetch). Each line also holds
the device time of the batch's own work in the profiled step (the gather,
or the host-to-device copies), the median wall time of 10 unprofiled steps
logged every step, and the time of one `MetricWriter.write` of a step's
metrics.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import time

import numpy as np
import torch

from ..train.trainer import create_trainer, run_training
from ..utils.io import builtin_config


def train_workload(clips: int = 8, seed: int = 0, config: str = "mvp", records=None,
                   resident: bool = True, uint8: bool = False):
    """The trainer of the built-in config `config` on the card and the
    bench.py synthetic batch (uniform video [clips, 3, T, H, W] and audio
    [clips, 1, L] from np.random.default_rng(0), has_* all true) on the card,
    and `run(n_steps, log_fn=None)` that takes n steps through run_training
    and waits for the card. "mvp" is the built-in mvp+v2a tree (v2a.yaml
    overlays only sampling, paths and io keys, so every key the trainer
    reads is mvp.yaml's); "specificity8" the flagship. With `records` (a
    directory of .avrec shards) the steps take the train_joint CLI's
    batches from them instead: resident on the card, or streamed. With
    `uint8` the fixed batch's video is the same frames as uint8 [clips, T,
    H, W, 3] (the layout those batches have), normalised in the step."""
    cfg = builtin_config(config)
    cfg["data"]["batch_size"] = clips
    cfg["training"]["log_every"] = 1
    bundle = create_trainer(cfg, device="cuda", seed=seed)
    rng = np.random.default_rng(0)
    shapes = bundle.latent_shapes
    batch = {"video": rng.uniform(0, 1, shapes["video"]).astype(np.float32),
             "audio": rng.uniform(-1, 1, shapes["audio"]).astype(np.float32),
             "has_video": np.ones(clips, bool), "has_audio": np.ones(clips, bool)}
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    fixed = batch
    if uint8:
        fixed = dict(batch, video=(batch["video"] * 255.0).round().to(torch.uint8)
                     .permute(0, 2, 3, 4, 1).contiguous())
    batches = itertools.repeat(fixed)
    if records is not None:
        from ..datasets.collate import collate_batch
        from ..datasets.loader import DataLoader
        from ..datasets.records import RecordDataset, device_resident_batches

        ds = RecordDataset(records)
        batches = (device_resident_batches(ds, "cuda", clips, seed=seed) if resident else
                   iter(DataLoader(ds, clips, lambda items: collate_batch(items, ds.T, ds.L),
                                   num_workers=int(cfg["data"]["num_workers"]), seed=seed)))

    def run(n_steps: int, log_fn=None):
        state = run_training(cfg, bundle, batches,
                             max_steps=bundle.state.step + n_steps, log_fn=log_fn)
        torch.cuda.synchronize()
        return state

    return cfg, bundle, batch, run


def _median_device_ms(fn, reps: int = 5) -> float:
    """Median over `reps` calls of fn's time between CUDA events around it
    (each call synchronised)."""
    times = []
    for _ in range(reps + 1):  # the first call warms up
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times[1:]))


def layer_ms(bundle, batch) -> dict:
    """Each layer of the step run alone on the same batch, timed with CUDA
    events (ms): the VAE and codec encoders forward + backward (into a
    stand-in loss), the denoiser forward + backward on the step's token
    shapes, and the optimizer + EMA. Run after the profiled step: the
    optimizer part advances the optimizer's state."""
    from ..train import trainer as TT

    model, sc = bundle.model.train(), bundle.step_config
    params = bundle.state.optimizer.params
    draws = TT.draw_step_randomness(torch.Generator(device="cuda").manual_seed(1), sc)
    video, audio = batch["video"], batch["audio"]

    def encode():
        z = model.encode_video(video).float().square().mean()
        z = z + model.encode_audio(audio).float().square().mean()
        torch.autograd.grad(z, [p for p in params if p.requires_grad], allow_unused=True)

    with torch.no_grad():
        z_v, z_a = model.encode_video(video), model.encode_audio(audio)
        tok_v, tok_a = model.tokenize_video(z_v), model.tokenize_audio(z_a)
    grid = model.video_grid((0, 0) + tuple(sc.z_video_shape[2:]))
    mouth_kw = {}
    if model.cfg.mouth_enabled:
        mouth_kw = {"tok_m": model.mouth_tokens(video), "mouth_grid": model.mouth_grid(
            video.shape[2]), "keep_m": torch.ones(video.shape[0], device=video.device)}

    def denoise():
        out = model.denoise_tokens(tok_v, tok_a, draws["t_v"], draws["t_a"], grid, **mouth_kw)
        loss = out["eps_v"].float().square().mean() + out["eps_a"].float().square().mean()
        loss.backward()

    def decode():
        loss = TT.reconstruction_loss(
            model.decode_video(z_v, out_size=tuple(video.shape[2:])), video,
            model.decode_audio(z_a), audio, weight=1.0)
        torch.autograd.grad(loss, [p for n, p in model.named_parameters()
                                   if n.startswith(("vid_vae.", "aud_codec."))],
                            allow_unused=True)

    def optimizer():
        bundle.state.optimizer.step([p.grad for p in params])
        shadow = list(bundle.state.ema.values())
        named = dict(model.named_parameters())
        torch._foreach_mul_(shadow, sc.ema_decay)
        torch._foreach_add_(shadow, [named[n] for n in bundle.state.ema],
                            alpha=1.0 - sc.ema_decay)

    out = {"VAE/codec encode fwd+bwd": _median_device_ms(encode),
           "denoiser fwd+bwd (flash kernels inside)": _median_device_ms(denoise),
           "optimizer + EMA": _median_device_ms(optimizer)}
    if sc.recon_weight > 0.0:
        out["VAE/codec decode + reconstruction loss fwd+bwd"] = _median_device_ms(decode)
    for p in params:
        p.grad = None
    return out


def profile_step(run, top: int = 20) -> dict:
    """Device time by kernel over one step, the flash kernels' share, and
    that step's idle share; the host operations with the most self time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(1)
        wall_s = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in events) / 1e6
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)[:10]
    flash_ms = sum(e.self_device_time_total for e in events if "flash_" in e.key) / 1e3
    # the batch's own work: the resident gather, or the host-to-device copies
    input_ms = sum(e.self_device_time_total for e in events
                   if "indexSelect" in e.key or "HtoD" in e.key) / 1e3
    ranked = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:top]
    return {"wall_s": wall_s, "device_busy_s": busy_s, "device_idle_share": 1.0 - busy_s / wall_s,
            "kernel_launches": sum(e.count for e in events), "flash_kernels_device_ms": flash_ms,
            "gather_and_host_copy_device_ms": input_ms,
            "top": [{"name": e.key[:200], "count": e.count,
                     "device_ms": e.self_device_time_total / 1e3} for e in ranked],
            "top_host": [{"name": e.key[:100], "count": e.count,
                          "self_cpu_ms": e.self_cpu_time_total / 1e3} for e in host]}


def write_corpus(root, clips: int = 64, clips_per_shard: int = 32, no_video=(), no_audio=()):
    """`clips` flagship-sized clips (uint8 video [48, 128, 128, 3], float32
    audio [48000], from np.random.default_rng(0); the clips numbered in
    `no_video` / `no_audio` flagged without it) as .avrec shards; returns
    the shard paths."""
    from ..datasets.records import write_record_shards

    rng = np.random.default_rng(0)

    def items():
        for i in range(clips):
            video = rng.integers(0, 256, (48, 128, 128, 3), dtype=np.uint8)
            audio = rng.uniform(-0.5, 0.5, 48000).astype(np.float32)
            yield {"video": None if i in no_video else video,
                   "audio": None if i in no_audio else audio}

    return write_record_shards(items(), root, video_shape=(48, 128, 128, 3),
                               audio_shape=(48000,), clips_per_shard=clips_per_shard,
                               fps=16, sr=16000)


def input_costs(run) -> dict:
    """The median wall time of 10 unprofiled steps logged every step, and
    the time of one MetricWriter.write of a step's metrics (ms; JSONL and
    TensorBoard), as the train_joint CLI writes them."""
    import tempfile

    from ..train.metrics import MetricWriter

    logs = []
    run(10, log_fn=lambda step, m: logs.append(m))
    with tempfile.TemporaryDirectory() as d:
        writer = MetricWriter(d)
        writer.write(0, logs[0])
        t0 = time.perf_counter()
        for step in range(1, 51):
            writer.write(step, logs[-1])
        write_ms = (time.perf_counter() - t0) / 50 * 1e3
        writer.close()
    return {"median_step_s": float(np.median([1.0 / m["steps_per_sec"] for m in logs])),
            "metric_writer_write_ms": write_ms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clips", type=int, default=8)
    ap.add_argument("--config", choices=("mvp", "specificity8"), default="mvp")
    ap.add_argument("--input", nargs="+",
                    choices=("fixed", "fixed_uint8", "resident", "streamed"), default=["fixed"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this tool profiles the card")
    import shutil
    import tempfile
    from pathlib import Path

    root = Path(tempfile.mkdtemp(prefix="profile_train_"))
    try:
        records = None
        if set(args.input) & {"resident", "streamed"}:
            write_corpus(root)
            records = root
        for source in args.input:
            profile_one(args, source, None if source.startswith("fixed") else records)
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


def profile_one(args, source: str, records) -> None:
    _, bundle, batch, run = train_workload(args.clips, config=args.config, records=records,
                                           resident=source == "resident",
                                           uint8=source == "fixed_uint8")
    sc = bundle.step_config
    decode_apart = sc.recon_weight > 0.0 and sc.recon_every > 1
    # warm-up: kernel builds, cuDNN plans, allocator; through one decode step
    run(sc.recon_every if decode_apart else 2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    prof = profile_step(run)  # a step without the decode, where they differ
    if decode_apart:
        run(sc.recon_every - 1 - bundle.state.step % sc.recon_every)
        prof["recon_step"] = profile_step(run)
    prof["input_costs"] = input_costs(run)
    print(json.dumps({"phase": "profile_train", "config": args.config, "clips": args.clips,
                      "input": source, "nvidia_smi": smi, **prof,
                      "layers_alone_ms": layer_ms(bundle, batch)}), flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
