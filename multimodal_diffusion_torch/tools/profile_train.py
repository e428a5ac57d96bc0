"""Where the device time of one mvp train step goes, on one CUDA card.

    python -m multimodal_diffusion_torch.tools.profile_train [--clips 8]

Builds the `bench.py --task train` workload (mvp at full width: d=512,
8 layers, 8 heads; B clips of 48x128x128 video and 48000 audio samples,
uniform from np.random.default_rng(0), placed on the card once as bench.py
does; seeded random weights, bf16 compute with fp32 parameters, AdamW + EMA)
through create_trainer + run_training, runs two steps to warm up, then one
step under torch.profiler, and prints one JSON line: that step's wall time,
the device's busy time in it (sum of the CUDA kernels' self time), the idle
share 1 - busy / wall of that same step, its kernel launches, the flash
kernels' device time, the kernels with the most device time, and each layer
run alone (VAE and codec encode, denoiser, optimizer and EMA; `layer_ms`).
The profiler slows the host, so the profiled step is slower than an
unprofiled one; `chip_smoke.py` times those.
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
from ..utils.io import mvp_v2a_config


def train_workload(clips: int = 8, seed: int = 0):
    """The mvp trainer on the card and the bench.py synthetic batch (uniform
    video [clips, 3, T, H, W] and audio [clips, 1, L] from
    np.random.default_rng(0), has_* all true) on the card, and
    `run(n_steps, log_fn=None)` that takes n steps through run_training and
    waits for the card. The config is the built-in mvp+v2a tree: v2a.yaml
    overlays only sampling, paths and io keys, so every key the trainer
    reads is mvp.yaml's."""
    cfg = mvp_v2a_config()
    cfg["data"]["batch_size"] = clips
    cfg["training"]["log_every"] = 1
    bundle = create_trainer(cfg, device="cuda", seed=seed)
    rng = np.random.default_rng(0)
    shapes = bundle.latent_shapes
    batch = {"video": rng.uniform(0, 1, shapes["video"]).astype(np.float32),
             "audio": rng.uniform(-1, 1, shapes["audio"]).astype(np.float32),
             "has_video": np.ones(clips, bool), "has_audio": np.ones(clips, bool)}
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}

    def run(n_steps: int, log_fn=None):
        state = run_training(cfg, bundle, itertools.repeat(batch),
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
        tok_v = model.tokenize_video(model.encode_video(video))
        tok_a = model.tokenize_audio(model.encode_audio(audio))
    grid = model.video_grid((0, 0) + tuple(sc.z_video_shape[2:]))

    def denoise():
        out = model.denoise_tokens(tok_v, tok_a, draws["t_v"], draws["t_a"], grid)
        loss = out["eps_v"].float().square().mean() + out["eps_a"].float().square().mean()
        loss.backward()

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
    for p in params:
        p.grad = None
    return out


def profile_step(run, top: int = 20) -> dict:
    """Device time by kernel over one step, the flash kernels' share, and
    that step's idle share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(1)
        wall_s = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in events) / 1e6
    flash_ms = sum(e.self_device_time_total for e in events if "flash_" in e.key) / 1e3
    ranked = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:top]
    return {"wall_s": wall_s, "device_busy_s": busy_s, "device_idle_share": 1.0 - busy_s / wall_s,
            "kernel_launches": sum(e.count for e in events), "flash_kernels_device_ms": flash_ms,
            "top": [{"name": e.key[:200], "count": e.count,
                     "device_ms": e.self_device_time_total / 1e3} for e in ranked]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clips", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this tool profiles the card")
    _, bundle, batch, run = train_workload(args.clips)
    run(2)  # warm-up: kernel builds, cuDNN plans, allocator
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    prof = profile_step(run)
    print(json.dumps({"phase": "profile_train", "clips": args.clips, "nvidia_smi": smi,
                      **prof, "layers_alone_ms": layer_ms(bundle, batch)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
