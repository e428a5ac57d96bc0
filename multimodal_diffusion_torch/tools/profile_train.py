"""Where the device time of one train step goes, on one CUDA card.

    python -m multimodal_diffusion_torch.tools.profile_train [--clips 8]
        [--config mvp|specificity8]

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


def train_workload(clips: int = 8, seed: int = 0, config: str = "mvp"):
    """The trainer of the built-in config `config` on the card and the
    bench.py synthetic batch (uniform video [clips, 3, T, H, W] and audio
    [clips, 1, L] from np.random.default_rng(0), has_* all true) on the card,
    and `run(n_steps, log_fn=None)` that takes n steps through run_training
    and waits for the card. "mvp" is the built-in mvp+v2a tree (v2a.yaml
    overlays only sampling, paths and io keys, so every key the trainer
    reads is mvp.yaml's); "specificity8" the flagship."""
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
    ap.add_argument("--config", choices=("mvp", "specificity8"), default="mvp")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this tool profiles the card")
    _, bundle, batch, run = train_workload(args.clips, config=args.config)
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
    print(json.dumps({"phase": "profile_train", "config": args.config, "clips": args.clips,
                      "nvidia_smi": smi, **prof,
                      "layers_alone_ms": layer_ms(bundle, batch)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
