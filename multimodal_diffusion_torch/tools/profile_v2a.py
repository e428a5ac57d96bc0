"""Where the device time of one v2a batch goes, on one CUDA card.

    python -m multimodal_diffusion_torch.tools.profile_v2a [--clips 8] [--steps 50]
        [--config mvp|specificity8] [--sync-guidance 0.5] [--sampler ddim|dpmpp_2m]
        [--quant none|int8] [--bf16-params]

Builds the `bench.py` workload (mvp+v2a at full width, or with `--config
specificity8` the flagship: d=1024, 16 layers, mouth-crop tokens from the
frames; seeded N(0, 0.02) weights, bf16 compute, seeded uniform prompt
frames), runs one batch to warm up, then one batch under torch.profiler, and
prints one JSON line: that batch's wall time, the device's busy time in it
(sum of the CUDA kernels' self time), the idle share 1 - busy / wall of that
same batch, the flash kernels' device time, and the kernels with the most
device time. `--sync-guidance` (flagship: source mouth) profiles the
sync-guided batch; `--quant int8` the W8A8 core (`configs/int8.yaml`), and
then the line also has the device time of its activation-quantize passes,
its int8 products and their rescale (the profiler ranges that
`ops/quant.py::int8_linear` opens while a profiler records);
`--bf16-params` casts the weights to bf16 once, as the serving runner does.
The profiler slows the host, so the profiled batch is slower than an
unprofiled one; `chip_smoke.py` times those.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from ..infer.sample_clip import build_components, sample_one_direction
from ..utils.io import builtin_config, latent_shapes_from_config


def v2a_workload(clips: int = 8, steps: int = 50, seed: int = 0, config: str = "mvp",
                 quant: str = "none", bf16_params: bool = False):
    """The model of the built-in config `config` ("mvp": mvp+v2a;
    "specificity8": the flagship) with model.core.quant `quant` on the card,
    every parameter N(0, 0.02) (as `bench.py`; rounded to bf16 with
    `bf16_params`), uniform uint8 prompt frames [clips, T, H, W, 3], and a
    `run(sampling=None)` that samples audio for them and waits for the card;
    `sampling` overlays the config's `sampling` keys for that call (sampler,
    sync_guidance_scale, ...)."""
    cfg = builtin_config(config)
    for mod in ("audio", "video"):
        cfg["diffusion"][mod]["sampler_steps"] = steps
    cfg["model"]["core"]["quant"] = quant
    model = build_components(cfg, device="cuda", bf16_params=bf16_params)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    _, _, T, H, W = latent_shapes_from_config(cfg, clips)["video"]
    frames = torch.randint(0, 256, (clips, T, H, W, 3), device="cuda", dtype=torch.uint8,
                           generator=torch.Generator(device="cuda").manual_seed(seed))

    def run(sampling=None):
        c = cfg if not sampling else {**cfg, "sampling": {**cfg["sampling"], **sampling}}
        out = sample_one_direction(cfg=c, model=model, prompt_modality="video",
                                   prompt_video=frames, device="cuda",
                                   generator=torch.Generator().manual_seed(seed + 1))
        torch.cuda.synchronize()
        return out

    return cfg, model, run


INT8_RANGES = ("int8_quantize", "int8_mm", "int8_rescale")


def profile_batch(run, top: int = 15) -> dict:
    """Device time by kernel over one call of `run`, that call's idle share,
    and the device time under each of ops/quant.py's ranges (calls, ms)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_s = time.perf_counter() - t0
    averages = prof.key_averages()
    # the kernels (the int8 ranges show on the device too, over their kernels)
    events = [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA
              and e.key not in INT8_RANGES]
    busy_s = sum(e.self_device_time_total for e in events) / 1e6
    flash_ms = sum(e.self_device_time_total for e in events if "flash_" in e.key) / 1e3
    ranked = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:top]
    int8 = {e.key: {"calls": e.count, "device_ms": e.device_time_total / 1e3}
            for e in averages if e.key in INT8_RANGES}
    return {"wall_s": wall_s, "device_busy_s": busy_s, "device_idle_share": 1.0 - busy_s / wall_s,
            "kernel_launches": sum(e.count for e in events), "flash_kernels_device_ms": flash_ms,
            "int8_passes": int8,
            "top": [{"name": e.key[:200], "count": e.count,
                     "device_ms": e.self_device_time_total / 1e3} for e in ranked]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clips", type=int, default=8)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--config", choices=("mvp", "specificity8"), default="mvp")
    ap.add_argument("--sync-guidance", type=float, default=0.0,
                    help="sampling.sync_guidance_scale (0: unguided)")
    ap.add_argument("--sampler", choices=("ddim", "dpmpp_2m"), default="ddim")
    ap.add_argument("--quant", choices=("none", "int8"), default="none")
    ap.add_argument("--bf16-params", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this tool profiles the card")
    _, _, sample = v2a_workload(args.clips, args.steps, config=args.config, quant=args.quant,
                                bf16_params=args.bf16_params)
    sampling = {"sampler": args.sampler, "sync_guidance_scale": args.sync_guidance}

    def run():
        return sample(sampling)

    run()  # warm-up: kernel build, cuDNN plans, allocator
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"phase": "profile", "config": args.config, "clips": args.clips,
                      "steps": args.steps, "sampling": sampling, "quant": args.quant,
                      "bf16_params": args.bf16_params, "nvidia_smi": smi,
                      **profile_batch(run)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
