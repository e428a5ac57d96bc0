"""MFU decomposition of the denoiser's hot path on one CUDA card
(counterpart of the repo root's ``tools/mfu_probe.py``):

    python -m multimodal_diffusion_torch.tools.mfu_probe [--batch 16] [--d 512]
        [--layers 8] [--heads 4] [--tokens 1101] [--seq-multiple 128] [--masked]
        [--device cpu]

Prints one JSON line with:

  1. calibration: ``utils/profiling.py::calib_tflops()``, the bf16 matmul
     rate the card reaches now (None on the CPU);
  2. the MMDiT core forward at the t2i shape (the defaults: ``bench.py``'s
     t2i core, d=512, 8 layers, 4 heads of 128, 77 text + 1024 image tokens
     padded to 1152, the CFG-doubled batch 2 x 8), its TFLOP/s and MFU
     against the card's published peak and against the calibration; FLOPs
     are counted at the true N (the pad rows are overhead, not model work);
  3. attention alone at the core's padded shape ([16, 4, 1152, 128] by
     default): the dense ``ops/attention.py::mha_reference`` and, on the
     card, the port's flash forward kernel (``ops/flash_attention.py``);
  4. the sampler step this implies: one core forward of the doubled batch
     per step, times ``bench.py``'s 50 steps, and the images/s that bounds.

Times are the least over 5 samples of chained calls between CUDA events
(``chain_time``; the host clock on the CPU). The compute dtype is bf16 on
the card and fp32 on the CPU. Runs on CUDA unless ``--device cpu``; raises
without CUDA otherwise.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable

import torch

from ..models.diffusion import init_weights
from ..models.mmdit import MMDiT, MMDiTConfig
from ..ops.attention import mha_reference
from ..ops.flash_attention import flash_attention
from ..utils.io import resolve_device
from ..utils.profiling import calib_tflops, device_peak_flops, flops_mmdit_forward

SAMPLER_STEPS = 50  # bench.py's t2i batch


def chain_time(fn: Callable[[], object], dev: torch.device, n_inner: int = 20,
               repeats: int = 5) -> float:
    """Least seconds per call of `fn` over `repeats` samples of `n_inner`
    calls enqueued back to back (CUDA events on the card, the host clock on
    the CPU), after two warm-up calls."""
    fn()
    fn()
    best = float("inf")
    for _ in range(repeats):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n_inner):
                fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3 / n_inner)
        else:
            t0 = time.perf_counter()
            for _ in range(n_inner):
                fn()
            best = min(best, (time.perf_counter() - t0) / n_inner)
    return best


def device_kind(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16,
                    help="the CFG-doubled batch the core sees (t2i B=8 -> 16)")
    ap.add_argument("--d", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=1101,
                    help="77 text + 1024 image tokens at t2i-512")
    ap.add_argument("--seq-multiple", type=int, default=128,
                    help="MMDiTConfig.seq_multiple (the core pads N to a multiple of it)")
    ap.add_argument("--masked", action="store_true",
                    help="mask text-pad-like keys 40..76 (the sampler's layout)")
    ap.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device("cpu" if (args.device or "").lower() == "cpu" else "cuda")
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    torch.backends.cuda.matmul.allow_tf32 = False
    peak = device_peak_flops(dev)
    report = {"backend": dev.type, "device_kind": device_kind(dev),
              "peak_tflops_datasheet": peak / 1e12}

    # 1. calibration
    calib = calib_tflops() if dev.type == "cuda" else None
    report["calib_tflops"] = None if calib is None else round(calib, 1)

    # 2. the MMDiT core forward at the t2i shape
    B, N, d = args.batch, args.tokens, args.d
    core = MMDiT(MMDiTConfig(d_model=d, n_layers=args.layers, n_heads=args.heads, dropout=0.0,
                             gelu_exact=False, dtype=dtype, seq_multiple=args.seq_multiple))
    init_weights(core, torch.Generator().manual_seed(3))
    core = core.to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((B, N, d), generator=gen, device=dev).to(dtype)
    mask = None
    if args.masked:
        mask = torch.zeros((B, N), dtype=torch.bool, device=dev)
        mask[:, 40:77] = True
    with torch.inference_mode():
        t_core = chain_time(lambda: core(x, mask), dev, n_inner=10)
    fl_core = B * flops_mmdit_forward(N, d, args.layers)
    report["core_fwd_ms"] = round(t_core * 1e3, 3)
    report["core_tflops"] = round(fl_core / t_core / 1e12, 1)
    report["core_mfu_vs_datasheet"] = round(fl_core / t_core / peak, 3)
    report["core_mfu_vs_calib"] = (None if calib is None
                                   else round(fl_core / t_core / (calib * 1e12), 3))

    # 3. attention alone, at the core's padded sequence
    H, Dh = args.heads, d // args.heads
    n_pad = -(-N // max(1, args.seq_multiple)) * max(1, args.seq_multiple)
    q, k, v = (torch.randn((B, H, n_pad, Dh), generator=gen, device=dev).to(dtype)
               for _ in range(3))
    fl_attn = 4 * n_pad * n_pad * Dh * B * H
    report["attn_shape"] = [B, H, n_pad, Dh]
    with torch.inference_mode():
        t_ref = chain_time(lambda: mha_reference(q, k, v), dev, n_inner=10)
        report["attn_ref_ms"] = round(t_ref * 1e3, 3)
        report["attn_ref_tflops"] = round(fl_attn / t_ref / 1e12, 1)
        if dev.type == "cuda":  # the kernel itself; the CPU has only its plain version
            t_fl = chain_time(lambda: flash_attention(q, k, v), dev, n_inner=10)
            report["attn_flash_ms"] = round(t_fl * 1e3, 3)
            report["attn_flash_tflops"] = round(fl_attn / t_fl / 1e12, 1)

    # 4. the sampler step this implies: one core forward of the doubled
    # batch a step (the text encoder, VAE decode and solver update left out)
    report["sampler_step_ms_implied"] = report["core_fwd_ms"]
    report["sampler_core_s_implied"] = round(SAMPLER_STEPS * t_core, 4)
    report["images_per_sec_core_bound"] = round((B // 2) / (SAMPLER_STEPS * t_core), 3)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
