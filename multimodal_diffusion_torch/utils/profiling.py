"""Profiling and performance accounting (counterpart of the JAX package's
``utils/profiling.py``).

  * ``trace(logdir)`` — a context manager around ``torch.profiler`` (CPU and,
    on a card, CUDA activity) that writes a Chrome trace into `logdir`;
  * ``annotate(name)`` — a ``torch.profiler.record_function`` range;
  * ``flops_*`` — analytic FLOP counts of the MMDiT denoiser, identical to
    the JAX package's, so step metrics report model FLOPS utilization (MFU);
  * ``device_peak_flops()`` — the card's dense bf16 peak, by
    ``torch.cuda.get_device_name()`` (a CUDA card it does not know raises);
  * ``calib_tflops()`` — the bf16 matmul rate the card reaches right now;
  * ``device_memory_stats()`` — the caching allocator's bytes in use, peak
    and the card's total.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Dict, Optional

import torch

# dense bf16 matmul peak per card (FLOP/s), NVIDIA data sheets; "cpu" is the
# JAX package's host figure
PEAK_FLOPS = {
    "nvidia h100 80gb hbm3": 989e12,  # H100 SXM
    "cpu": 5e10,
}


@contextlib.contextmanager
def trace(logdir):
    """Capture a trace: ``with trace('runs/prof'): step(...)`` writes
    ``<logdir>/trace.json`` (Chrome trace format)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(logdir / "trace.json"))


def annotate(name: str):
    return torch.profiler.record_function(name)


def device_peak_flops(device=None) -> float:
    """The dense bf16 peak of `device` (default: CUDA card 0, or the CPU
    without a card); the CPU entry for a CPU device."""
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu") \
        if device is None else torch.device(device)
    if device.type == "cpu":
        return PEAK_FLOPS["cpu"]
    kind = torch.cuda.get_device_name(device)
    try:
        return PEAK_FLOPS[kind.lower()]
    except KeyError:
        raise KeyError(f"no dense bf16 peak known for {kind!r}; add it to "
                       f"utils/profiling.py::PEAK_FLOPS") from None


# ---------------------------------------------------------------------------
# analytic FLOPs (forward; x3 for fwd+bwd)
# ---------------------------------------------------------------------------


def flops_mmdit_forward(n_tokens: int, d_model: int, n_layers: int,
                        mlp_ratio: float = 4.0) -> float:
    """Dense matmul FLOPs for one MMDiT forward pass of one sample.

    Per layer: qkv (2*N*d*3d) + attn scores/values (2*2*N^2*d) + out proj
    (2*N*d*d) + mlp (2*2*N*d*(ratio*d)).
    """
    N, d = n_tokens, d_model
    per_layer = (
        2 * N * d * 3 * d          # qkv projection
        + 4 * N * N * d            # QK^T and PV
        + 2 * N * d * d            # output projection
        + 4 * N * d * int(mlp_ratio * d)  # two mlp matmuls
    )
    return float(n_layers * per_layer)


def flops_denoiser_step(batch: int, n_tokens: int, d_model: int, n_layers: int,
                        mlp_ratio: float = 4.0, cfg_dual: bool = True) -> float:
    """One DDIM step's denoiser FLOPs (batched CFG doubles the batch)."""
    mult = 2 if cfg_dual else 1
    return mult * batch * flops_mmdit_forward(n_tokens, d_model, n_layers, mlp_ratio)


def mfu(achieved_flops_per_sec: float, device=None) -> float:
    """Model FLOPS utilization vs the peak of `device` (device_peak_flops)."""
    return achieved_flops_per_sec / device_peak_flops(device)


def calib_tflops(repeats: int = 3, inner: int = 8) -> Optional[float]:
    """The card's achievable bf16 matmul rate now, TFLOP/s: a 4096^3
    ``torch.matmul``, the least over `repeats` samples of `inner` chained
    calls timed with CUDA events. None off CUDA (a CPU 4096^3 matmul means
    nothing here), as the JAX package returns None off the TPU."""
    if not torch.cuda.is_available():
        return None
    # every entry 2^-12: a chain of products stays exactly a (no inf or nan)
    a = torch.full((4096, 4096), 2.0 ** -12, dtype=torch.bfloat16, device="cuda")
    torch.matmul(a, a)  # cuBLAS handle and plan
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        y = a
        start.record()
        for _ in range(inner):
            y = torch.matmul(y, a)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3 / inner)
    return 2 * 4096 ** 3 / best / 1e12


def device_memory_stats() -> Optional[Dict[str, float]]:
    """bytes_in_use, peak_bytes_in_use (torch.cuda.memory_stats' allocated
    bytes, current and peak) and bytes_limit (the card's total memory) of
    CUDA card 0; None without a card."""
    if not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats()
    return {
        "bytes_in_use": float(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": float(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": float(torch.cuda.get_device_properties(0).total_memory),
    }
