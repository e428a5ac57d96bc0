"""Profiling and performance accounting (counterpart of the JAX package's
``utils/profiling.py``).

  * ``span(name)`` — the port's one span: a host-clock record in a bounded
    in-memory ring, read by ``spans()``, and, only while a profiler records,
    a ``torch.profiler.record_function`` range of the same name;
  * ``flops_*`` — analytic FLOP counts of the MMDiT denoiser, identical to
    the JAX package's, so step metrics report model FLOPS utilization (MFU);
    ``denoiser_tokens`` / ``denoiser_train_flops`` count them at the tokens
    the core runs;
  * ``device_peak_flops()`` — the card's dense bf16 peak, by
    ``torch.cuda.get_device_name()`` (a CUDA card it does not know raises);
  * ``calib_tflops()`` — the bf16 matmul rate the card reaches right now;
  * ``device_memory_stats()`` — the caching allocator's bytes in use, peak
    and the card's total.
"""

from __future__ import annotations

import collections
import itertools
import math
import threading
import time
from typing import Deque, Dict, List, Mapping, NamedTuple, Optional, Sequence

import torch

from ..ops.tokenize import num_chunks

# dense bf16 matmul peak per card (FLOP/s), NVIDIA data sheets; "cpu" is the
# JAX package's host figure
PEAK_FLOPS = {
    "nvidia h100 80gb hbm3": 989e12,  # H100 SXM
    "cpu": 5e10,
}


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

SPAN_RING = 16384  # finished spans kept, the oldest dropped first


class Span(NamedTuple):
    """One finished span. Times are ``time.time_ns()``, the epoch clock of
    the profiler's host events; `parent` is the id of the span that was open
    on the same thread when this one opened (None at the root); `profiled`
    says whether a profiler was recording when it opened."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    thread: int
    profiled: bool


_ring: Deque[Span] = collections.deque(maxlen=SPAN_RING)
_ids = itertools.count()


class _Open(threading.local):
    def __init__(self):
        self.stack: List[int] = []


_open = _Open()


class span:
    """``with span("sample.decode"): ...`` times the block on the host
    clock and appends a ``Span`` to the ring when it ends, always: two clock
    reads and an append. While a profiler records it also opens a
    ``torch.profiler.record_function`` range of the same name inside those
    two readings, so the range shows in the trace and the ring's interval
    encloses it."""

    __slots__ = ("name", "_id", "_parent", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        stack = _open.stack
        self._parent = stack[-1] if stack else None
        self._id = next(_ids)
        stack.append(self._id)
        self._range = (torch.profiler.record_function(self.name)
                       if torch.autograd._profiler_enabled() else None)
        self._t0 = time.time_ns()
        if self._range is not None:
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._range is not None:
            self._range.__exit__(*exc)
        t1 = time.time_ns()
        _open.stack.pop()
        _ring.append(Span(self._id, self.name, self._t0, t1, self._parent,
                          threading.get_ident(), self._range is not None))


def spans() -> List[Span]:
    """The ring's finished spans, oldest first (at most ``SPAN_RING``)."""
    return list(_ring)


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


def denoiser_tokens(model, latent_shapes: Mapping[str, Sequence[int]]) -> int:
    """Tokens the AV model's MMDiT core runs per sample, before padding to
    its seq_multiple: the video tubes of ``latent_shapes["z_video"]``, the
    audio chunks of ``latent_shapes["z_audio"]`` and, with the mouth-crop
    stream on, the mouth tubes of ``latent_shapes["video"]``'s frames
    (``utils/io.py::latent_shapes_from_config``'s keys). The JAX training
    loop's MFU counts the first two only."""
    c = model.cfg
    n = math.prod(model.video_grid(latent_shapes["z_video"]))
    n += num_chunks(latent_shapes["z_audio"][2], *c.chunk)
    if c.mouth_enabled:
        n += math.prod(model.mouth_grid(latent_shapes["video"][2]))
    return n


def denoiser_train_flops(model, latent_shapes: Mapping[str, Sequence[int]]) -> float:
    """One training step's denoiser FLOPs: forward and backward, about three
    forwards, of the batch of `latent_shapes` at ``denoiser_tokens``."""
    core = model.cfg.core
    return 3.0 * latent_shapes["z_video"][0] * flops_mmdit_forward(
        denoiser_tokens(model, latent_shapes), core.d_model, core.n_layers, core.mlp_ratio)


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
