"""The VAE decoder's device time a call in the CogVideoX cell, in ms: over
the profiled calls, the time in which some device operation ran (the union
of their intervals) inside the device-side ranges of the program's
``cogvideox.decode`` span, over the calls; read as ``decode_ms.flux`` reads
its ranges. A program without the span gives nothing."""

from benchmark.harness import load_module

busy_ns = load_module("metrics", "decode_ms.flux").busy_ns


def read(ctx):
    trace, ranges = ctx.get("trace"), (ctx.get("device_ranges") or {}).get("cogvideox.decode")
    if trace is None or not ranges or not ctx.get("traced_calls"):
        return None
    total = sum(busy_ns(trace.device_ops, lo, hi) for lo, hi in ranges)
    return total / ctx["traced_calls"] / 1e6
