"""The AE decoder's device time a call in the FLUX.1 cell, in ms: over the
profiled calls, the time in which some device operation ran (the union of
their intervals) inside the device-side ranges of the program's
``flux.decode`` span (the profiler's range on the device runs from the first
to the last operation launched inside the span), over the calls. Read on
the device, not from the span's host interval, which the host leaves long
before the decoder's work ends. A program without the span gives
nothing."""


def busy_ns(ops, start_ns, end_ns):
    """Nanoseconds of [start_ns, end_ns) covered by `ops` (by start)."""
    busy, reached = 0, start_ns
    for op in ops:
        if op.start_ns >= end_ns:
            break
        lo, hi = max(op.start_ns, reached), min(op.end_ns, end_ns)
        if hi > lo:
            busy += hi - lo
            reached = hi
    return busy


def read(ctx):
    trace, ranges = ctx.get("trace"), (ctx.get("device_ranges") or {}).get("flux.decode")
    if trace is None or not ranges or not ctx.get("traced_calls"):
        return None
    total = sum(busy_ns(trace.device_ops, lo, hi) for lo, hi in ranges)
    return total / ctx["traced_calls"] / 1e6
