"""The device's time a sampler step, in ms, over the profiled calls: for
each call's step loop, from its first ``ddim.step`` range's start to its
last one's end (the program's spans, on the benchmark's thread in the
trace's host operations), the time in which some device operation ran (the
union of their intervals, clipped to the loop), summed over the calls and
divided by their steps. Device work issued before the loop that runs inside
it, or issued in it that runs after it, is misplaced; where the device
keeps pace with the host, as in the host-bound sampling cells, both are
small. A program without the spans gives nothing."""


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
    trace = ctx.get("trace")
    if trace is None or not trace.device_ops:
        return None
    steps = [op for op in trace.host_ops if op.name == "ddim.step"]
    total, n = 0, 0
    for loop in (op for op in trace.host_ops if op.name == "sample.denoise"):
        inside = [s for s in steps if loop.start_ns <= s.start_ns and s.end_ns <= loop.end_ns]
        if inside:
            total += busy_ns(trace.device_ops, inside[0].start_ns, inside[-1].end_ns)
            n += len(inside)
    return total / n / 1e6 if n else None
