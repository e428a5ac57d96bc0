"""The profiled calls' share of wall time in which no operation ran on the
card, in %."""


def read(ctx):
    trace = ctx.get("trace")
    return None if trace is None or not trace.device_ops else 100.0 * trace.idle_share()
