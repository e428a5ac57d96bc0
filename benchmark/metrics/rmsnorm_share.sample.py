"""The hand-written RMSNorm kernel's share of the device's busy time over
the sampler's profiled calls, in %: the summed device time of the kernels
whose name has `rms_norm`, over the union of every device operation's
interval. None where no such kernel ran (a program that computes the norm
in elementwise launches)."""


def read(ctx):
    trace = ctx.get("trace")
    launches = [k for k in trace.kernels if "rms_norm" in k.name] if trace else []
    busy = trace.busy_s() if launches else 0.0
    return 100.0 * sum(k.seconds for k in launches) / busy if busy else None
