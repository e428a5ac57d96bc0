"""FLUX.1's QK-norm + RoPE kernel's share of the device's busy time over the
FLUX.1 cell's profiled calls, in %: the summed device time of the kernels
whose name has `qk_norm_rope`, over the union of every device operation's
interval. None where no such kernel ran (a program that computes the chain
in elementwise launches)."""


def read(ctx):
    trace = ctx.get("trace")
    launches = [k for k in trace.kernels if "qk_norm_rope" in k.name] if trace else []
    busy = trace.busy_s() if launches else 0.0
    return 100.0 * sum(k.seconds for k in launches) / busy if busy else None
