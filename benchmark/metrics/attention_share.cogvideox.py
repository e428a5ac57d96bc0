"""The flash-attention forward kernel's share of the device's busy time
over the CogVideoX cell's profiled calls, in %: the launches' summed device
time over the union of every device operation's interval."""


def read(ctx):
    trace = ctx.get("trace")
    launches = [k for k in trace.kernels if "flash_fwd" in k.name] if trace else []
    busy = trace.busy_s() if launches else 0.0
    return 100.0 * sum(k.seconds for k in launches) / busy if busy else None
