"""Kernel launches per denoiser step of the sampler: the profiler's kernel
events over the profiled calls, divided by their DDIM steps. Exact."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or not trace.kernels or not ctx.get("traced_steps"):
        return None
    return len(trace.kernels) / ctx["traced_steps"]
