"""The host's time to issue one sampler step, in ms: the median duration of
the program's ``ddim.step`` spans (``utils/profiling.py::spans``) taken while
no profiler recorded, so at the speed the window runs at; in a --trace 1 run
the ring's last such steps are the window's. A program without the span
ring, or a ring without such a step, gives nothing."""

import statistics


def read(ctx):
    try:
        from multimodal_diffusion_torch.utils.profiling import spans
    except ImportError:
        return None
    ms = [(s.end_ns - s.start_ns) / 1e6 for s in spans()
          if s.name == "ddim.step" and not s.profiled]
    return statistics.median(ms) if ms else None
