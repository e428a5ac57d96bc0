"""The sampler's time outside its step loop, in ms a call: the median over
the calls the program's span ring holds that no profiler recorded, of a
``sample.call`` span's duration less its loop's, from its first
``ddim.step``'s start to its last one's end: the prompt upload, the VAE
encode, the mouth tokens, the sampler's set-up before the loop (where the
host waits for the encode's device work), the decode, the readback and the
glue between them. A program without the span ring, or a ring without such
a call, gives nothing."""

import statistics


def read(ctx):
    try:
        from multimodal_diffusion_torch.utils.profiling import spans
    except ImportError:
        return None
    ring = spans()
    call_of = {s.id: s.parent for s in ring if s.name == "sample.denoise"}
    loops = {}
    for s in ring:
        if s.name == "ddim.step" and s.parent in call_of:
            lo, hi = loops.get(call_of[s.parent], (s.start_ns, s.end_ns))
            loops[call_of[s.parent]] = (min(lo, s.start_ns), max(hi, s.end_ns))
    ms = [((c.end_ns - c.start_ns) - (loops[c.id][1] - loops[c.id][0])) / 1e6
          for c in ring if c.name == "sample.call" and not c.profiled and c.id in loops]
    return statistics.median(ms) if ms else None
