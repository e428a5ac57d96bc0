"""The share of the window's denoiser calls that replayed a captured CUDA
graph, in %: of the program's ``ddim.denoiser`` spans taken while no
profiler recorded, inside the window's calls (the ring's last ``batches``
unprofiled ``sample.call`` spans, so the warm-up calls are left out), those
with a ``denoiser.replay`` span inside. A program without the span ring
gives nothing; one with the ring but without graphs reads 0."""


def read(ctx):
    try:
        from multimodal_diffusion_torch.utils.profiling import spans
    except ImportError:
        return None
    ring = spans()
    parent = {s.id: s.parent for s in ring}
    calls = sorted((s for s in ring if s.name == "sample.call" and not s.profiled),
                   key=lambda s: s.start_ns)
    window = {s.id for s in calls[-int(ctx.get("batches") or len(calls)):]} if calls else set()

    def in_window(span_id):
        while span_id is not None:
            if span_id in window:
                return True
            span_id = parent.get(span_id)
        return False

    replayed = {s.parent for s in ring if s.name == "denoiser.replay"}
    denoisers = [s.id for s in ring
                 if s.name == "ddim.denoiser" and not s.profiled and in_window(s.parent)]
    if not denoisers:
        return None
    return 100.0 * sum(d in replayed for d in denoisers) / len(denoisers)
