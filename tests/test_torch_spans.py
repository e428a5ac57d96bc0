"""The port's span system (``utils/profiling.py::span``) on the CPU: a ring
record per span, nested by thread; the ring's bound; a profiler range only
while a profiler records, enclosed by the ring's interval; and the spans
``sample_one_direction`` emits in both directions, with the sampled latent
the same bits whether a profiler is open or not."""

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_parity import shrunk_cfg, shrunk_flagship_cfg
from multimodal_diffusion_torch.infer.sample_clip import build_components, sample_one_direction
from multimodal_diffusion_torch.utils import profiling as TP

STEPS = 3


def spans_since(t0_ns: int):
    """The ring's spans of this thread that opened at or after t0_ns."""
    me = threading.get_ident()
    return [s for s in TP.spans() if s.start_ns >= t0_ns and s.thread == me]


def span_elsewhere():
    with TP.span("elsewhere"):
        pass


def test_spans_nest_by_thread():
    t0 = time.time_ns()
    with TP.span("outer"):
        with TP.span("inner"):
            pass
        worker = threading.Thread(target=span_elsewhere)
        worker.start()
        worker.join(timeout=10)
        assert not worker.is_alive()
        with TP.span("inner2"):
            with TP.span("innermost"):
                pass
    mine = {s.name: s for s in spans_since(t0)}
    assert list(mine) == ["inner", "innermost", "inner2", "outer"]  # in the order they end
    assert mine["outer"].parent is None
    assert mine["inner"].parent == mine["inner2"].parent == mine["outer"].id
    assert mine["innermost"].parent == mine["inner2"].id
    for child in ("inner", "inner2"):
        assert mine["outer"].start_ns <= mine[child].start_ns <= mine[child].end_ns \
            <= mine["outer"].end_ns
    other = [s for s in TP.spans() if s.name == "elsewhere" and s.start_ns >= t0]
    assert len(other) == 1 and other[0].parent is None
    assert other[0].thread not in (None, threading.get_ident())
    assert not any(s.profiled for s in mine.values())


def test_ring_keeps_the_newest_spans():
    for i in range(TP.SPAN_RING + 10):
        with TP.span(f"s{i}"):
            pass
    ring = TP.spans()
    assert len(ring) == TP.SPAN_RING
    assert ring[0].name == "s10" and ring[-1].name == f"s{TP.SPAN_RING + 9}"
    assert [s.id for s in ring] == sorted(s.id for s in ring)


def test_a_range_only_while_a_profiler_records(monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counting(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    for _ in range(3):
        with TP.span("unprofiled"):
            torch.ones(4) + 1
    assert opened == []
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with TP.span("profiled"):
                torch.ones(4) + 1
    assert opened == ["profiled"] * 3
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "profiled"]
    assert len(events) == 3
    assert [s.profiled for s in spans_since(t0)] == [True] * 3


def test_ring_interval_encloses_the_profiler_event():
    """The ring's clock is the profiler's (epoch ns): each span's interval
    holds its range's event, within 1 ms at each edge."""
    names = [f"enclosed{i}" for i in range(5)]
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for name in names:
            with TP.span(name):
                torch.ones(64, 64) @ torch.ones(64, 64)
    ring = {s.name: s for s in spans_since(t0)}
    events = {e.name(): e for e in prof.profiler.kineto_results.events() if e.name() in names}
    assert set(events) == set(names)
    for name in names:
        s, e = ring[name], events[name]
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        assert 0 <= start - s.start_ns <= 1_000_000, (name, start - s.start_ns)
        assert 0 <= s.end_ns - end <= 1_000_000, (name, s.end_ns - end)


@pytest.fixture(scope="module")
def models():
    torch.manual_seed(0)
    return {"mouth": (c := shrunk_flagship_cfg(STEPS), build_components(c, device="cpu")),
            "plain": (c := shrunk_cfg(STEPS), build_components(c, device="cpu"))}


def sampled(cfg, model, direction):
    """One call of sample_one_direction on a batch of 2: the sampled latent
    (what it hands the decoder) and the spans of the call."""
    rng = np.random.default_rng(7)
    kept = []
    decode = model.decode_audio if direction == "v2a" else model.decode_video

    def keep(z):
        kept.append(z.clone())
        return decode(z)

    name = "decode_audio" if direction == "v2a" else "decode_video"
    setattr(model, name, keep)
    try:
        t0 = time.time_ns()
        if direction == "v2a":
            frames = rng.integers(0, 256, (2, 8, 32, 32, 3), dtype=np.uint8)
            sample_one_direction(cfg=cfg, model=model, prompt_modality="video",
                                 prompt_video=frames, device="cpu")
        else:
            wav = rng.uniform(-1, 1, (2, 8000)).astype(np.float32)
            sample_one_direction(cfg=cfg, model=model, prompt_modality="audio",
                                 prompt_audio=wav, device="cpu")
        return kept[0], spans_since(t0)
    finally:
        delattr(model, name)


@pytest.mark.parametrize("which,direction", [("mouth", "v2a"), ("mouth", "a2v"),
                                             ("plain", "v2a")])
def test_sample_one_direction_spans(models, which, direction):
    cfg, model = models[which]
    assert model.cfg.mouth_enabled == (which == "mouth")
    stages = ["sample.upload", "sample.vae_encode"]
    if direction == "v2a" and model.cfg.mouth_enabled:
        stages.append("sample.mouth_tokens")
    stages += ["sample.denoise", "sample.decode", "sample.readback"]
    latents = {}
    for profiled in (False, True):
        if profiled:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                latents[profiled], got = sampled(cfg, model, direction)
            names = [e.name() for e in prof.profiler.kineto_results.events()]
            assert names.count("ddim.step") == names.count("ddim.denoiser") == STEPS
            assert names.count("sample.call") == 1
        else:
            latents[profiled], got = sampled(cfg, model, direction)
        assert all(s.profiled == profiled for s in got)
        by_id = {s.id: s for s in got}
        (call,) = [s for s in got if s.name == "sample.call"]
        assert call.parent is None
        children = sorted((s for s in got if s.parent == call.id), key=lambda s: s.start_ns)
        assert [s.name for s in children] == stages
        (loop,) = [s for s in children if s.name == "sample.denoise"]
        steps = [s for s in got if s.name == "ddim.step"]
        assert len(steps) == STEPS and all(s.parent == loop.id for s in steps)
        denoisers = [s for s in got if s.name == "ddim.denoiser"]
        assert len(denoisers) == STEPS
        assert sorted(s.parent for s in denoisers) == sorted(s.id for s in steps)
        assert len(got) == 1 + len(stages) + 2 * STEPS
        for s in got:
            if s.parent is not None:
                p = by_id[s.parent]
                assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    assert torch.equal(latents[False], latents[True])
