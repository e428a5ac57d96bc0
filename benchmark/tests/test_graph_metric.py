"""The reader of the denoiser's graph replays on a made-up span ring: the
window's calls only, records taken under a profiler left out, 0 for a ring
without replays, nothing from an empty ring or from a program without the
ring."""

import pytest

from benchmark import harness
from multimodal_diffusion_torch.utils import profiling as TP

MS = 1_000_000


def reader():
    return harness.load_module("metrics", "graph_replay_share.sample")


class Ring:
    """Sampler calls made up as the program nests their spans; `replays`
    says which steps' denoiser calls replayed a graph."""

    def __init__(self):
        self.records = []

    def add(self, name, start_ms, end_ms, parent=None, profiled=False):
        s = TP.Span(len(self.records), name, int(start_ms * MS), int(end_ms * MS), parent, 1,
                    profiled)
        self.records.append(s)
        return s.id

    def call(self, start, replays, profiled=False):
        call = self.add("sample.call", start, start + 100, None, profiled)
        loop = self.add("sample.denoise", start + 10, start + 90, call, profiled)
        for k, replay in enumerate(replays):
            t = start + 10 + 5 * k
            step = self.add("ddim.step", t, t + 5, loop, profiled)
            den = self.add("ddim.denoiser", t + 1, t + 4, step, profiled)
            if replay:
                self.add("denoiser.replay", t + 2, t + 3, den, profiled)


@pytest.fixture
def ring(monkeypatch):
    r = Ring()
    monkeypatch.setattr(TP, "spans", lambda: list(r.records))
    return r


def test_replay_share_of_the_window_calls(ring):
    read = reader().read
    assert read({"batches": 2}) is None
    ring.call(0, [False, False, True, True])  # a warm-up call: warm-up, capture
    ring.call(1000, [True, True, True, True])
    ring.call(2000, [True, True, True, False])
    ring.call(3000, [False] * 4, profiled=True)
    assert read({"batches": 2}) == pytest.approx(100.0 * 7 / 8)
    assert read({"batches": 1}) == pytest.approx(75.0)
    assert read({}) == pytest.approx(100.0 * 9 / 12)


def test_a_ring_without_replays_reads_zero(ring):
    ring.call(0, [False] * 3)
    ring.call(1000, [False] * 3)
    assert reader().read({"batches": 1}) == 0.0


def test_nothing_without_the_ring(monkeypatch):
    """A program older than the span ring (no utils/profiling.py::spans)."""
    monkeypatch.delattr(TP, "spans")
    assert reader().read({"batches": 3}) is None
