"""The readers of the program's sampler spans, on a made-up span ring and a
made-up device trace: known medians, records taken under a profiler left
out, nothing read from an empty ring or from a program without the ring."""

import pytest

from benchmark import harness
from benchmark.devicetrace import DeviceTrace, Op
from multimodal_diffusion_torch.utils import profiling as TP

MS = 1_000_000


def reader(name):
    return harness.load_module("metrics", name)


class Ring:
    """Spans made up call by call, as the sampler nests them."""

    def __init__(self):
        self.records = []

    def add(self, name, start_ms, end_ms, parent=None, profiled=False):
        s = TP.Span(len(self.records), name, int(start_ms * MS), int(end_ms * MS), parent, 1,
                    profiled)
        self.records.append(s)
        return s.id

    def call(self, start, step_ms, outside_ms, profiled=False):
        """One sampler call: sample.call of outside_ms plus a loop of steps;
        a quarter of outside_ms is the sampler's own set-up before its loop."""
        loop_ms = sum(step_ms)
        call = self.add("sample.call", start, start + outside_ms + loop_ms, None, profiled)
        t = start + outside_ms / 2
        loop = self.add("sample.denoise", t, t + outside_ms / 4 + loop_ms, call, profiled)
        t += outside_ms / 4
        for ms in step_ms:
            step = self.add("ddim.step", t, t + ms, loop, profiled)
            self.add("ddim.denoiser", t, t + ms / 2, step, profiled)
            t += ms


@pytest.fixture
def ring(monkeypatch):
    r = Ring()
    monkeypatch.setattr(TP, "spans", lambda: list(r.records))
    return r


def test_host_ms_per_step_is_the_median_of_unprofiled_steps(ring):
    read = reader("host_ms_per_step.sample").read
    assert read({}) is None
    ring.call(0, [50.0, 50.0], 10.0, profiled=True)
    assert read({}) is None
    ring.call(200, [1.0, 2.0, 3.0], 5.0)
    ring.call(300, [4.0, 100.0], 5.0)
    assert read({}) == pytest.approx(3.0)


def test_outside_loop_ms_is_the_median_of_unprofiled_calls(ring):
    read = reader("outside_loop_ms.sample").read
    assert read({}) is None
    ring.call(0, [1.0, 1.0], 500.0, profiled=True)
    assert read({}) is None
    for k, outside in enumerate((20.0, 5.0, 30.0)):
        ring.call(1000 * (k + 1), [2.0, 3.0], outside)
    assert read({}) == pytest.approx(20.0)


def test_program_readers_read_nothing_without_the_ring(monkeypatch):
    """A program older than the span ring (no utils/profiling.py::spans)."""
    monkeypatch.delattr(TP, "spans")
    for name in ("host_ms_per_step.sample", "outside_loop_ms.sample"):
        assert reader(name).read({}) is None


def op(name, start_ms, end_ms):
    return Op(name, int(start_ms * MS), int(end_ms * MS))


def test_device_ms_per_step_is_busy_time_inside_the_loops():
    """Two profiled calls: their loops run from the first step's start to
    the last one's end; device work before, between and after the loops is
    left out, overlapping work counted once."""
    host = [op("bench.sample_one_direction", 0, 100), op("sample.call", 0, 100),
            op("sample.denoise", 10, 50), op("ddim.step", 10, 30), op("ddim.denoiser", 12, 20),
            op("ddim.step", 30, 50),
            op("bench.sample_one_direction", 100, 200), op("sample.call", 100, 200),
            op("sample.denoise", 120, 150), op("ddim.step", 120, 130), op("ddim.step", 130, 140),
            op("ddim.step", 140, 150)]
    device = [op("encode", 2, 12),  # 2 ms inside the first loop
              op("k1", 15, 25), op("k2", 20, 28),  # 13 ms, overlapping
              op("k3", 45, 60),  # 5 ms inside
              op("decode", 60, 110),  # between the loops
              op("k4", 121, 129), op("k5", 131, 149)]  # 8 + 18 ms
    trace = DeviceTrace(device, device, host, 0.2)
    read = reader("device_ms_per_step.sample").read
    assert read({"trace": trace}) == pytest.approx((2 + 13 + 5 + 8 + 18) / 5)
    assert read({}) is None
    without_spans = [o for o in host if o.name.startswith("bench.")]
    assert read({"trace": DeviceTrace(device, device, without_spans, 0.2)}) is None
    assert read({"trace": DeviceTrace([], [], host, 0.2)}) is None
