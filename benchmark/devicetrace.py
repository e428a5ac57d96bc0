"""The profiled stretch of a traced run, read from torch.profiler's events.

``DeviceTrace.of(prof, window_s)`` keeps what the per-layer readers and the
result line need: the device operations (kernels, copies, fills) with their
names and times, the busy time as the union of their intervals, and the
host's operations on the benchmark's own thread, which label the gaps in
which the device sat idle. The events come from
``prof.profiler.kineto_results.events()``: ``key_averages()`` over some
hundred thousand events takes a minute on the card's host.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List



@dataclasses.dataclass
class Op:
    name: str
    start_ns: int
    end_ns: int

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


@dataclasses.dataclass
class DeviceTrace:
    device_ops: List[Op]  # kernels, copies and fills, by start
    kernels: List[Op]
    host_ops: List[Op]  # on the benchmark's thread, by start, outer first
    window_s: float

    @classmethod
    def of(cls, prof, window_s: float) -> "DeviceTrace":
        """The profiler's events; the host operations kept are those on the
        thread that opened the benchmark's spans (named ``bench.*``)."""
        import torch

        events = list(prof.profiler.kineto_results.events())
        # ranges opened on the host (record_function) show on the device too:
        # they are no device operations
        ranges = {e.name() for e in events if e.device_type() != torch.autograd.DeviceType.CUDA
                  and _is_range(e)}
        dev, kern, host = [], [], []
        for e in events:
            op = Op(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if op.name in ranges or _is_range(e):
                    continue
                dev.append(op)
                if not op.name.startswith(("Memcpy", "Memset")):
                    kern.append(op)
            else:
                host.append((op, e.start_thread_id()))
        tids = {tid for op, tid in host if op.name.startswith("bench.")}
        host = sorted((op for op, tid in host if tid in tids),
                      key=lambda o: (o.start_ns, -o.end_ns))
        dev.sort(key=lambda o: o.start_ns)
        kern.sort(key=lambda o: o.start_ns)
        return cls(dev, kern, host, window_s)

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (the union of their
        intervals)."""
        busy, end = 0, None
        for op in self.device_ops:
            if end is None or op.start_ns > end:
                busy += op.end_ns - op.start_ns
                end = op.end_ns
            elif op.end_ns > end:
                busy += op.end_ns - end
                end = op.end_ns
        return busy / 1e9

    def idle_share(self) -> float:
        return 1.0 - self.busy_s() / self.window_s

    def top_device_ops(self, n: int = 10) -> List[List]:
        total: Dict[str, float] = defaultdict(float)
        for op in self.device_ops:
            total[op.name[:160]] += op.seconds
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """Idle seconds between device operations, summed by what the host
        was doing when the device fell idle: the innermost of the
        benchmark's spans and the innermost host operation then active."""
        gaps, end = [], None
        for op in self.device_ops:
            if end is not None and op.start_ns > end:
                gaps.append((end, op.start_ns - end))
            end = op.end_ns if end is None else max(end, op.end_ns)
        total: Dict[str, float] = defaultdict(float)
        stack: List[Op] = []
        i = 0
        for t_ns, dur_ns in gaps:  # both sorted by time: one sweep
            while i < len(self.host_ops) and self.host_ops[i].start_ns <= t_ns:
                op = self.host_ops[i]
                while stack and stack[-1].end_ns < op.start_ns:
                    stack.pop()
                stack.append(op)
                i += 1
            while stack and stack[-1].end_ns < t_ns:
                stack.pop()
            total[_label(stack)] += dur_ns / 1e9
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def _is_range(e) -> bool:
    """A record_function range (the kinds of event differ between torch
    versions: some name the activity, some only flag annotations)."""
    kind = e.activity_type() if hasattr(e, "activity_type") else ""
    flagged = e.is_user_annotation() if hasattr(e, "is_user_annotation") else False
    return flagged or "annotation" in kind or e.name().startswith("bench.")


def _label(stack: List[Op]) -> str:
    if not stack:
        return "host: outside any operation"
    inner = stack[-1].name
    spans = [op.name for op in stack if op.name.startswith("bench.")]
    return inner if not spans or spans[-1] == inner else f"{spans[-1]} > {inner}"
