"""Spans, counters and the device trace of a run's window.

A driver times its window with ``Tracer.window()`` and puts spans around its
calls into the port's layers with ``Tracer.span(name)``. In a run with
``--trace 0`` a span costs two host clock reads. With ``--trace 1`` the
window runs under ``torch.profiler`` (CUDA activity only), and a span
synchronises the device at both ends, so that its time holds the layer's
device work. ``TraceData`` is what the per-layer readers
(``portbench/metrics/*.py``) read.
"""

from __future__ import annotations

import bisect
import time
from contextlib import contextmanager
from dataclasses import dataclass, field


def busy_seconds(intervals: list) -> float:
    """The union of [start, end) intervals (ns) in seconds."""
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a >= end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e9


@dataclass
class DeviceEvent:
    name: str
    start_ns: int
    end_ns: int


@dataclass
class TraceData:
    """A traced window: its host length, the device's events, the spans
    (name -> [(start_ns, end_ns)] on the host's ``perf_counter_ns``), the
    counters and the work the benchmark counted from the shapes."""

    window_s: float
    events: list
    spans: dict
    counters: dict = field(default_factory=dict)
    work: dict = field(default_factory=dict)
    offset_ns: int = 0   # device clock minus host clock

    @property
    def busy_s(self) -> float:
        return busy_seconds([(e.start_ns, e.end_ns) for e in self.events])

    def device_seconds(self, fragments) -> float | None:
        """Summed device time of the events whose name holds any of
        ``fragments``; None when no such event ran."""
        hits = [e for e in self.events if any(f in e.name for f in fragments)]
        if not hits:
            return None
        return sum(e.end_ns - e.start_ns for e in hits) / 1e9

    def span_seconds(self, name: str) -> tuple[float, int]:
        """(summed seconds, count) of the spans called ``name``."""
        spans = self.spans.get(name, [])
        return sum(b - a for a, b in spans) / 1e9, len(spans)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps of the device, each named by the innermost span the host was in."""
        by_name: dict = {}
        for e in self.events:
            by_name[e.name] = by_name.get(e.name, 0) + (e.end_ns - e.start_ns)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        end = None
        for e in sorted(self.events, key=lambda e: e.start_ns):
            if end is not None and e.start_ns > end:
                gaps.append((end, e.start_ns))
            end = e.end_ns if end is None else max(end, e.end_ns)
        spans = sorted((a, b, name) for name, ss in self.spans.items() for a, b in ss)
        starts = [s[0] for s in spans]
        by_span: dict = {}
        for a, b in gaps:
            label = host_state(spans, starts, (a + b) // 2 - self.offset_ns)
            by_span[label] = by_span.get(label, 0) + (b - a)
        idle = sorted(by_span.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], ns / 1e9] for n, ns in ops],
                "idle_gaps": [[n, ns / 1e9] for n, ns in idle]}


def host_state(spans: list, starts: list, t_ns: int) -> str:
    """The innermost of the sorted (start, end, name) spans open at ``t_ns``
    (spans nest at most a few deep)."""
    i = bisect.bisect_right(starts, t_ns)
    best, best_len = "outside spans", None
    for a, b, name in spans[max(0, i - 8):i]:
        if a <= t_ns < b and (best_len is None or b - a < best_len):
            best, best_len = name, b - a
    return best


class Tracer:
    """Window, spans and counters of one run."""

    def __init__(self, device, traced: bool):
        self.device = device
        self.traced = traced
        self.spans: dict = {}
        self.counters: dict = {}
        self.work: dict = {}
        self.window_s = 0.0
        self.data: TraceData | None = None
        self._prof = None

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    @contextmanager
    def span(self, name: str):
        if self.traced:
            self.sync()
        a = time.perf_counter_ns()
        try:
            yield
        finally:
            if self.traced:
                self.sync()
            self.spans.setdefault(name, []).append((a, time.perf_counter_ns()))

    def spans_total(self, name: str) -> float:
        """Summed seconds of the spans called ``name``."""
        return sum(b - a for a, b in self.spans.get(name, [])) / 1e9

    def count(self, name: str, n: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def add_work(self, name: str, n: float) -> None:
        self.work[name] = self.work.get(name, 0.0) + float(n)

    @contextmanager
    def window(self):
        """The measured window: synchronised at both ends; traced with
        ``torch.profiler`` when the run is traced."""
        import torch

        self.sync()
        marker_host = None
        if self.traced and self.device.type == "cuda":
            self._prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            self._prof.__enter__()
            marker_host = time.perf_counter_ns()
            torch.ones(1, device=self.device).add_(1)  # the trace's first event
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.sync()
            self.window_s = time.perf_counter() - t0
            if self._prof is not None:
                self._prof.__exit__(None, None, None)
                events = device_events(self._prof)
                offset = min(e.start_ns for e in events) - marker_host if events else 0
                self.data = TraceData(window_s=self.window_s, events=events, spans=self.spans,
                                      counters=self.counters, work=self.work,
                                      offset_ns=offset)
                self._prof = None


def device_events(prof) -> list:
    """The CUDA kernels, copies and memsets of a finished profile."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        start = int(e.start_ns())
        out.append(DeviceEvent(e.name(), start, start + int(e.duration_ns())))
    return out
