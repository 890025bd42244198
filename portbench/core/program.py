"""The port's own spans in a traced run, for the per-layer readers
(``portbench/metrics/*.py``).

The port records spans where its work happens
(``opentransformer_tpu_torch/profiling.py``: the beam step, the trainer's
micro-step and update, the multi-stream tick) while a ``torch.profiler``
session is active, which the traced window's is. They are read here after
the window, on the host's ``perf_counter_ns``, the clock of the benchmark's own
spans; ``TraceData.offset_ns`` maps the device trace onto it. Each idle gap
between the device's events is split over the program spans it overlaps:
each part of the gap goes to the innermost span open over it, and a part
no program span holds (the benchmark's own loop, say) is left out.

Every function returns None where the port recorded nothing: a port
without the recorder, or a run whose window held no such span.
"""

from __future__ import annotations


def recorded() -> list | None:
    """The spans the port recorded, or None."""
    try:
        from opentransformer_tpu_torch import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    return read() or None


def per(total: float | None, n) -> float | None:
    """``total`` over ``n``, or None where either is missing or ``n`` is 0."""
    return None if total is None or not n else total / n


def span_count(name: str) -> int | None:
    rec = recorded()
    return None if rec is None else sum(s.name == name for s in rec)


def host_ms(names) -> float | None:
    """Summed host milliseconds of the spans named in ``names``."""
    rec = recorded()
    if rec is None:
        return None
    hits = [s for s in rec if s.name in names]
    return sum(s.end_ns - s.start_ns for s in hits) / 1e6 if hits else None


def device_ms(names) -> float | None:
    """Summed device milliseconds (their CUDA events) of the spans named in
    ``names``; None where none carries them."""
    rec = recorded()
    if rec is None:
        return None
    hits = [s.device_ms for s in rec if s.name in names and s.device_ms is not None]
    return sum(hits) if hits else None


def idle_gaps(events) -> list:
    """The [start, end) device-clock ns between the union of the events."""
    gaps, end = [], None
    for e in sorted(events, key=lambda e: e.start_ns):
        if end is not None and e.start_ns > end:
            gaps.append((end, e.start_ns))
        end = e.end_ns if end is None else max(end, e.end_ns)
    return gaps


def innermost(spans) -> list:
    """[(start, end, name)] in time order: the host clock cut wherever a
    span starts or ends, each piece held by the innermost span open over it
    (the deepest; of equals, the latest started). Pieces no span holds are
    left out."""
    bounds = sorted([(s.start_ns, 1, i) for i, s in enumerate(spans)]
                    + [(s.end_ns, 0, i) for i, s in enumerate(spans)])
    open_, pieces, prev = {}, [], None
    for t, starts, i in bounds:
        if open_ and t > prev:
            inner = max(open_.values(), key=lambda s: (s.depth, s.start_ns))
            pieces.append((prev, t, inner.name))
        if starts:
            open_[i] = spans[i]
        else:
            del open_[i]
        prev = t
    return pieces


def idle_by_span(trace, spans) -> dict:
    """{program span name: idle ns}: each gap of ``trace.events``, mapped
    onto the host clock, split over the pieces of ``innermost(spans)`` it
    overlaps; the part of a gap that no program span holds is left out."""
    pieces = innermost(spans)
    out: dict = {}
    j = 0
    for a, b in idle_gaps(trace.events):
        a, b = a - trace.offset_ns, b - trace.offset_ns
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            lo, hi, name = pieces[k]
            out[name] = out.get(name, 0) + min(b, hi) - max(a, lo)
            k += 1
    return out


def idle_ms(trace, prefix: str) -> float | None:
    """Device idle milliseconds of the window while the host's innermost
    program span had a name starting with ``prefix``."""
    rec = recorded()
    if rec is None or trace is None or not trace.events:
        return None
    by_span = idle_by_span(trace, rec)
    return sum(ns for name, ns in by_span.items() if name.startswith(prefix)) / 1e6


def busy_ms(trace, names) -> float | None:
    """Device busy milliseconds of the spans named in ``names`` (spans
    with no child span): their CUDA events' time (from the stream reaching
    a span's first work to finishing its last) less the device's idle while
    the host was inside them, waiting for the host's launches."""
    rec = recorded()
    timed = device_ms(names)
    if rec is None or timed is None or trace is None or not trace.events:
        return None
    by_span = idle_by_span(trace, rec)
    return timed - sum(by_span.get(name, 0) for name in names) / 1e6
