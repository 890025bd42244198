"""Shared arithmetic of the per-layer readers (``portbench/metrics/*.py``).

Each reader takes the traced run's ``TraceData`` and returns a number, or
None where the run holds nothing to read; a share of a roofline or of a
peak is never made up as 0.
"""

from __future__ import annotations

# the port's hand-written kernels, by the __global__ names of its csrc/*.cu
KERNEL1 = ("partial_topk_kernel", "merge_topk_kernel")
KERNEL3 = ("spec_mel_fft_kernel",)


def span_ms(trace, name: str, per: str | None = None) -> float | None:
    """Milliseconds of the spans ``name``, per span, or per ``per`` counted."""
    total, n = trace.span_seconds(name)
    if per is not None:
        n = trace.counters.get(per, 0)
    return None if n == 0 else total * 1e3 / n


def roofline(trace, bound: str, fragments) -> float | None:
    """The counted least time ``bound`` over the device time of the named
    kernels, in percent."""
    dev = trace.device_seconds(fragments)
    if dev is None or not trace.work.get(bound):
        return None
    return 100.0 * trace.work[bound] / dev


def mfu(trace, seconds: float | None = None) -> float | None:
    """Counted FLOPs over ``seconds`` (the window's by default) at the peak
    of the cell's precision, in percent."""
    flops, peak = trace.work.get("flops"), trace.work.get("flops_peak")
    if not flops or not peak:
        return None
    return 100.0 * flops / ((seconds or trace.window_s) * peak)


def idle(trace) -> float | None:
    """The share of the window in which no device operation ran, in percent."""
    if not trace.events:
        return None
    return 100.0 * max(0.0, 1.0 - trace.busy_s / trace.window_s)
