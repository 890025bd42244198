"""Counted FLOPs of the ticks' advanced streams over the ticks' seconds at
the float32 (TF32-rate) peak, in percent."""

from portbench.core.readers import mfu


def read(trace):
    seconds, n = trace.span_seconds("recognize.tick")
    return mfu(trace, seconds) if n else None
