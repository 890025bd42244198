"""Milliseconds a multi-stream tick: the span around each call of ``MultiStreamCTC.tick``."""

from portbench.core.readers import span_ms


def read(trace):
    return span_ms(trace, "recognize.tick")
