"""Milliseconds a beam-search step: the spans around the searches over the steps they ran."""

from portbench.core.readers import span_ms


def read(trace):
    return span_ms(trace, "recognize.search", per="decode.steps")
