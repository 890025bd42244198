"""Milliseconds a batch in the encoder (front end and blocks): the span around
each call of ``model.encode``."""

from portbench.core.readers import span_ms


def read(trace):
    return span_ms(trace, "models.encode")
