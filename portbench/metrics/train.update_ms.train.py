"""Milliseconds a call of ``Trainer.update`` (norm, clip, Adam): the span around each."""

from portbench.core.readers import span_ms


def read(trace):
    return span_ms(trace, "train.update")
