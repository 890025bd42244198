"""Counted FLOPs of the encodes and the searches (the Conv1d front end,
GELU feed-forwards) over the window's seconds at the bfloat16 peak, in
percent."""

from portbench.core.readers import mfu


def read(trace):
    return mfu(trace)
