"""Counted FLOPs of the window's updates (three times the forward) over the
window's seconds at the bfloat16 peak, in percent."""

from portbench.core.readers import mfu


def read(trace):
    return mfu(trace)
