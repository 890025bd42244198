"""Kernel 1's share of its roofline: its counted least time (2·N·D·V at the
peak, or its bytes) over its device time, in percent."""

from portbench.core.readers import KERNEL1, roofline


def read(trace):
    return roofline(trace, "topk_bound_s", KERNEL1)
