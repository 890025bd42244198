"""Kernel 1's share of its roofline at N 640, D 1,280, V 51,866, k 5: its
counted least time (2·N·D·V at the bf16 peak, or its bytes;
``counts.topk_bound``) over its device time, in percent."""

from portbench.core.readers import KERNEL1, roofline


def read(trace):
    return roofline(trace, "topk_bound_s", KERNEL1)
