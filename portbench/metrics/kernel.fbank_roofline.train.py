"""Kernel 3's share of its roofline: its counted bytes (frames and mel matrix
read, log-mel written) at the memory rate over its device time, in percent."""

from portbench.core.readers import KERNEL3, roofline


def read(trace):
    return roofline(trace, "fbank_bound_s", KERNEL3)
