"""Kernel 1's share of its roofline at the tick's rows (streams x chunk frames,
D = 384, float32 counted at the TF32 rate), in percent."""

from portbench.core.readers import KERNEL1, roofline


def read(trace):
    return roofline(trace, "topk_bound_s", KERNEL1)
