"""Kernel 4's share of its byte bound: the bytes it has to move over the
search (``core/beam_counts.py``: each window's cross keys and values once a
block and step, each self-cache position once, the step's q, keys, values
and context) at the memory rate, over the device time of its launches
(``beam_attention_kernel``, both entries), in percent."""

from portbench.core.readers import roofline

KERNEL4 = ("beam_attention_kernel",)


def read(trace):
    return roofline(trace, "attn_bound_s", KERNEL4)
