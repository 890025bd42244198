"""Device busy milliseconds a batch of the encode: the port's
``encoder.slice`` spans (the recognizer's encode in slices of bounded
attention scores) timed by their CUDA events, less the device's idle while
the host was inside them, over the batches decoded."""

from portbench.core import program


def read(trace):
    return program.per(program.busy_ms(trace, ("encoder.slice",)),
                       trace.counters.get("decode.batches"))
