"""Device busy milliseconds a beam step of the decoder step through
kernel 1: the port's ``beam.decode`` spans timed by their CUDA events, less
the device's idle while the host was launching them, over the
``beam.decode`` spans (one a step run)."""

from portbench.core import program


def read(trace):
    return program.per(program.busy_ms(trace, ("beam.decode",)),
                       program.span_count("beam.decode"))
