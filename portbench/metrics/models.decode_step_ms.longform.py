"""Device busy milliseconds a beam step of the decoder step (32 blocks,
kernel 4 twice a block, kernel 1): the port's ``beam.decode`` spans timed by
their CUDA events, less the device's idle while the host was launching
them, over the ``beam.decode`` spans (one a step run)."""

from portbench.core import program


def read(trace):
    return program.per(program.busy_ms(trace, ("beam.decode",)),
                       program.span_count("beam.decode"))
