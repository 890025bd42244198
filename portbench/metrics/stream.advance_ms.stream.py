"""Device busy milliseconds a multi-stream tick of its device step (the
copies to the device, the encoder, the CTC head through kernel 1): the
port's ``multistream.advance`` spans timed by their CUDA events, less the
device's idle while the host was launching them, over the
``multistream.tick`` spans."""

from portbench.core import program


def read(trace):
    return program.per(program.busy_ms(trace, ("multistream.advance",)),
                       program.span_count("multistream.tick"))
