"""Host milliseconds a beam step in the port's ``beam.decode`` and
``beam.select`` spans (launching the decoder step and the beam's
book-keeping), over the ``beam.decode`` spans (one a step run)."""

from portbench.core import program


def read(trace):
    return program.per(program.host_ms(("beam.decode", "beam.select")),
                       program.span_count("beam.decode"))
