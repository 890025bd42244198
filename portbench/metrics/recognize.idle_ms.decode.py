"""Device idle milliseconds a beam step: the window's idle while the
host's innermost program span was a ``beam.*`` span, over the
``beam.decode`` spans (one a step run)."""

from portbench.core import program


def read(trace):
    return program.per(program.idle_ms(trace, "beam."), program.span_count("beam.decode"))
