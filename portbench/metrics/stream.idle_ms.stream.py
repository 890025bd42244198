"""Device idle milliseconds a multi-stream tick: the window's idle while
the host's innermost program span was a ``multistream.*`` span, over the
``multistream.tick`` spans."""

from portbench.core import program


def read(trace):
    return program.per(program.idle_ms(trace, "multistream."),
                       program.span_count("multistream.tick"))
