"""Host milliseconds a multi-stream tick in its per-slot work: the port's
``multistream.pack`` and ``multistream.collect`` spans, over the
``multistream.tick`` spans."""

from portbench.core import program


def read(trace):
    return program.per(program.host_ms(("multistream.pack", "multistream.collect")),
                       program.span_count("multistream.tick"))
