"""Device idle milliseconds an update: the window's idle while the host's
innermost program span was a ``trainer.*`` span, over the
``trainer.update`` spans."""

from portbench.core import program


def read(trace):
    return program.per(program.idle_ms(trace, "trainer."),
                       program.span_count("trainer.update"))
