"""Host milliseconds a micro-batch in the port's ``trainer.micro_step``
span (features, forward and backward launched)."""

from portbench.core import program


def read(trace):
    return program.per(program.host_ms(("trainer.micro_step",)),
                       program.span_count("trainer.micro_step"))
