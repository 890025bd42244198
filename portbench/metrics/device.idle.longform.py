"""The share of the window in which no device operation ran, in percent."""

from portbench.core.readers import idle


def read(trace):
    return idle(trace)
