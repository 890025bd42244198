"""Peak device memory of the window (``max_memory_allocated`` after a reset
at its start), in GiB."""


def read(trace):
    peak = trace.counters.get("mem.window_peak_bytes")
    return None if not peak else peak / 2 ** 30
