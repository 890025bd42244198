"""The benchmark's generator: the 95th percentile of how late a chunk was
pushed after it was due, in milliseconds."""


def read(trace):
    late = trace.counters.get("loadgen.late_p95_s")
    return None if late is None else late * 1e3
