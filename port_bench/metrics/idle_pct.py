"""idle_pct: share of the profiled calls' wall time (first call's start to
last call's end, the profiler's host cost included) in which no operation
ran on the device."""


def read(trace, run):
    if not trace.ops or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
