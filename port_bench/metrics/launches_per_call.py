"""launches_per_call: kernels the device ran a call (the profiler's kernel
events; copies and fills not counted)."""


def read(trace, run):
    if not trace.kernels:
        return None
    return len(trace.kernels) / trace.calls
