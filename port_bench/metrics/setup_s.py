"""setup_s: from the process's start to the first timed call: imports, the
card, the weights, the input pool and the warm-up calls (host clock)."""


def read(trace, run):
    return run.setup_s
