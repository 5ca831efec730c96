"""answers_per_s: the answers of every call the timed window completed over
the window's seconds (host clock)."""


def read(trace, run):
    if run.window_s <= 0:
        return None
    return sum(len(s.tokens) for s in run.served) / run.window_s
