"""decode_idle_ms: idle time a call of the device in the gaps that end with
an operation the host launched inside ``models.generate._decode_loop`` (the
done checks and the decode windows: token choices and decode steps), from
the harness's ``decode_loop`` op ranges (``decoder_ranges``): the device
waiting for the host to dispatch the decode. Gaps as ``TraceView.gaps``
finds them, from the device operations' merged intervals, each put down to
the operation that ends it. Read in the pass with the op ranges, whose host
cost inside the loop is one range a decode step. Nothing is read where no
operation ran there (the CPU)."""

from port_bench import decoder_ranges

SPANS = {"decode_loop": decoder_ranges.SPANS["decode_loop"]}


def read(trace, run):
    loop = {id(o) for o in decoder_ranges.inside(trace, "decode_loop")}
    if not loop:
        return None
    first = {}
    for o in trace.ops:
        first.setdefault(o.start, o)
    idle, t = 0, trace.window[0]
    for s, e in trace.busy_intervals():
        if s > t and id(first[s]) in loop:
            idle += s - t
        t = max(t, e)
    return idle / trace.calls / 1e6
