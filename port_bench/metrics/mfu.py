"""mfu: the model's operations of every call the timed window completed
(``counts.call_flops``: encoder with the front-end as its FFT, prefill,
token choices and decode steps, as many as the call ran) over the
window's seconds and the card's bf16 dense peak."""

from port_bench import counts, peaks


def read(trace, run):
    if run.calls == 0 or run.window_s <= 0:
        return None
    flops = sum(counts.call_flops(run.cfg, len(s.tokens), s.steps) for s in run.served)
    return 100.0 * flops / run.window_s / peaks.BF16_FLOPS
