"""decode_step_device_ms: device time of the kernels the host launched
inside the family's ``decode_step`` (``models.llama.decode_step``: #2 and
plain matmuls; its token's embedding not included), over the number of
its calls, from the harness's ``decode_step`` op ranges
(``decoder_ranges``). Nothing is read where no kernel ran there (the
CPU)."""

from port_bench import decoder_ranges

SPANS = {"decode_step": decoder_ranges.SPANS["decode_step"]}


def read(trace, run):
    kernels = decoder_ranges.inside(trace, "decode_step", trace.kernels)
    if not kernels:
        return None
    return sum(o.end - o.start for o in kernels) / len(decoder_ranges.ranges(trace, "decode_step")) / 1e6
