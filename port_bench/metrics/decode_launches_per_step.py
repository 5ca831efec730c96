"""decode_launches_per_step: kernels the device ran of those the host
launched inside the family's ``decode_step`` (``models.llama.decode_step``),
over the number of its calls, from the harness's ``decode_step`` op ranges
(``decoder_ranges``). Counted as ``launches_per_call`` counts: each kernel
once, so a CUDA graph's replay counts every kernel it runs. Nothing is read
where no kernel ran there (the CPU)."""

from port_bench import decoder_ranges

SPANS = {"decode_step": decoder_ranges.SPANS["decode_step"]}


def read(trace, run):
    kernels = decoder_ranges.inside(trace, "decode_step", trace.kernels)
    if not kernels:
        return None
    return len(kernels) / len(decoder_ranges.ranges(trace, "decode_step"))
