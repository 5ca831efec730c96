"""prefill_device_ms: device time a call of the kernels the host launched
inside ``models.generate._init_state`` (the cache's creation, the family's
prefill: #4 and #6 in llama, and the decode state), from the harness's
``init_state`` op ranges (``decoder_ranges``). Nothing is read where no
kernel ran there (the CPU)."""

from port_bench import decoder_ranges

SPANS = {"init_state": decoder_ranges.SPANS["init_state"]}


def read(trace, run):
    kernels = decoder_ranges.inside(trace, "init_state", trace.kernels)
    if not kernels:
        return None
    return sum(o.end - o.start for o in kernels) / trace.calls / 1e6
