"""decoder_device_ms: device time a call of the kernels the host launched
inside ``models.generate.generate`` (the prefill, then the decode window:
token choices and decode steps)."""


def read(trace, run):
    if not any(o.label == "decoder" for o in trace.kernels):
        return None
    return trace.device_time_s("decoder") / trace.calls * 1e3
