"""encoder_device_ms: device time a call of the kernels the host launched
inside ``models.mellow.encode_and_prefix`` (the front-end, HTSAT, the
projection and the prefix's assembly, for both clips)."""


def read(trace, run):
    if not any(o.label == "encoder" for o in trace.kernels):
        return None
    return trace.device_time_s("encoder") / trace.calls * 1e3
