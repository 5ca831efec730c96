"""swin_block_roofline: the least time of the Swin blocks that ran as kernel
#8 (``mellow_tpu_torch.ops.swin_block.swin_block``, wherever the program
routes a block to it) over the device time of every kernel launched
inside those calls. Each call's work is counted from the shapes its op
range recorded in the trace (``counts.swin_block_flops`` and
``swin_block_bytes``). Nothing is read where no block ran as #8, or no kernel ran (the CPU)."""

from port_bench import counts, peaks


def _shapes(a):
    B, R, R2, C = a["x"].shape
    return {"batch": B, "res": R, "C": C, "hidden": a["p"]["fc1"]["kernel"].shape[-1], "heads": a["num_heads"],
            "window": a["window_size"], "shifted": a["mask"] is not None}


SPANS = {"swin_block": ("mellow_tpu_torch.ops.swin_block", "swin_block", _shapes)}


def read(trace, run):
    calls = trace.op_calls("swin_block")
    if not calls or not trace.kernels:  # not on the route, or no device
        return None
    least, device = 0.0, 0.0
    for s, kernels in calls:
        if not kernels:
            raise RuntimeError(f"a #8 call of shapes {s} launched no kernel the trace saw")
        L, N = s["res"] * s["res"], s["window"] * s["window"]
        ratio = s["hidden"] / s["C"]
        least += peaks.least_seconds(s["batch"] * counts.swin_block_flops(L, s["C"], N, ratio),
                                     counts.swin_block_bytes(s["batch"], L, s["C"], s["heads"], N, s["shifted"], ratio))
        device += sum(o.end - o.start for o in kernels) / 1e9
    return 100.0 * least / device
