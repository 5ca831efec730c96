"""prefill_blocks_roofline: the least time of the prefill's attention blocks
(#4: q/k/v projection, causal attention, o projection;
``ops.attn_block.attn_block`` as ``models.llama`` calls it) and MLP blocks
(#6: gate/up, down; ``ops.mlp_block.mlp_block``) over the device time of
every kernel launched inside those calls. Each call's work is counted
from the shapes its op range recorded in the trace (``counts``'
``attn_block_*`` and ``mlp_block_*``, the causal half of the attention).
Nothing is read where neither block ran, or no kernel ran (the CPU)."""

from port_bench import counts, peaks


def _attn(a):
    B, S, D = a["x"].shape
    return {"rows": B, "S": S, "D": D, "H": a["num_heads"], "KV": a["num_kv_heads"], "hd": a["head_dim"]}


def _mlp(a):
    B, S, D = a["x"].shape
    return {"rows": B, "S": S, "D": D, "I": a["w_gate"].shape[-1]}


SPANS = {"attn_block": ("mellow_tpu_torch.models.llama", "attn_block", _attn),
         "mlp_block": ("mellow_tpu_torch.models.llama", "mlp_block", _mlp)}


def _dec(s):
    return {"hidden_size": s["D"], "intermediate_size": s.get("I", 0), "num_heads": s.get("H", 0),
            "num_kv_heads": s.get("KV", 0), "head_dim": s.get("hd", 0)}


def read(trace, run):
    calls = [("attn", c) for c in trace.op_calls("attn_block")] + [("mlp", c) for c in trace.op_calls("mlp_block")]
    if not calls or not trace.kernels:  # off the path, or no device
        return None
    least, device = 0.0, 0.0
    for kind, (s, kernels) in calls:
        if not kernels:
            raise RuntimeError(f"a prefill {kind} block of shapes {s} launched no kernel the trace saw")
        dec, rows, S = _dec(s), s["rows"], s["S"]
        if kind == "attn":
            least += peaks.least_seconds(counts.attn_block_flops(dec, rows, S), counts.attn_block_bytes(dec, rows, S))
        else:
            least += peaks.least_seconds(counts.mlp_block_flops(dec, rows, S), counts.mlp_block_bytes(dec, rows, S))
        device += sum(o.end - o.start for o in kernels) / 1e9
    return 100.0 * least / device
