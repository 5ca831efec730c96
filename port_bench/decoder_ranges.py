"""The decoder split into its prefill, its decode loop and its decode steps,
for the per-layer readers that read one of them (``prefill_device_ms``,
``decode_step_device_ms``, ``decode_idle_ms``, ``decode_launches_per_step``).

Each reader asks the harness (its ``SPANS``) for op ranges around three
program functions, in the second profiled pass (``trace.py``):

  init_state   ``models.generate._init_state``: the cache, the family's
               prefill (#4, #6 in llama) and the decode state
  decode_loop  ``models.generate._decode_loop``: the done checks and the
               decode windows (token choices and decode steps)
  decode_step  ``models.llama.decode_step``: one decode step (#2 and plain
               matmuls), its token's embedding not included

A kernel belongs to a range when the host launched it inside that range or
inside an op range nested in it (a prefill's ``attn_block`` range inside
``init_state``): a kernel's ``op`` is the innermost op range only.
"""

from __future__ import annotations

GENERATE = "mellow_tpu_torch.models.generate"
LLAMA = "mellow_tpu_torch.models.llama"


def _nothing(arguments) -> dict:
    return {}


SPANS = {"init_state": (GENERATE, "_init_state", _nothing),
         "decode_loop": (GENERATE, "_decode_loop", _nothing),
         "decode_step": (LLAMA, "decode_step", _nothing)}


def ranges(view, name: str) -> list:
    """The op ranges ``name`` that start inside the traced window."""
    lo, hi = view.window
    return [s for s in view.op_spans if s.name.partition(":")[0] == name and lo <= s.start <= hi]


def inside(view, name: str, ops=None) -> list:
    """The operations of ``ops`` (every device operation, if None) that the
    host launched inside a range ``name``."""
    outer = ranges(view, name)
    return [o for o in (view.ops if ops is None else ops)
            if o.op is not None and any(s.start <= o.op.start and o.op.end <= s.end for s in outer)]
