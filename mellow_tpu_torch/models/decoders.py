"""Decoder-family dispatch (``mellow_tpu/models/decoders.py``): the llama
(SmolLM2) and gpt2 families expose create_cache / prefill / decode_step /
logits_from_hidden / embed_table.

The port's families differ from the JAX package's protocol where the port
differs: no ``flush_pending`` (a cache in the compute dtype takes each
step's k/v at once; any other cache flushes its window inside the family's
``decode_step``, through its ``FlushWindow``), and the random init is
``models/mellow.py``'s ``init_params``. The llama step also takes the rope
tables, the prefill its ``w8a8`` flag, and ``forward`` (training's
teacher-forced pass) its ``attention_mask`` where GPT-2's takes
``position_offset``, so ``models/generate.py`` calls the step and the
prefill per family."""

from __future__ import annotations

from types import SimpleNamespace


def get_decoder_ops(family: str) -> SimpleNamespace:
    if family == "llama":
        from mellow_tpu_torch.models import llama as m

        return SimpleNamespace(
            family="llama",
            create_cache=m.KVCache.create,
            prefill=m.prefill,
            decode_step=m.decode_step,
            logits_from_hidden=m.logits_from_hidden,
            embed_table=lambda params: params["embed"],
            forward=m.forward,
        )
    if family == "gpt2":
        from mellow_tpu_torch.models import gpt2 as m

        return SimpleNamespace(
            family="gpt2",
            create_cache=m.GPT2Cache.create,
            prefill=m.prefill,
            decode_step=m.decode_step,
            logits_from_hidden=m.logits_from_hidden,
            embed_table=lambda params: params["wte"],
            forward=m.forward,
        )
    raise ValueError(f"unknown decoder family '{family}' (llama|gpt2)")
