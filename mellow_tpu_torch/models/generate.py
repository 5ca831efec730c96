"""Greedy autoregressive generation over a static KV cache, as a host loop.

Port of the greedy path of ``mellow_tpu/models/generate.py``. Semantics:

  * decoding is greedy: argmax, first index on ties (as ``jnp.argmax``);
  * no per-row early exit: rows keep generating after their stop token, and
    the loop stops when every row has emitted it at least once, or after
    ``max_len`` steps; callers trim each row at its first stop token.

The JAX loop runs in whole flush windows, so its ``num_steps`` is rounded
up to the window and its raw token arrays can run past this loop's; the
stop-trimmed rows are the same. An int8 KV cache decodes in the JAX
package's flush windows (``effective_window``: W = 8, or 4 above a batch of
128, at most ``max_len``): a window's rows ride in bf16 and are quantized
into the cache once per window (``llama.FlushWindow``). A float cache is
written every step: its pending rows would be in the cache's own dtype, so
a window changes nothing there.

The compute dtype is the prefix's (float32 parity mode or bfloat16 perf
mode); the rope tables and the logits are in it, and so is the KV cache
unless ``kv_cache_dtype="int8"`` asks for an int8 cache (bf16, llama only).

``family`` picks the decoder (``models/decoders.py``): "llama" (SmolLM2)
or "gpt2". As in the JAX package, the gpt2 family has no int8 cache and no
W8A8 prefill; unlike it, a gpt2 run that would need positions past its
``max_position_embeddings`` raises before the prefill (the JAX gather
clamps them silently).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from mellow_tpu_torch.models import llama
from mellow_tpu_torch.models.decoders import get_decoder_ops


class GenerateResult(NamedTuple):
    tokens: torch.Tensor  # (B, max_len) int32; zeros from num_steps on
    num_steps: int  # steps actually executed


def effective_window(flush_window: Optional[int], max_len: int, batch: int) -> int:
    """The flush window W (``mellow_tpu/models/generate.py``
    ``_effective_window``): ``flush_window``, or by default 8, and 4 for a
    batch above 128; never more than ``max_len``, at least 1."""
    if flush_window is None:
        flush_window = 4 if batch > 128 else 8
    return max(1, min(flush_window, max_len))


@torch.no_grad()
def generate(
    params: dict,
    cfg,  # LlamaConfig or GPT2Config, matching ``family``
    prefix_embeds: torch.Tensor,  # (B, P, D)
    *,
    max_len: int,
    stop_token_id: int,
    kv_cache_dtype: Optional[str] = None,
    w8a8: bool = False,
    family: str = "llama",
    flush_window: Optional[int] = None,
) -> GenerateResult:
    """Prefill, then per step: logits -> argmax -> done mask -> decode_step
    at position P + t. One host sync per step reads the done mask.
    ``kv_cache_dtype``: None (the compute dtype) or "int8"; ``w8a8``: the
    W8A8 prefill blocks for int8 weights; ``flush_window``: the int8
    cache's window, as the JAX package's (``effective_window``)."""
    ops = get_decoder_ops(family)
    B, P, _ = prefix_embeds.shape
    device = prefix_embeds.device
    dtype = prefix_embeds.dtype
    cache_dtype = torch.int8 if kv_cache_dtype == "int8" else dtype
    if family == "llama":
        cache = ops.create_cache(cfg, B, P + max_len, device, cache_dtype)
        hidden = ops.prefill(params, cfg, prefix_embeds, cache, w8a8=w8a8)
        cos, sin = llama.rope_device_tables(cfg, P + max_len, dtype, device)
        window = None
        if cache.quantized:
            W = effective_window(flush_window, max_len, B)
            window = llama.FlushWindow(cfg, B, W, P, device, dtype)

        def step(embeds, pos):
            return ops.decode_step(params, cfg, embeds, cache, pos, cos, sin, window)
    else:
        if P + max_len > cfg.max_position_embeddings:
            raise ValueError(
                f"prefix {P} + max_len {max_len} exceeds the decoder's "
                f"{cfg.max_position_embeddings} positions")
        cache = ops.create_cache(cfg, B, P + max_len, device, cache_dtype)
        if w8a8:
            raise ValueError("w8a8 prefill is llama-family only")
        hidden = ops.prefill(params, cfg, prefix_embeds, cache)

        def step(embeds, pos):
            return ops.decode_step(params, cfg, embeds, cache, pos)

    embed = ops.embed_table(params)
    tokens = torch.zeros((B, max_len), dtype=torch.int32, device=device)
    done = torch.zeros((B,), dtype=torch.bool, device=device)
    t = 0
    while t < max_len:
        next_tok = torch.argmax(ops.logits_from_hidden(params, cfg, hidden), dim=-1)
        tokens[:, t] = next_tok.to(torch.int32)
        done |= next_tok == stop_token_id
        t += 1
        if t == max_len or bool(done.all()):
            break
        hidden = step(embed[next_tok], P + t - 1)
    return GenerateResult(tokens=tokens, num_steps=t)


def tokens_to_lists(result: GenerateResult, stop_token_id: int) -> List[List[int]]:
    """Trim each row at its first stop token (steps >= num_steps excluded)."""
    tokens = result.tokens.cpu().numpy()[:, : result.num_steps]
    out = []
    for row in tokens:
        idx = np.nonzero(row == stop_token_id)[0]
        out.append(row[: idx[0]].tolist() if len(idx) else row.tolist())
    return out
