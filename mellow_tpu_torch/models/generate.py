"""Greedy autoregressive generation over a static KV cache, as a host loop.

Port of the greedy path of ``mellow_tpu/models/generate.py``. Semantics:

  * decoding is greedy: argmax, first index on ties (as ``jnp.argmax``);
  * no per-row early exit: rows keep generating after their stop token, and
    the loop stops when every row has emitted it at least once, or after
    ``max_len`` steps; callers trim each row at its first stop token.

The JAX loop runs in whole flush windows, so its ``num_steps`` is rounded
up to the window and its raw token arrays can run past this loop's; the
stop-trimmed rows are the same.

The compute dtype is the prefix's (float32 parity mode or bfloat16 perf
mode); the rope tables and the logits are in it, and so is the KV cache
unless ``kv_cache_dtype="int8"`` asks for an int8 cache (bf16 only).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from mellow_tpu_torch.config import LlamaConfig
from mellow_tpu_torch.models import llama


class GenerateResult(NamedTuple):
    tokens: torch.Tensor  # (B, max_len) int32; zeros from num_steps on
    num_steps: int  # steps actually executed


@torch.no_grad()
def generate(
    params: dict,
    cfg: LlamaConfig,
    prefix_embeds: torch.Tensor,  # (B, P, D)
    *,
    max_len: int,
    stop_token_id: int,
    kv_cache_dtype: Optional[str] = None,
    w8a8: bool = False,
) -> GenerateResult:
    """Prefill, then per step: logits -> argmax -> done mask -> decode_step
    writing position P + t into the cache. One host sync per step reads the
    done mask. ``kv_cache_dtype``: None (the compute dtype) or "int8";
    ``w8a8``: the W8A8 prefill blocks for int8 weights."""
    B, P, _ = prefix_embeds.shape
    device = prefix_embeds.device
    dtype = prefix_embeds.dtype
    cache_dtype = torch.int8 if kv_cache_dtype == "int8" else dtype
    cache = llama.KVCache.create(cfg, B, P + max_len, device, cache_dtype)
    hidden = llama.prefill(params, cfg, prefix_embeds, cache, w8a8=w8a8)
    cos, sin = llama.rope_device_tables(cfg, P + max_len, dtype, device)

    tokens = torch.zeros((B, max_len), dtype=torch.int32, device=device)
    done = torch.zeros((B,), dtype=torch.bool, device=device)
    t = 0
    while t < max_len:
        next_tok = torch.argmax(llama.logits_from_hidden(params, cfg, hidden), dim=-1)
        tokens[:, t] = next_tok.to(torch.int32)
        done |= next_tok == stop_token_id
        t += 1
        if t == max_len or bool(done.all()):
            break
        hidden = llama.decode_step(params, cfg, params["embed"][next_tok], cache, P + t - 1, cos, sin)
    return GenerateResult(tokens=tokens, num_steps=t)


def tokens_to_lists(result: GenerateResult, stop_token_id: int) -> List[List[int]]:
    """Trim each row at its first stop token (steps >= num_steps excluded)."""
    tokens = result.tokens.cpu().numpy()[:, : result.num_steps]
    out = []
    for row in tokens:
        idx = np.nonzero(row == stop_token_id)[0]
        out.append(row[: idx[0]].tolist() if len(idx) else row.tolist())
    return out
