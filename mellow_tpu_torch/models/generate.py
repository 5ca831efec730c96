"""Greedy autoregressive generation over a static KV cache, as a host loop.

Port of the greedy path of ``mellow_tpu/models/generate.py``. Semantics:

  * decoding is greedy: argmax, first index on ties (as ``jnp.argmax``);
  * no per-row early exit: rows keep generating after their stop token, and
    the loop stops when every row has emitted it at least once, or after
    ``max_len`` steps; callers trim each row at its first stop token.

The JAX loop runs in whole flush windows, so its ``num_steps`` is rounded
up to the window and its raw token arrays can run past this loop's; the
stop-trimmed rows are the same.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from mellow_tpu.config import LlamaConfig
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
) -> GenerateResult:
    """Prefill, then per step: logits -> argmax -> done mask -> decode_step
    writing position P + t into the cache. One host sync per step reads the
    done mask."""
    B, P, _ = prefix_embeds.shape
    device = prefix_embeds.device
    cache = llama.KVCache.create(cfg, B, P + max_len, device)
    hidden = llama.prefill(params, cfg, prefix_embeds, cache)
    cos_np, sin_np = llama.rope_tables(cfg, P + max_len)
    cos = torch.from_numpy(cos_np).to(device)
    sin = torch.from_numpy(sin_np).to(device)

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
