"""Autoregressive generation over a static KV cache, in flush windows.

Port of ``mellow_tpu/models/generate.py``. One decode core serves
``generate``, ``generate_stream`` and ``generate_cascade``, as in the JAX
package: ``_init_state`` (the prefill and the loop's state),
``_window_body`` (one flush window: W sub-steps, each a token choice and a
decode step) and ``_decode_loop`` (windows until ``max_len``, or until at
most ``alive_threshold`` rows are unfinished). Semantics:

  * no per-row early exit: rows keep generating after their stop token;
    the done mask is read on the host once per window, and the loop stops
    when every row has emitted a stop token, or at ``max_len``; callers
    trim each row at its first stop token;
  * ``tokens`` is (B, max_len), zeros past the steps run, and
    ``num_steps`` is ``min(t, max_len)`` with ``t`` a multiple of W: the
    JAX package's raw tokens and step count;
  * W is ``effective_window`` for every cache. An int8 cache's window rows,
    and those of a float cache in another dtype than the compute dtype, ride
    in the compute dtype and are written into the cache after the W-th
    sub-step (``llama.FlushWindow``, ``gpt2.FlushWindow``); a cache in the compute dtype is
    written every step, since a pending row in the cache's own dtype would
    change nothing;
  * the cache holds ``P + ceil(max_len / W) * W`` positions. The last
    window runs only the sub-steps below ``max_len`` (the JAX package runs
    all W and drops the tokens past ``max_len``), and the decode step after
    the token at ``max_len - 1`` is skipped: nothing reads its output.

Token choice (``_sample_token``): greedy is the argmax (first index on
ties, as ``jnp.argmax``), after the repetition penalty in the logits' dtype
when one is set. Sampling filters the logits in fp32 with ``warp_logits``
(the HF order: penalty, temperature, top-k, top-p) and draws from the
softmax of what is kept by the exponential race ``argmax(p / q)``, q ~
Exp(1) from an explicit ``torch.Generator``. Neither reads anything back
to the host. The JAX package's sort-free samplers (``_reject_sample``,
``_fast_sample``) are not ported: they exist because a vocabulary-wide sort
was slow on the TPU, and they draw from this distribution; under tied
logits this sampler keeps the whole HF kept set, where ``_fast_sample``'s
top-k keeps a subset.

The compute dtype is the prefix's (float32 parity mode or bfloat16 perf
mode); the rope tables and the logits are in it, and so is the KV cache
unless ``kv_cache_dtype`` names another: "int8" (llama only), or a float
dtype, "float32", "bfloat16" or "float16" (either family, when it differs
from the compute dtype). As in the JAX package, only the bf16 cache under
bf16 and the int8 cache under bf16 decode through kernels; the others take
the plain formulation (``llama.decode_step``, ``gpt2.decode_step``).

The core also carries continuous batching's ragged rows
(``models/continuous.py``): a state with a per-row ``start`` and
``deadline`` decodes each row at its own local positions and marks it done
at its deadline, and per-row ``knobs`` (temperature, top_p, greedy) replace
the call's sampling options.

Under a mesh's model axis (``tp``, a ``parallel.tensor.TP``; llama only)
the decoder runs its TP forms on the rank's parameter shards: the cache
holds the rank's KV heads, the token embedding is the vocab-parallel
lookup, and the token choice and the done check read the gathered logits,
so every rank of the model group takes the same branch. ``generate_stream``
also takes the data group of a DP mesh: it then yields the tokens of every
data rank and runs until every rank's rows are done.

The decode step as a CUDA graph: a llama call on the card in bf16 with a
bf16 cache and no ``tp`` (``generate``, ``generate_stream``, the first
stage of ``generate_cascade``) holds a ``llama.DecodeWorkspace`` for its
batch bucket (``llama.batch_bucket``), cache length and weights while it
runs (``_workspace``): the prefill writes the first B rows of the
workspace's cache, the window takes the workspace's rope tables (no host
copy), and each decode step replays the workspace's graph of the step,
captured at the workspace's first step. A call that finds the workspace
held by another or finds no room for it (``llama.decode_workspace``), a
compacted cascade stage, continuous batching's ragged rows and every other
cache or dtype decode eagerly. ``utils.metrics.GLOBAL`` counts
``decode_graph_captures``, ``decode_graph_replays`` and
``decode_eager_steps`` (each step is one of the last two; replays over all
steps is the graph's hit share).

``family`` picks the decoder (``models/decoders.py``): "llama" (SmolLM2)
or "gpt2". As in the JAX package, the gpt2 family has no int8 cache and no
W8A8 prefill; unlike it, a gpt2 run that would need positions past its
``max_position_embeddings`` raises before the prefill (the JAX gather
clamps them silently).
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Iterator, List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from mellow_tpu_torch.models import gpt2, llama
from mellow_tpu_torch.models.decoders import get_decoder_ops
from mellow_tpu_torch.parallel import sharding
from mellow_tpu_torch.parallel import tensor as tpar
from mellow_tpu_torch.utils import debug
from mellow_tpu_torch.utils.profiling import annotate


CACHE_DTYPES = {"int8": torch.int8, "float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16}


def cache_dtype(kv_cache_dtype: Optional[str], dtype: torch.dtype) -> torch.dtype:
    """The cache's torch dtype for ``kv_cache_dtype`` (None: the compute
    ``dtype``)."""
    if kv_cache_dtype is None:
        return dtype
    if kv_cache_dtype not in CACHE_DTYPES:
        raise ValueError(f"unsupported kv_cache_dtype {kv_cache_dtype!r}; use one of {sorted(CACHE_DTYPES)}")
    return CACHE_DTYPES[kv_cache_dtype]


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


# ---------------------------------------------------------------------------
# token choice
# ---------------------------------------------------------------------------

def seen_mask(tokens: torch.Tensor, valid, vocab_size: int) -> torch.Tensor:
    """(B, V) bool: True where a row holds that token. ``tokens``: (B, T)
    ids; ``valid``: bool broadcastable over (B, T), False entries ignored."""
    ids = torch.where(torch.as_tensor(valid, device=tokens.device).expand(tokens.shape),
                      tokens.long(), vocab_size)
    out = torch.zeros((tokens.shape[0], vocab_size + 1), dtype=torch.bool, device=tokens.device)
    return out.scatter_(1, ids, True)[:, :vocab_size].contiguous()


def _apply_penalty(logits: torch.Tensor, seen: torch.Tensor, repetition_penalty: float) -> torch.Tensor:
    """CTRL/HF repetition penalty: divide positive, multiply negative
    logits of already-seen tokens."""
    pen = torch.where(logits > 0, logits / repetition_penalty, logits * repetition_penalty)
    return torch.where(seen, pen, logits)


def warp_logits(
    logits: torch.Tensor,  # (B, V)
    *,
    top_p=1.0,  # a float, or (B, 1) per row
    temperature=1.0,  # a float, or (B, 1) per row
    top_k: int = 0,
    repetition_penalty: float = 1.0,
    seen: Optional[torch.Tensor] = None,  # (B, V) bool: tokens to penalize
) -> torch.Tensor:
    """The HF logits-processor stack in its default order (repetition
    penalty, temperature, top-k, top-p); removed tokens become -inf. The
    kept set is value-thresholded: every token tied with the k-th or the
    last top-p token is kept, and the top-1 always is. A (B, 1) tensor
    ``top_p`` or ``temperature`` gives each row its own (continuous
    batching's per-request knobs); a tensor ``top_p`` filters every row."""
    if seen is not None and repetition_penalty != 1.0:
        logits = _apply_penalty(logits, seen, repetition_penalty)
    logits = logits / (temperature.clamp_min(1e-6) if torch.is_tensor(temperature) else max(temperature, 1e-6))
    V = logits.shape[-1]
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    if top_k:
        k = min(top_k, V)
        logits = logits.masked_fill(logits < sorted_logits[:, k - 1 : k], float("-inf"))
        sorted_logits = sorted_logits.masked_fill(
            torch.arange(V, device=logits.device) >= top_k, float("-inf"))
    if torch.is_tensor(top_p) or top_p < 1.0:
        probs = torch.softmax(sorted_logits, dim=-1)
        keep = torch.cumsum(probs, dim=-1) - probs < top_p  # exclusive mass
        keep[:, 0] = True
        min_kept = torch.where(keep, sorted_logits, float("inf")).amin(-1, keepdim=True)
        logits = logits.masked_fill(logits < min_kept, float("-inf"))
    return logits


def _sample_token(
    logits: torch.Tensor,  # (B, V)
    *,
    greedy: bool,
    top_p,  # a float, or (B, 1) per row (warp_logits)
    temperature,
    rng: Optional[torch.Generator],
    top_k: int = 0,
    repetition_penalty: float = 1.0,
    seen: Optional[torch.Tensor] = None,  # (B, V) bool: prompt and emitted tokens
) -> torch.Tensor:
    """(B,) int64 token ids, with no host sync. Greedy: temperature, top-k
    and top-p never move the argmax, so only the penalty is applied, in the
    logits' dtype. Sampled: ``warp_logits`` in fp32, then one draw per row
    from the softmax of the kept logits by the exponential race."""
    if greedy:
        if seen is not None and repetition_penalty != 1.0:
            logits = _apply_penalty(logits, seen, repetition_penalty)
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(warp_logits(logits.float(), top_p=top_p, temperature=temperature, top_k=top_k,
                                      repetition_penalty=repetition_penalty, seen=seen), dim=-1)
    q = torch.empty_like(probs).exponential_(generator=rng)
    # A draw of exactly 0 would give 0 / 0 = NaN for a removed token, and
    # argmax takes NaN for the largest value.
    return torch.argmax(probs / q.clamp_min_(torch.finfo(q.dtype).tiny), dim=-1)


# ---------------------------------------------------------------------------
# the decode core
# ---------------------------------------------------------------------------

class DecodeState(NamedTuple):
    """The decode loop's state; also what ``generate_cascade`` compacts
    between stages. Every per-row tensor keeps batch as its leading axis
    (the cache's batch axis is 1). ``tokens``, ``done``, ``seen`` and the
    cache are written in place."""

    cache: object  # llama.KVCache or gpt2.GPT2Cache, P + ML positions
    tokens: torch.Tensor  # (B, ML) int32, ML = max_len rounded up to W
    last_hidden: torch.Tensor  # (B, D): the hidden the next token comes from
    t: int  # steps taken, a multiple of W
    done: torch.Tensor  # (B,) bool
    rng: Optional[torch.Generator]
    seen: Optional[torch.Tensor] = None  # (B, V) bool: the penalty's mask
    window: Optional[llama.FlushWindow] = None  # a windowed cache's window (llama/gpt2.uses_window)
    # Continuous batching's ragged rows (models/continuous.py):
    start: Optional[torch.Tensor] = None  # (B,) int32: each row's first cache column
    deadline: Optional[torch.Tensor] = None  # (B,) int32: a row is done once t reaches it
    knobs: Optional[tuple] = None  # (temperature (B,) fp32, top_p (B,) fp32, greedy (B,) bool)
    workspace: Optional[llama.DecodeWorkspace] = None  # the cache's and rope tables' owner (_workspace)


def _workspace(params, cfg, prefix_embeds: torch.Tensor, *, max_len: int, W: int, kv_cache_dtype,
               family: str, tp):
    """A context holding the call's ``llama.DecodeWorkspace`` (None where the
    call cannot replay the decode-step graph, or ``llama.decode_workspace``
    gives none): a llama call on the card in bf16 with a bf16 cache, no
    ``tp`` and the tripwires off."""
    dtype = prefix_embeds.dtype
    if (family != "llama" or tp is not None or not llama.on_card(prefix_embeds) or dtype != torch.bfloat16
            or cache_dtype(kv_cache_dtype, dtype) != dtype or debug.enabled()):
        return nullcontext()
    B, P, _ = prefix_embeds.shape
    return llama.decode_workspace(params, cfg, B, P + -(-max_len // W) * W, prefix_embeds.device, dtype)


def _init_state(
    params, cfg, prefix_embeds: torch.Tensor, *, max_len: int, kv_cache_dtype, family: str, W: int,
    rng, initial_done, repetition_penalty: float, prompt_tokens, prompt_mask, w8a8: bool, tp=None,
    workspace: Optional[llama.DecodeWorkspace] = None,
) -> DecodeState:
    """Prefill into a cache of ``P + ceil(max_len / W) * W`` positions, and
    the loop's first state. With a penalty, the seen mask starts from the
    prompt's valid ids (HF penalizes the whole input; the audio prefix has
    no ids). ``tp``: the rank's KV heads in the cache and the window.
    ``workspace`` (``_workspace``): its cache instead of a new one."""
    ops = get_decoder_ops(family)
    if tp is not None and family != "llama":
        raise ValueError(f"the {family} decoder has no tensor-parallel form; it runs replicated")
    lcfg = cfg if tp is None else tpar.local_config(cfg, tp)
    B, P, _ = prefix_embeds.shape
    device, dtype = prefix_embeds.device, prefix_embeds.dtype
    ML = -(-max_len // W) * W
    if family == "gpt2" and P + max_len > cfg.max_position_embeddings:
        raise ValueError(
            f"prefix {P} + max_len {max_len} exceeds the decoder's "
            f"{cfg.max_position_embeddings} positions")
    with annotate("mellow.prefill"):
        cache = (workspace.cache if workspace is not None
                 else ops.create_cache(lcfg, B, P + ML, device, cache_dtype(kv_cache_dtype, dtype)))
        window = None
        if family == "llama":
            hidden = ops.prefill(params, cfg, prefix_embeds, cache, w8a8=w8a8, tp=tp)
            if llama.uses_window(cache, dtype):
                window = llama.FlushWindow(lcfg, B, W, P, device, dtype, tp)
        else:
            if w8a8:
                raise ValueError("w8a8 prefill is llama-family only")
            hidden = ops.prefill(params, cfg, prefix_embeds, cache)
            if gpt2.uses_window(cache, dtype):
                window = gpt2.FlushWindow(cfg, B, W, P, device, dtype)
    seen = None
    if repetition_penalty != 1.0:
        V = ops.embed_table(params).shape[0] if tp is None else cfg.vocab_size
        if prompt_tokens is None:
            seen = torch.zeros((B, V), dtype=torch.bool, device=device)
        else:
            valid = True if prompt_mask is None else prompt_mask.to(device)
            seen = seen_mask(prompt_tokens.to(device), valid, V)
    if rng is None:
        rng = torch.Generator(device=device)
        rng.manual_seed(0)
    done = (torch.zeros((B,), dtype=torch.bool, device=device) if initial_done is None
            else initial_done.to(device=device, dtype=torch.bool).clone())
    return DecodeState(cache=cache, tokens=torch.zeros((B, ML), dtype=torch.int32, device=device),
                       last_hidden=hidden, t=0, done=done, rng=rng, seen=seen, window=window,
                       workspace=workspace)


def _window_body(
    params, cfg, state: DecodeState, *, family: str, max_len: int, stop_token_id: int, greedy: bool,
    top_p: float, temperature: float, top_k: int, repetition_penalty: float, W: int, tp=None,
):
    """The one-flush-window step over ``state``'s cache: W sub-steps (choose
    the token at ``t + i``, then the decode step at position ``P + t + i``),
    fewer in the window that reaches ``max_len``. A windowed cache's window
    flushes inside the W-th decode step. Shared by ``_decode_loop`` and
    ``generate_stream``, and by continuous batching's stages, whose state
    has ragged rows: its ``start`` goes to every decode step, a row is done
    once ``t + 1`` reaches its ``deadline``, and its ``knobs`` choose each
    row's token (greedy rows take the argmax of the raw logits; the others
    draw with their own temperature and top_p). ``tp``: the TP forms."""
    ops = get_decoder_ops(family)
    ML = state.tokens.shape[1]
    S_max = state.cache.k.shape[2]
    P = S_max - ML
    embed = ops.embed_table(params)
    if family == "llama":
        if state.workspace is not None:
            cos, sin = state.workspace.cos, state.workspace.sin
        else:
            with annotate("mellow.host_sync"):  # a copy from host memory: it waits for the stream (the prefill)
                cos, sin = llama.rope_device_tables(cfg, S_max, state.last_hidden.dtype, state.last_hidden.device)

        def step(s, tok_embed, pos):
            return ops.decode_step(params, cfg, tok_embed, s.cache, pos, cos, sin, s.window, s.start, tp=tp)

        def logits_of(hidden):
            return llama.logits_from_hidden(params, cfg, hidden, tp)
    else:

        def step(s, tok_embed, pos):
            return ops.decode_step(params, cfg, tok_embed, s.cache, pos, s.window)

        def logits_of(hidden):
            return ops.logits_from_hidden(params, cfg, hidden)

    def choose(s: DecodeState, logits: torch.Tensor) -> torch.Tensor:
        if s.knobs is None:
            return _sample_token(logits, greedy=greedy, top_p=top_p, temperature=temperature, rng=s.rng,
                                 top_k=top_k, repetition_penalty=repetition_penalty, seen=s.seen)
        temp, topp, gmask = s.knobs
        drawn = _sample_token(logits, greedy=False, top_p=topp[:, None], temperature=temp[:, None], rng=s.rng)
        return torch.where(gmask, torch.argmax(logits, dim=-1), drawn)

    def body(s: DecodeState) -> DecodeState:
        with annotate("mellow.decode_window"):
            hidden = s.last_hidden
            for t in range(s.t, min(s.t + W, max_len)):
                with annotate("mellow.token_choice"):
                    logits = logits_of(hidden)
                    tok = choose(s, logits)
                s.tokens[:, t] = tok
                s.done.logical_or_(tok == stop_token_id)
                if s.deadline is not None:
                    s.done.logical_or_(s.deadline <= t + 1)
                if s.seen is not None:
                    s.seen.scatter_(1, tok[:, None], True)
                if t + 1 < max_len:
                    with annotate("mellow.decode_step"):
                        hidden = step(s, embed[tok] if tp is None else tpar.embed(embed, tok, tp), P + t)
            return s._replace(t=s.t + W, last_hidden=hidden)

    return body


def _decode_loop(
    params, cfg, state: DecodeState, *, family: str, max_len: int, stop_token_id: int, greedy: bool,
    top_p: float, temperature: float, top_k: int, repetition_penalty: float, W: int,
    alive_threshold: int = 0, tp=None,
) -> DecodeState:
    """Windows until ``max_len``, or until at most ``alive_threshold`` rows
    are unfinished (0: all done, the plain path; the cascade passes half its
    batch). The done mask is read on the host before each window."""
    body = _window_body(params, cfg, state, family=family, max_len=max_len, stop_token_id=stop_token_id,
                        greedy=greedy, top_p=top_p, temperature=temperature, top_k=top_k,
                        repetition_penalty=repetition_penalty, W=W, tp=tp)
    while state.t < max_len:
        with annotate("mellow.host_sync"):
            alive = int((~state.done).sum())
        if alive <= alive_threshold:
            break
        state = body(state)
    return state


@torch.no_grad()
def generate(
    params: dict,
    cfg,  # LlamaConfig or GPT2Config, matching ``family``
    prefix_embeds: torch.Tensor,  # (B, P, D)
    *,
    max_len: int,
    stop_token_id: int,
    greedy: bool = True,
    top_p: float = 0.8,
    temperature: float = 1.0,
    rng: Optional[torch.Generator] = None,  # on the prefix's device; default seed 0
    kv_cache_dtype: Optional[str] = None,
    initial_done: Optional[torch.Tensor] = None,  # (B,) bool: rows that start done
    family: str = "llama",
    flush_window: Optional[int] = None,
    top_k: int = 0,
    repetition_penalty: float = 1.0,
    prompt_tokens: Optional[torch.Tensor] = None,  # (B, T) ids seeding the penalty's mask
    prompt_mask: Optional[torch.Tensor] = None,  # (B, T) bool: the real (non-pad) ids
    w8a8: bool = False,
    tp=None,  # parallel.tensor.TP: the model group (llama)
) -> GenerateResult:
    """Prefill, then flush windows until every row is done or ``max_len``.
    ``kv_cache_dtype``: None (the compute dtype), "int8" or another float
    dtype (``CACHE_DTYPES``); ``w8a8``: the W8A8 prefill blocks for int8
    weights; ``flush_window``: W, as the JAX package's
    (``effective_window``); ``tp``: the decoder's TP forms."""
    W = effective_window(flush_window, max_len, prefix_embeds.shape[0])
    with _workspace(params, cfg, prefix_embeds, max_len=max_len, W=W, kv_cache_dtype=kv_cache_dtype,
                    family=family, tp=tp) as ws:
        state = _init_state(params, cfg, prefix_embeds, max_len=max_len, kv_cache_dtype=kv_cache_dtype,
                            family=family, W=W, rng=rng, initial_done=initial_done,
                            repetition_penalty=repetition_penalty, prompt_tokens=prompt_tokens,
                            prompt_mask=prompt_mask, w8a8=w8a8, tp=tp, workspace=ws)
        final = _decode_loop(params, cfg, state, family=family, max_len=max_len, stop_token_id=stop_token_id,
                             greedy=greedy, top_p=top_p, temperature=temperature, top_k=top_k,
                             repetition_penalty=repetition_penalty, W=W, tp=tp)
    return GenerateResult(tokens=final.tokens[:, :max_len], num_steps=min(final.t, max_len))


@torch.no_grad()
def generate_stream(
    params: dict,
    cfg,
    prefix_embeds: torch.Tensor,
    *,
    max_len: int,
    stop_token_id: int,
    greedy: bool = True,
    top_p: float = 0.8,
    temperature: float = 1.0,
    rng: Optional[torch.Generator] = None,
    kv_cache_dtype: Optional[str] = None,
    initial_done: Optional[torch.Tensor] = None,
    family: str = "llama",
    flush_window: Optional[int] = None,
    top_k: int = 0,
    repetition_penalty: float = 1.0,
    prompt_tokens: Optional[torch.Tensor] = None,
    prompt_mask: Optional[torch.Tensor] = None,
    w8a8: bool = False,
    tp=None,
    data_group=None,  # a DP mesh's data group: every data rank's rows
) -> Iterator[GenerateResult]:
    """``generate`` one window at a time: yields a snapshot after every
    window, the last one included, its tokens copied to the host (one fetch
    a window). The tokens are ``generate``'s: the same window body. With
    ``data_group``, each snapshot holds the rows of every rank of the group
    in rank order, and the windows go on until every rank's rows are done
    (one all-gather and one all-reduce a window, on every rank)."""
    W = effective_window(flush_window, max_len, prefix_embeds.shape[0])
    with _workspace(params, cfg, prefix_embeds, max_len=max_len, W=W, kv_cache_dtype=kv_cache_dtype,
                    family=family, tp=tp) as ws:
        state = _init_state(params, cfg, prefix_embeds, max_len=max_len, kv_cache_dtype=kv_cache_dtype,
                            family=family, W=W, rng=rng, initial_done=initial_done,
                            repetition_penalty=repetition_penalty, prompt_tokens=prompt_tokens,
                            prompt_mask=prompt_mask, w8a8=w8a8, tp=tp, workspace=ws)
        body = _window_body(params, cfg, state, family=family, max_len=max_len, stop_token_id=stop_token_id,
                            greedy=greedy, top_p=top_p, temperature=temperature, top_k=top_k,
                            repetition_penalty=repetition_penalty, W=W, tp=tp)
        while True:
            state = body(state)
            t = min(state.t, max_len)
            tokens, done = state.tokens[:, :max_len], state.done.all()
            if data_group is not None:
                tokens, done = sharding.gather_rows(tokens, data_group), done.to(torch.int32)
                dist.all_reduce(done, op=dist.ReduceOp.MIN, group=data_group)
            with annotate("mellow.host_sync"):
                snapshot = GenerateResult(tokens=tokens.to("cpu", copy=True), num_steps=t)
                last = t >= max_len or bool(done)
            yield snapshot
            if last:
                return


def _compact_state(state: DecodeState, perm: torch.Tensor) -> DecodeState:
    """Gather the rows ``perm`` into a smaller batch: the cache (and an int8
    cache's scales) along its batch axis, the tokens, the last hidden, the
    done and seen masks. Only at a window boundary, where an int8 cache's
    window holds no row."""
    cache = type(state.cache)(*(None if a is None else a[:, perm] for a in state.cache))
    return state._replace(
        cache=cache, tokens=state.tokens[perm], last_hidden=state.last_hidden[perm], done=state.done[perm],
        seen=None if state.seen is None else state.seen[perm],
        window=None if state.window is None else state.window.select(perm), workspace=None)


@torch.no_grad()
def generate_cascade(
    params: dict,
    cfg,
    prefix_embeds: torch.Tensor,
    *,
    max_len: int,
    stop_token_id: int,
    greedy: bool = True,
    top_p: float = 0.8,
    temperature: float = 1.0,
    rng: Optional[torch.Generator] = None,
    kv_cache_dtype: Optional[str] = None,
    initial_done: Optional[torch.Tensor] = None,
    family: str = "llama",
    flush_window: Optional[int] = None,
    top_k: int = 0,
    repetition_penalty: float = 1.0,
    prompt_tokens: Optional[torch.Tensor] = None,
    prompt_mask: Optional[torch.Tensor] = None,
    w8a8: bool = False,
    min_batch: int = 32,
) -> GenerateResult:
    """``generate`` in stages that drop finished rows. A stage runs the
    same windows until at most half its rows are unfinished (none, at or
    below ``min_batch`` rows); the host then banks the finished rows'
    tokens, gathers the live rows, padded with finished ones, into a batch
    of the next power of two (at least ``min_batch``) and goes on. Every
    live row is at the same position, so the stages need no ragged
    attention.

    Each row's tokens up to its first stop token are ``generate``'s (its
    tokens after the stop may differ; the stop trim drops them). The bits
    can move with the batch on the card, whose products choose their
    algorithm by M; a sampled row's draws differ from ``generate``'s after
    the first compaction. ``num_steps`` is the slowest row's, as
    ``generate``'s."""
    B = prefix_embeds.shape[0]
    device = prefix_embeds.device
    W = effective_window(flush_window, max_len, B)
    with _workspace(params, cfg, prefix_embeds, max_len=max_len, W=W, kv_cache_dtype=kv_cache_dtype,
                    family=family, tp=None) as ws:
        state = _init_state(params, cfg, prefix_embeds, max_len=max_len, kv_cache_dtype=kv_cache_dtype,
                            family=family, W=W, rng=rng, initial_done=initial_done,
                            repetition_penalty=repetition_penalty, prompt_tokens=prompt_tokens,
                            prompt_mask=prompt_mask, w8a8=w8a8, workspace=ws)
        out_tokens = torch.zeros_like(state.tokens)
        orig = torch.arange(B, device=device)  # row of the batch -> row of the request
        cur = B
        while True:
            state = _decode_loop(params, cfg, state, family=family, max_len=max_len, stop_token_id=stop_token_id,
                                 greedy=greedy, top_p=top_p, temperature=temperature, top_k=top_k,
                                 repetition_penalty=repetition_penalty, W=W,
                                 alive_threshold=cur // 2 if cur > min_batch else 0)
            with annotate("mellow.host_sync"):
                done = state.done.cpu()
            if state.t >= max_len or bool(done.all()):
                break
            alive, dropped = torch.nonzero(~done)[:, 0], torch.nonzero(done)[:, 0]
            new_b = max(min_batch, 1 << (len(alive) - 1).bit_length())
            assert new_b < cur, (new_b, cur, len(alive))  # the stage's threshold guarantees it
            dropped = dropped.to(device)
            out_tokens[orig[dropped]] = state.tokens[dropped]
            perm = torch.cat([alive.to(device), dropped[: new_b - len(alive)]])
            state = _compact_state(state, perm)
            orig = orig[perm]
            cur = new_b
    out_tokens[orig] = state.tokens
    return GenerateResult(tokens=out_tokens[:, :max_len], num_steps=min(state.t, max_len))


def tokens_to_lists(result: GenerateResult, stop_token_id: int) -> List[List[int]]:
    """Trim each row at its first stop token (steps >= num_steps excluded)."""
    tokens = result.tokens.cpu().numpy()[:, : result.num_steps]
    out = []
    for row in tokens:
        idx = np.nonzero(row == stop_token_id)[0]
        out.append(row[: idx[0]].tolist() if len(idx) else row.tolist())
    return out
