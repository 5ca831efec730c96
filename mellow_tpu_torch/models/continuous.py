"""Continuous batching: admit new requests into a live decode batch.

Port of ``mellow_tpu/models/continuous.py``. ``generate`` decodes a fixed
batch until its last row finishes, and ``generate_cascade`` only lets
finished rows out; here a slot freed by a short answer admits a queued
request at the next stage boundary, instead of idling until the batch
drains.

Ragged rows without ragged writes, as in the JAX package:

  * every slot shares one cache write column, ``P + t`` (``P`` the prefix
    length, ``t`` the global decode step), so a decode step writes one
    column for the whole batch;
  * a request admitted at step ``t`` is prefilled at its local positions
    [0, P) and its k/v rows are spliced into columns [t, t + P) of its
    slot; the slot records ``start = t``. Rows are independent under
    causal attention, so the only per-row state a decode step needs is
    the rope table row at the local position ``pos - start`` and a start
    mask: ``llama.decode_step(..., start=)``, which passes it on to the
    bf16 and int8 decode-attention kernels;
  * admission happens on the host between stages; a stage is ``generate``'s
    window core (``generate._decode_loop`` over a ``DecodeState`` with
    ``start``, ``deadline`` and, for per-request sampling, ``knobs``),
    which reads the done mask once a window and ends as soon as enough rows
    are done to be worth admitting into.

Capacity: the cache holds ``P + horizon`` columns. A request of ``max_new``
tokens is admissible while ``t + max_new <= horizon``. When admission
stalls with rows still live, the scheduler rolls the window left by the
oldest live row's start (``roll_window``, one copy of the cache); with no
row live it starts a fresh window (a reset).

Deliberate differences from the JAX package:

  * no power-of-two admission buckets (eager PyTorch compiles nothing per
    shape, as ``generate`` has none);
  * every cache dtype and compute dtype ``generate`` serves, on its routes:
    the bf16 cache under bf16 and the int8 cache under bf16 decode through
    the hand-written kernels with the per-row start (JAX's continuous
    decode keeps its einsum path, whose fused kernel has no start mask);
  * per-request sampling (``per_request=True``) draws through
    ``generate.warp_logits`` with per-row temperature and top_p and the
    exponential race, from the same kept set as JAX's ``_reject_sample``
    but with no miss bound; JAX's refusals are kept for API parity;
  * the sampler's generator runs on across capacity resets (the JAX
    scheduler replays its key after each);
  * no ``admit_quantum``: a stage with a queue ends once one more slot is
    done (the JAX default).

Repetition penalties are refused, as in JAX (a slot's token history spans
requests); the scheduler is llama-family only.
"""

from __future__ import annotations

import copy
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mellow_tpu_torch.models import generate as gen
from mellow_tpu_torch.models import llama
from mellow_tpu_torch.utils.profiling import annotate

# The per-request top_p the JAX package's rejection sampler covers
# (``generate._REJECT_MIN_TOP_P``); kept as a refusal for API parity.
REJECT_MIN_TOP_P = 0.35

# The decode core's state with its ragged-row fields (``start``,
# ``deadline``, and ``knobs`` for per-request sampling) set. Every per-row
# tensor keeps batch (= slots) leading; the cache's batch axis is 1.
ContinuousState = gen.DecodeState


def _frontier(state: ContinuousState) -> int:
    """The shared write column at the state's step: ``P + t``."""
    return state.cache.k.shape[2] - state.tokens.shape[1] + state.t


def empty_state(
    cfg, slots: int, prefix_len: int, horizon: int, *, device, W: int,
    cache_dtype: Optional[str] = None, dtype: torch.dtype = torch.float32,
    rng: Optional[torch.Generator] = None, per_request: bool = False,
) -> ContinuousState:
    """All-idle state: every slot done, its start at ``prefix_len`` (the
    shared write column at t = 0), so an idle slot attends to its current
    token alone, which keeps its dead decode math finite. ``W``: the flush
    window of a windowed cache (``llama.uses_window``). ``per_request``:
    neutral knobs (temperature 1, top_p 1, greedy) in every slot."""
    cache = llama.KVCache.create(cfg, slots, prefix_len + horizon, device, gen.cache_dtype(cache_dtype, dtype))
    window = llama.FlushWindow(cfg, slots, W, prefix_len, device, dtype) if llama.uses_window(cache, dtype) else None
    if rng is None:
        rng = torch.Generator(device=device)
        rng.manual_seed(0)
    knobs = None
    if per_request:
        knobs = (torch.ones((slots,), dtype=torch.float32, device=device),
                 torch.ones((slots,), dtype=torch.float32, device=device),
                 torch.ones((slots,), dtype=torch.bool, device=device))
    return ContinuousState(
        cache=cache, tokens=torch.zeros((slots, horizon), dtype=torch.int32, device=device),
        last_hidden=torch.zeros((slots, cfg.hidden_size), dtype=dtype, device=device), t=0,
        done=torch.ones((slots,), dtype=torch.bool, device=device), rng=rng, window=window,
        start=torch.full((slots,), prefix_len, dtype=torch.int32, device=device),
        deadline=torch.zeros((slots,), dtype=torch.int32, device=device), knobs=knobs)


@torch.no_grad()
def admit(
    params, cfg, state: ContinuousState, slot_idx: torch.Tensor, prefix_embeds: torch.Tensor,
    max_new: torch.Tensor, *, knobs: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    w8a8: bool = False,
) -> Tuple[ContinuousState, int]:
    """Prefill ``prefix_embeds`` (J, P, D) at local positions [0, P) into a
    P-long cache of the state's dtype and splice its k/v rows (and an int8
    cache's scales) into columns [c - P, c) of the slots ``slot_idx`` (J,)
    (distinct), c the shared write column; ``max_new`` (J,) are the
    requests' token budgets and ``knobs`` their (temperature, top_p,
    greedy). Only at a stage boundary, where a windowed cache's window is
    empty. Updates the state in place; returns it and the step at which
    these rows' tokens begin (``state.t``)."""
    J, P, _ = prefix_embeds.shape
    c = _frontier(state)
    if P > c:
        raise ValueError(f"a {P}-position prefix does not fit before the write column {c}")
    if state.window is not None and state.window.count:
        raise ValueError("admission needs an empty flush window (a stage boundary)")
    small = llama.KVCache.create(cfg, J, P, prefix_embeds.device, state.cache.k.dtype)
    x_last = llama.prefill(params, cfg, prefix_embeds, small, w8a8=w8a8)
    idx = slot_idx.to(device=state.done.device, dtype=torch.long)
    for big, block in zip(state.cache, small):
        if big is not None:
            big[:, idx, c - P : c] = block
    state.last_hidden[idx] = x_last.to(state.last_hidden.dtype)
    state.start[idx] = c - P
    state.deadline[idx] = (state.t + max_new.to(state.deadline.device)).to(torch.int32)
    state.done[idx] = False
    if knobs is not None:
        for mine, theirs in zip(state.knobs, knobs):
            mine[idx] = theirs.to(device=mine.device, dtype=mine.dtype)
    return state, state.t


@torch.no_grad()
def roll_window(state: ContinuousState, delta: int) -> ContinuousState:
    """Reclaim the cache columns before the oldest live row: shift every
    per-column buffer left by ``delta`` (the oldest live row's start,
    floored to a multiple of W by the caller, so ``t`` stays aligned to the
    windows). The reclaimed columns wrap to the end as garbage, at or past
    the new write column, which every read masks. Done rows' start pins to
    the new write column (they attend to nothing cached); their deadlines
    may go negative, which keeps them done. Only at a stage boundary,
    where a windowed cache's window is empty (as ``generate._compact_state``
    assumes)."""
    if state.window is not None and state.window.count:
        raise ValueError(f"a flush window holding {state.window.count} rows cannot be rolled")
    new_len = _frontier(state) - delta
    window = None
    if state.window is not None:
        window = copy.copy(state.window)
        window.flushed -= delta
    return state._replace(
        cache=type(state.cache)(*(None if a is None else torch.roll(a, -delta, dims=2) for a in state.cache)),
        tokens=torch.roll(state.tokens, -delta, dims=1), t=state.t - delta, window=window,
        start=torch.where(state.done, new_len, (state.start - delta).clamp_min(0)).to(torch.int32),
        deadline=state.deadline - delta)


@torch.no_grad()
def decode_stage(
    params, cfg, state: ContinuousState, stop_at_done: int, *, horizon: int, stop_token_id: int,
    greedy: bool = True, top_p: float = 0.8, temperature: float = 1.0, top_k: int = 0, W: int = 8,
) -> ContinuousState:
    """Windows of ``generate``'s core over the ragged slots until ``t``
    reaches ``horizon`` or at least ``stop_at_done`` slots are done (slots
    + 1: run to the horizon), checked on the host before each window. Rows
    finish by the stop token or at their deadline; with per-request knobs
    in the state, each row samples with its own."""
    slots = state.done.shape[0]
    return gen._decode_loop(params, cfg, state, family="llama", max_len=horizon, stop_token_id=stop_token_id,
                            greedy=greedy, top_p=top_p, temperature=temperature, top_k=top_k,
                            repetition_penalty=1.0, W=W, alive_threshold=slots - stop_at_done)


class _Slot(NamedTuple):
    rid: int  # request id
    admit_step: int  # the step at which its tokens begin (shifts left with a roll)
    max_new: int


class ContinuousScheduler:
    """Host driver: a fixed bank of decode slots over one live device
    state; requests are admitted into freed slots at stage boundaries.

    Decoder-level (prefix embeddings in, token lists out) and synchronous;
    ``serving.ContinuousBatchingEngine`` wraps it with preprocessing, the
    encoder and a thread. Greedy rows are the tokens of solo ``generate``
    runs; sampled rows are valid draws from one shared generator. Runs on
    ``device`` ("cuda" unless the caller asks for the CPU), where
    ``params`` must lie."""

    def __init__(
        self,
        params,
        cfg,  # LlamaConfig
        *,
        slots: int = 8,
        prefix_len: int,
        horizon: int = 256,
        cache_dtype: Optional[str] = None,  # None: the compute dtype
        dtype: torch.dtype = torch.float32,
        stop_token_id: int,
        greedy: bool = True,
        top_p: float = 0.8,
        temperature: float = 1.0,
        top_k: int = 0,
        W: int = 8,
        rng: Optional[torch.Generator] = None,  # on ``device``; default seed 0
        per_request: bool = False,  # per-request temperature / top_p / greedy
        w8a8: bool = False,  # the W8A8 prefill blocks for int8 weights
        device="cuda",
    ):
        if horizon % W:
            raise ValueError(f"horizon {horizon} must be a multiple of W={W}")
        if per_request and top_k:
            raise ValueError("per_request mode has no per-row top_k; set top_k=0")
        self.params, self.cfg = params, cfg
        self.slots, self.P, self.horizon = slots, prefix_len, horizon
        self.cache_dtype, self.dtype = cache_dtype, dtype
        self.stop_token_id = stop_token_id
        self.greedy, self.top_p = greedy, float(top_p)
        self.temperature, self.top_k, self.W = float(temperature), top_k, W
        self.per_request = per_request
        self.w8a8 = w8a8
        self.device = torch.device(device)
        if rng is None:
            rng = torch.Generator(device=self.device)
            rng.manual_seed(0)
        self._rng = rng
        self.state = self._empty()
        self._slot: List[Optional[_Slot]] = [None] * slots
        # queue items: (rid, prefix (P, D), max_new, (temperature, top_p, greedy))
        self._queue: List[Tuple[int, torch.Tensor, int, Tuple[float, float, bool]]] = []
        self._next_rid = 0
        self._t = 0  # host mirror of state.t
        self._done_host = None  # host mirror of state.done, one fetch a stage
        self.resets = 0  # capacity resets
        self.rolls = 0  # window rolls
        self._steps_rebased = 0  # steps absorbed by rolls and resets: keeps ``clock`` monotonic

    def _empty(self) -> ContinuousState:
        return empty_state(self.cfg, self.slots, self.P, self.horizon, device=self.device, W=self.W,
                           cache_dtype=self.cache_dtype, dtype=self.dtype, rng=self._rng,
                           per_request=self.per_request)

    # -- request intake ------------------------------------------------

    def submit(
        self, prefix_embeds, max_new: int, *,
        temperature: Optional[float] = None, top_p: Optional[float] = None,
        greedy: Optional[bool] = None,
    ) -> int:
        """Queue one request; returns its id. ``prefix_embeds``: (P, D), one
        row (a tensor or an array). The keyword knobs override the
        scheduler's for this request and need ``per_request=True``; a
        sampled request's top_p must be at least ``REJECT_MIN_TOP_P``."""
        if max_new > self.horizon:
            raise ValueError(f"max_new {max_new} exceeds horizon {self.horizon}")
        prefix = torch.as_tensor(prefix_embeds)
        if prefix.shape != (self.P, self.cfg.hidden_size):
            raise ValueError(f"prefix_embeds must be ({self.P}, {self.cfg.hidden_size}), got {tuple(prefix.shape)}")
        has_knobs = any(v is not None for v in (temperature, top_p, greedy))
        if has_knobs and not self.per_request:
            raise ValueError("per-request sampling knobs need per_request=True")
        g = self.greedy if greedy is None else bool(greedy)
        tp = self.top_p if top_p is None else float(top_p)
        tm = self.temperature if temperature is None else float(temperature)
        if self.per_request and not g and tp < REJECT_MIN_TOP_P:
            raise ValueError(f"per-request top_p {tp} below the supported {REJECT_MIN_TOP_P}")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append((rid, prefix, int(max_new), (tm, tp, g)))
        return rid

    # -- internals -------------------------------------------------------

    def _admissible(self, max_new: int) -> bool:
        return self._t + max_new <= self.horizon

    def _admit_batch(self, free: List[int]) -> None:
        """Admit as many queued admissible requests, in order, as fit into
        the ``free`` slots, in one prefill."""
        take, rest = [], []
        for item in self._queue:
            if len(take) < len(free) and self._admissible(item[2]):
                take.append(item)
            else:
                rest.append(item)
        if not take:
            return
        self._queue = rest
        idx = free[: len(take)]
        dev = self.device
        knobs = None
        if self.per_request:
            knobs = tuple(torch.tensor([p[3][i] for p in take], dtype=dt, device=dev)
                          for i, dt in enumerate((torch.float32, torch.float32, torch.bool)))
        self.state, t0 = admit(
            self.params, self.cfg, self.state, torch.tensor(idx, device=dev),
            torch.stack([p[1].to(dev) for p in take]).to(self.dtype),
            torch.tensor([p[2] for p in take], dtype=torch.int32, device=dev), knobs=knobs, w8a8=self.w8a8)
        for slot, (rid, _, max_new, _k) in zip(idx, take):
            self._slot[slot] = _Slot(rid, t0, max_new)
            if self._done_host is not None:
                self._done_host[slot] = False

    def _collect(self, done_host, tokens_host, t_now: int):
        out = []
        for i in range(self.slots):
            s = self._slot[i]
            if s is None or not bool(done_host[i]):
                continue
            hi = min(s.admit_step + s.max_new, t_now)
            row = tokens_host[i, s.admit_step:hi]
            stop = np.nonzero(row == self.stop_token_id)[0]
            out.append((s.rid, row[: stop[0]].tolist() if len(stop) else row.tolist()))
            self._slot[i] = None
        return out

    def _reset(self) -> None:
        """Capacity reset: the window is spent and no row is live; start a
        fresh one (one prefill per request admitted after)."""
        self.state = self._empty()
        self._steps_rebased += self._t
        self._t = 0
        self._done_host = np.ones((self.slots,), bool)
        self.resets += 1

    def _roll(self) -> bool:
        """Admission stalled on capacity with rows still live: reclaim the
        columns before the oldest live row (``roll_window``). Returns True
        if any capacity was reclaimed."""
        live = [s for s in self._slot if s is not None]
        if not live:
            return False
        delta = (min(s.admit_step for s in live) // self.W) * self.W
        if delta <= 0:
            return False
        self.state = roll_window(self.state, delta)
        self._t -= delta
        self._steps_rebased += delta
        self._slot = [None if s is None else s._replace(admit_step=s.admit_step - delta) for s in self._slot]
        self.rolls += 1
        return True

    # -- the drive loop --------------------------------------------------

    def step(self) -> List[Tuple[int, List[int]]]:
        """Admit what fits, run one stage, return the finished (rid,
        token list) pairs. Call until ``idle``."""
        if self._done_host is None:
            with annotate("mellow.host_sync"):
                self._done_host = self.state.done.cpu().numpy().copy()
        done_host = self._done_host
        active = any(s is not None for s in self._slot)
        if self._queue and not any(self._admissible(q[2]) for q in self._queue):
            if active:
                self._roll()
            else:
                self._reset()
                done_host = self._done_host
        free = [i for i in range(self.slots) if bool(done_host[i]) and self._slot[i] is None]
        if self._queue and free:
            self._admit_batch(free)  # updates the done mirror in place
        if all(s is None for s in self._slot):
            return []  # nothing live (the queue may hold inadmissible items)
        # Exit target: with a queue, once one more slot is done; without one,
        # run to the horizon, as the JAX scheduler does (its clock counts
        # those steps).
        target = int(self._done_host.sum()) + 1 if self._queue else self.slots + 1
        self.state = decode_stage(
            self.params, self.cfg, self.state, target, horizon=self.horizon,
            stop_token_id=self.stop_token_id, greedy=self.greedy, top_p=self.top_p,
            temperature=self.temperature, top_k=self.top_k, W=self.W)
        self._t = self.state.t
        with annotate("mellow.host_sync"):
            self._done_host = self.state.done.cpu().numpy().copy()
            tokens = self.state.tokens.cpu().numpy()
        return self._collect(self._done_host, tokens, self._t)

    @property
    def clock(self) -> int:
        """Total decode steps executed (monotonic across rolls and resets)."""
        return self._t + self._steps_rebased

    @property
    def idle(self) -> bool:
        return not self._queue and all(s is None for s in self._slot)

    def run_to_completion(self) -> dict:
        """Drain the queue and the slots; returns {rid: token list}."""
        results = {}
        while not self.idle:
            for rid, toks in self.step():
                results[rid] = toks
        return results
