"""Serving engines for the port: the port's own copy of ``BatchingEngine``
from ``mellow_tpu/serving.py``, whose ``submit`` also takes the wrapper's
``kv_cache_dtype`` (part of the batch key), and ``ContinuousBatchingEngine``
(``mellow_tpu/serving.py:197``) over the port's
``models/continuous.ContinuousScheduler``.

Concurrent callers submit single examples; a background dispatcher
coalesces them into batches, runs one ``wrapper.generate`` per batch and
resolves each caller's future. Generation parameters are part of the batch
key so mixed workloads never cross-contaminate.

Fairness: requests are kept in PER-KEY FIFO queues and the dispatcher
always serves the key whose head request is oldest, so a mismatched-key
request can never be starved by a stream of new arrivals.

Timeouts: ``submit(..., timeout=...)`` bounds total time-in-system; the
dispatcher expires overdue requests with ``TimeoutError`` instead of
batching them.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mellow_tpu_torch.utils import debug


@dataclass(frozen=True)
class _BatchKey:
    max_len: int
    top_p: float
    temperature: float
    sample: bool
    kv_cache_dtype: Optional[str] = None


@dataclass
class _Request:
    example: Sequence[str]  # [audio1, audio2, prompt]
    key: _BatchKey
    seq: int
    deadline: Optional[float]  # monotonic time; None = no timeout
    future: Future = field(default_factory=Future)


class BatchingEngine:
    def __init__(
        self,
        wrapper,
        max_batch_size: int = 32,
        max_wait_ms: float = 10.0,
        dynamic_batch: bool = True,
    ):
        self.wrapper = wrapper
        self.max_batch_size = max_batch_size
        self.max_wait_s = max_wait_ms / 1000.0
        # Cascade compaction (generate_cascade) lets short answers (1-2-token
        # AQA) stop paying decode steps while long captions in the same batch
        # run on: the serving mix is the heterogeneous workload it reclaims.
        self.dynamic_batch = dynamic_batch
        self._inbox: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._seq = itertools.count()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._running = True
        self._thread.start()

    # ------------------------------------------------------------------

    def submit(
        self,
        audio_path1: str,
        audio_path2: str,
        prompt: str,
        *,
        max_len: int = 300,
        top_p: float = 0.8,
        temperature: float = 1.0,
        sample: bool = False,
        timeout: Optional[float] = None,  # seconds in-system before the
        # dispatcher fails the request with TimeoutError
        kv_cache_dtype: Optional[str] = None,  # passed to wrapper.generate
    ) -> Future:
        """Non-blocking: returns a Future resolving to the generated str."""
        if not self._running:
            raise RuntimeError("engine is shut down")
        req = _Request(
            [audio_path1, audio_path2, prompt],
            _BatchKey(max_len, top_p, temperature, sample, kv_cache_dtype),
            next(self._seq),
            None if timeout is None else time.monotonic() + timeout,
        )
        self._inbox.put(req)
        return req.future

    def generate(self, *args, timeout: Optional[float] = None, **kwargs) -> str:
        """Blocking convenience wrapper around submit()."""
        return self.submit(*args, timeout=timeout, **kwargs).result(timeout)

    def shutdown(self) -> None:
        self._running = False
        self._inbox.put(None)
        self._thread.join(timeout=30)

    # ------------------------------------------------------------------
    # dispatcher
    # ------------------------------------------------------------------

    def _pull(self, pending: "OrderedDict[_BatchKey, Deque[_Request]]",
              block: bool, deadline: Optional[float]) -> bool:
        """Move inbox arrivals into the per-key queues. Returns False when
        the shutdown sentinel was seen."""
        first = True
        while True:
            try:
                if block and first:
                    req = self._inbox.get(
                        timeout=None if deadline is None else max(0.0, deadline - time.monotonic())
                    )
                else:
                    req = self._inbox.get_nowait()
            except queue.Empty:
                return True
            first = False
            if req is None:
                return False
            pending.setdefault(req.key, deque()).append(req)

    @staticmethod
    def _expire(pending: "OrderedDict[_BatchKey, Deque[_Request]]") -> None:
        now = time.monotonic()
        for key in list(pending):
            q = pending[key]
            live = deque(r for r in q if not (r.deadline and r.deadline < now))
            for r in q:
                if r.deadline and r.deadline < now:
                    r.future.set_exception(
                        TimeoutError("request expired in queue")
                    )
            if live:
                pending[key] = live
            else:
                del pending[key]

    def _loop(self) -> None:
        pending: "OrderedDict[_BatchKey, Deque[_Request]]" = OrderedDict()
        alive = True
        while alive:
            # Block only when idle; with work queued, just sweep arrivals.
            alive = self._pull(pending, block=not pending, deadline=None)
            self._expire(pending)
            if not pending:
                continue
            # FIFO fairness: serve the key whose HEAD request is oldest.
            key = min(pending, key=lambda k: pending[k][0].seq)
            batch_q = pending[key]
            # Wait (bounded) for same-key stragglers while the batch fills.
            wait_until = time.monotonic() + self.max_wait_s
            while alive and len(batch_q) < self.max_batch_size:
                alive = self._pull(pending, block=True, deadline=wait_until)
                if time.monotonic() >= wait_until:
                    break
            batch = [batch_q.popleft() for _ in range(min(len(batch_q), self.max_batch_size))]
            if not batch_q:
                del pending[key]
            self._run(batch)
        # Shutdown: fail anything still queued (predictable teardown beats
        # running an unbounded backlog inside shutdown()'s join window).
        self._pull(pending, block=False, deadline=None)
        for q in pending.values():
            for r in q:
                if not r.future.done():
                    r.future.set_exception(RuntimeError("engine shut down"))

    def _run(self, batch: List[_Request]) -> None:
        key = batch[0].key
        try:
            preds = self.wrapper.generate(
                [r.example for r in batch],
                max_len=key.max_len,
                top_p=key.top_p,
                temperature=key.temperature,
                sample=key.sample,
                kv_cache_dtype=key.kv_cache_dtype,
                dynamic_batch=self.dynamic_batch,
            )
            for r, pred in zip(batch, preds):
                r.future.set_result(pred)
        except Exception as e:  # propagate to every waiter
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)


class ContinuousBatchingEngine:
    """Continuous batching: one live decode batch whose freed slots admit
    queued requests mid-flight (``models/continuous.ContinuousScheduler``),
    instead of coalescing arrivals into batch-at-a-time ``generate`` calls.
    A slot frees the moment its row finishes (at a flush window's end) and
    the next request's prefill splices into the live cache, so a short
    answer batched with long captions does not hold its slot for the whole
    batch.

    Greedy by default with engine-wide decode knobs; per-request
    ``max_len``. With ``per_request=True`` requests may carry their own
    ``sample``, ``temperature`` and ``top_p`` (greedy rows take their
    argmax), drawn from a ``torch.Generator`` seeded by ``seed``. The cache
    dtype is the wrapper's ``kv_cache_dtype`` rule (``MellowWrapper.
    cache_dtype``). Runs where the wrapper runs (the card by default).

    Unlike the JAX engine: each request is preprocessed on its own, so one
    whose wavs cannot be read fails its own future alone; when encoding a
    drained batch or handing it to the scheduler raises, every request of
    that batch fails; a failed stage fails every request in flight and
    starts a fresh scheduler; ``submit`` validates the knobs and
    ``max_len`` itself, so a bad request fails at once. No future is left
    pending: shutdown fails what remains."""

    def __init__(
        self,
        wrapper,
        slots: int = 8,
        horizon: int = 512,
        stop_token: str = "<|endoftext|>",
        kv_cache_dtype: Optional[str] = None,
        flush_window: int = 8,
        per_request: bool = False,
        seed: int = 0,
    ):
        from mellow_tpu_torch.models import continuous

        if wrapper.cfg.decoder_family != "llama":
            raise ValueError("continuous batching is llama-family only")
        if getattr(wrapper, "mesh", None) is not None:
            raise ValueError("continuous batching is single-device; use BatchingEngine under a mesh")
        self.wrapper = wrapper
        self._stop_token = stop_token
        self._per_request = per_request
        self._horizon = horizon
        cache = wrapper.cache_dtype(kv_cache_dtype)
        rng = torch.Generator(device=wrapper.device)
        rng.manual_seed(seed)

        def scheduler():
            return continuous.ContinuousScheduler(
                wrapper.params["decoder"], wrapper.cfg.decoder, slots=slots,
                prefix_len=wrapper.cfg.prefix_length, horizon=horizon,
                stop_token_id=wrapper._stop_token_id(stop_token), cache_dtype=cache, dtype=wrapper.dtype,
                greedy=True, W=flush_window, rng=rng, per_request=per_request, w8a8=wrapper._w8a8,
                device=wrapper.device)

        self._new_scheduler = scheduler
        self._sched = scheduler()
        self._futures: Dict[int, Future] = {}
        self._inbox: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------

    def submit(
        self,
        audio_path1: str,
        audio_path2: str,
        prompt: str,
        *,
        max_len: int = 300,
        timeout: Optional[float] = None,
        sample: bool = False,
        top_p: float = 0.8,
        temperature: float = 1.0,
    ) -> Future:
        """Non-blocking: returns a Future resolving to the generated str.
        Raises ValueError at once on knobs the engine cannot serve."""
        from mellow_tpu_torch.models.continuous import REJECT_MIN_TOP_P

        if not self._running:
            raise RuntimeError("engine is shut down")
        if not 1 <= max_len <= self._horizon:
            raise ValueError(f"max_len {max_len} outside 1..{self._horizon} (the engine's horizon)")
        if sample and not self._per_request:
            raise ValueError("sampled requests need ContinuousBatchingEngine(per_request=True)")
        if sample and not REJECT_MIN_TOP_P <= top_p <= 1.0:
            raise ValueError(f"top_p {top_p} outside [{REJECT_MIN_TOP_P}, 1]")
        if sample and not temperature > 0:
            raise ValueError(f"temperature {temperature} must be positive")
        req = _Request(
            [audio_path1, audio_path2, prompt],
            _BatchKey(max_len, top_p, temperature, sample),
            0,
            None if timeout is None else time.monotonic() + timeout,
        )
        self._inbox.put(req)
        return req.future

    def generate(self, *args, timeout: Optional[float] = None, **kw) -> str:
        return self.submit(*args, timeout=timeout, **kw).result(timeout)

    def shutdown(self) -> None:
        self._running = False
        self._inbox.put(None)
        self._thread.join(timeout=60)

    # ------------------------------------------------------------------

    def _drain(self, block: bool) -> Tuple[List[_Request], bool]:
        out: List[_Request] = []
        first = True
        while True:
            try:
                req = self._inbox.get(timeout=0.05) if block and first else self._inbox.get_nowait()
            except queue.Empty:
                return out, True
            first = False
            if req is None:
                return out, False
            if req.deadline is not None and req.deadline < time.monotonic():
                req.future.set_exception(TimeoutError("request expired in queue"))
                continue
            out.append(req)

    def _encode_and_submit(self, reqs: List[_Request]) -> None:
        """Preprocess each arrival on its own (a failure fails that request
        alone), encode the rest in one batch with ``encode_and_prefix`` and
        hand each prefix row to the scheduler; if the encoder or the
        scheduler raises, every request of the batch fails."""
        from mellow_tpu_torch.models.mellow import encode_and_prefix

        w = self.wrapper
        good, a1, a2 = [], [], []
        for r in reqs:
            try:
                x1 = w.preprocess_audio([r.example[0]], True)
                x2 = w.preprocess_audio([r.example[1]], True)
            except Exception as e:  # noqa: BLE001 - the request's own failure
                if not r.future.done():
                    r.future.set_exception(e)
                continue
            good.append(r)
            a1.append(x1)
            a2.append(x2)
        if not good:
            return
        rids = []
        try:
            ids = w.preprocess_text([r.example[2] for r in good])
            prefix = encode_and_prefix(w.params, w.cfg, *w._device_inputs(np.concatenate(a1), np.concatenate(a2), ids))
            for i, r in enumerate(good):
                kw = {}
                if self._per_request:
                    kw = dict(greedy=not r.key.sample, top_p=r.key.top_p, temperature=r.key.temperature)
                rids.append(self._sched.submit(prefix[i], r.key.max_len, **kw))
        except Exception as e:  # noqa: BLE001 - fail the whole batch
            self._sched._queue = [q for q in self._sched._queue if q[0] not in rids]
            for r in good:
                if not r.future.done():
                    r.future.set_exception(e)
            return
        for rid, r in zip(rids, good):
            self._futures[rid] = r.future

    def _loop(self) -> None:
        from mellow_tpu_torch.utils.metrics import GLOBAL as metrics

        alive = True
        while alive:
            reqs, alive = self._drain(block=self._sched.idle and alive)
            if reqs:
                with debug.checking():
                    self._encode_and_submit(reqs)
            if self._sched.idle:
                continue
            try:
                with debug.checking():
                    finished = self._sched.step()
                for rid, toks in finished:
                    fut = self._futures.pop(rid, None)
                    if fut is not None and not fut.done():
                        text = self.wrapper.tokenizer.decode(toks)
                        fut.set_result(text.split(self._stop_token)[0])
                        metrics.count("continuous_requests", 1)
            except Exception as e:  # noqa: BLE001 - the slot state is suspect: start afresh
                for fut in self._futures.values():
                    if not fut.done():
                        fut.set_exception(e)
                self._futures.clear()
                self._sched = self._new_scheduler()
        # Shutdown: fail whatever remains.
        reqs, _ = self._drain(block=False)
        for fut in [r.future for r in reqs] + list(self._futures.values()):
            if not fut.done():
                fut.set_exception(RuntimeError("engine shut down"))
