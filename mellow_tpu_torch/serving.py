"""Batched serving engine for the port: the port's own copy of
``BatchingEngine`` from ``mellow_tpu/serving.py`` (the continuous-batching
engine is not ported), whose ``submit`` also takes the wrapper's
``kv_cache_dtype`` (part of the batch key).

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
