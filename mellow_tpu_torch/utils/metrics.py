"""Lightweight structured metrics (SURVEY.md section 5.5 — the reference has
only a tqdm bar and a parameter-count print; this provides counters,
decode tokens/sec and generate latency percentiles)."""

from __future__ import annotations

import json
import sys
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List


class Metrics:
    """Process-wide metric registry. Counters + duration histograms."""

    def __init__(self):
        self.counters: Dict[str, float] = defaultdict(float)
        self.durations: Dict[str, List[float]] = defaultdict(list)

    def count(self, name: str, value: float = 1.0) -> None:
        self.counters[name] += value

    @contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.durations[name].append(time.perf_counter() - t0)

    def percentile(self, name: str, q: float) -> float:
        xs = sorted(self.durations.get(name, []))
        if not xs:
            return float("nan")
        idx = min(len(xs) - 1, int(q / 100.0 * len(xs)))
        return xs[idx]

    def rate(self, count_name: str, timer_name: str) -> float:
        total_t = sum(self.durations.get(timer_name, []))
        return self.counters.get(count_name, 0.0) / total_t if total_t else float("nan")

    def summary(self) -> dict:
        out = dict(self.counters)
        for name, xs in self.durations.items():
            if xs:
                out[f"{name}_p50_ms"] = round(1e3 * self.percentile(name, 50), 2)
                out[f"{name}_p95_ms"] = round(1e3 * self.percentile(name, 95), 2)
                out[f"{name}_total_s"] = round(sum(xs), 3)
                out[f"{name}_calls"] = len(xs)
        if "tokens" in self.counters and "generate" in self.durations:
            out["tokens_per_sec"] = round(self.rate("tokens", "generate"), 1)
        return out

    def dump(self, stream=sys.stderr) -> None:
        print(json.dumps(self.summary(), sort_keys=True), file=stream, flush=True)


GLOBAL = Metrics()
