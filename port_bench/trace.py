"""The traced run's reading of the profiler: device operations, the
harness's host ranges, and which range launched each kernel.

The harness marks its own ranges with ``torch.profiler.record_function``
(``port_bench.<name>``): each call, the copy of its inputs to the card, the encoder
(around ``models.mellow.encode_and_prefix``), the decoder (around
``models.generate.generate``) and the copy of the tokens back. A kernel
belongs to the range in which the host launched it: its launch is the
runtime call that shares its correlation id; where the trace has no such
call, the range's projection onto the device timeline decides.

A per-layer metric that reads the work of one program function (its
``SPANS``) has the harness wrap that function in a range of its own,
``port_bench.op.<name>:<JSON of its shapes>``, in a second profiled pass
over the same calls (the ranges' host cost kept out of the first pass,
which gives the device's busy and idle time).
Such a range labels no kernel; each kernel launched inside it carries it
as its ``op``, so a reader finds each call of the function, its shapes
and its kernels in the trace.
"""

from __future__ import annotations

import json
from typing import List, NamedTuple, Optional

PREFIX = "port_bench."
OP = "op."
DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")


class Op(NamedTuple):
    name: str
    kind: str  # "kernel", "gpu_memcpy" or "gpu_memset"
    start: int  # ns
    end: int
    label: str  # the harness range that launched it, or "unattributed"
    op: Optional["Span"] = None  # the innermost op range that launched it


class Span(NamedTuple):
    name: str
    start: int
    end: int


class TraceView(NamedTuple):
    calls: int  # calls profiled
    ops: List[Op]  # device operations inside the traced window, by start
    window: tuple  # (start, end) ns: the profiled calls, first start to last end
    op_spans: List[Span] = []  # the op ranges, "<name>:<JSON>", by start

    @property
    def kernels(self) -> List[Op]:
        return [o for o in self.ops if o.kind == "kernel"]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, merged."""
        out = []
        for o in self.ops:
            if out and o.start <= out[-1][1]:
                out[-1][1] = max(out[-1][1], o.end)
            else:
                out.append([o.start, o.end])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def gaps(self) -> list:
        """[(seconds, label)] of every stretch of the window in which no
        device operation ran, labelled by the range that launched the
        operation ending it ("between_calls" when none of the harness's
        inner ranges holds its launch; "after_last" for the tail)."""
        out = []
        t = self.window[0]
        busy = self.busy_intervals()
        starts = {}
        for o in self.ops:
            starts.setdefault(o.start, o)
        for s, e in busy:
            if s > t:
                op = starts.get(s)
                label = op.label if op is not None and op.label != "call" else "between_calls"
                out.append(((s - t) / 1e9, label))
            t = max(t, e)
        if self.window[1] > t:
            out.append(((self.window[1] - t) / 1e9, "after_last"))
        return out

    def device_time_s(self, label: Optional[str] = None, names=None) -> float:
        """Seconds of kernels launched in range ``label`` (any, if None)
        whose name holds one of ``names`` (any, if None)."""
        return sum((o.end - o.start) for o in self.kernels
                   if (label is None or o.label == label)
                   and (names is None or any(n in o.name for n in names))) / 1e9

    def op_calls(self, name: str) -> list:
        """[(shapes, kernels)] of every call of the op ``name`` in the
        window: the shapes its range recorded, and the kernels launched
        inside it."""
        out = {}
        for s in self.op_spans:
            if s.name.partition(":")[0] == name and self.window[0] <= s.start <= self.window[1]:
                out[s] = []
        for o in self.kernels:
            if o.op in out:
                out[o.op].append(o)
        return [(json.loads(s.name.partition(":")[2]), ks) for s, ks in out.items()]


def _kind(e) -> str:
    """The event's kind: "kernel", "gpu_memcpy", "gpu_memset" or
    "gpu_user_annotation" on the device; "cuda_runtime" for a runtime or
    driver call on the host; else "host". (Read from the event's activity
    type where this torch has it, else from its device and name.)"""
    if hasattr(e, "activity_type"):
        kind = str(e.activity_type()).split(".")[-1].lower()
        return "cuda_runtime" if kind == "cuda_driver" else kind
    name = e.name()
    if str(e.device_type()).endswith("CUDA"):
        if name.startswith(PREFIX) or name.startswith("ProfilerStep"):
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    return "cuda_runtime" if name.startswith("cu") else "host"


def _innermost(spans: List[Span], t: int) -> Optional[Span]:
    best = None
    for s in spans:
        if s.start <= t <= s.end and (best is None or s.end - s.start < best.end - best.start):
            best = s
    return best


def read(prof, calls: int) -> TraceView:
    """The view of a finished ``torch.profiler.profile`` whose active steps
    ran ``calls`` calls, each inside a ``port_bench.call`` range."""
    events = prof.profiler.kineto_results.events()
    host, device_spans, op_spans, runtime, raw_ops = [], [], [], {}, []
    for e in events:
        kind, name = _kind(e), e.name()
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if name.startswith(PREFIX + OP):
            if not kind.startswith("gpu"):
                op_spans.append(Span(name[len(PREFIX + OP):], start, end))
        elif name.startswith(PREFIX):
            span = Span(name[len(PREFIX):], start, end)
            (device_spans if kind.startswith("gpu") else host).append(span)
        elif kind in DEVICE_OPS:
            raw_ops.append((e, kind, name, start, end))
        elif kind == "cuda_runtime":
            runtime[e.correlation_id()] = start
    call_spans = [s for s in host if s.name == "call"]
    if len(call_spans) != calls:
        raise RuntimeError(f"the trace holds {len(call_spans)} call ranges, not the {calls} profiled")
    window = (min(s.start for s in call_spans), max(s.end for s in call_spans))
    ops = []
    for e, kind, name, start, end in raw_ops:
        launch = runtime.get(e.correlation_id(), runtime.get(e.linked_correlation_id()))
        span = _innermost(host, launch) if launch is not None else _innermost(device_spans, start)
        op = _innermost(op_spans, launch) if launch is not None else None
        ops.append(Op(name, kind, start, end, span.name if span is not None else "unattributed", op))
    ops = sorted((o for o in ops if o.end > window[0] and o.start < window[1]), key=lambda o: o.start)
    return TraceView(calls, ops, window, sorted(op_spans, key=lambda s: s.start))


def breakdown(view: TraceView, top: int = 10) -> dict:
    """The device operations that took most time and the idle time by what
    the host was doing, each as [[name, seconds], ...] over the traced
    window, at most ``top`` entries."""
    by_name = {}
    for o in view.ops:
        by_name[o.name] = by_name.get(o.name, 0.0) + (o.end - o.start) / 1e9
    idle = {}
    for seconds, label in view.gaps():
        idle[label] = idle.get(label, 0.0) + seconds
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
    return {"device_ops": rank(by_name), "idle_gaps": rank(idle)}
