"""Profiling hooks: ``torch.profiler`` traces written as Chrome trace files
(viewable in Perfetto or ``chrome://tracing``), opt-in by an environment
variable or a context manager."""

from __future__ import annotations

import itertools
import os
from contextlib import contextmanager

import torch
import torch.distributed as dist

ENV_VAR = "MELLOW_TORCH_PROFILE"  # set to a directory to trace every traced block
_CALLS = itertools.count()


@contextmanager
def trace(trace_dir: str | None = None):
    """Trace the enclosed block into a Chrome trace file of its own.

    with profiling.trace("/tmp/mellow_trace"):
        wrapper.generate(...)

    The directory is ``trace_dir``, else ``$MELLOW_TORCH_PROFILE``; with
    neither, the block runs without a profiler. The file is
    ``<dir>/mellow_torch_<pid>_<n>.json`` (``n`` counts this process's
    traces; ``_rank<r>`` is added in a ``torch.distributed`` group). CPU
    activity is recorded, and CUDA activity where a card is present. Raises
    RuntimeError if another ``torch.profiler`` session is active: a nested
    profiler would stop the outer one."""
    trace_dir = trace_dir or os.environ.get(ENV_VAR)
    if not trace_dir:
        yield
        return
    if torch._C._autograd._profiler_enabled():
        raise RuntimeError("profiling.trace: another torch.profiler session is active in this process")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    rank = f"_rank{dist.get_rank()}" if dist.is_available() and dist.is_initialized() else ""
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"mellow_torch_{os.getpid()}_{next(_CALLS)}{rank}.json")
    prof = torch.profiler.profile(activities=activities)
    try:
        with prof:
            yield
    finally:
        prof.export_chrome_trace(path)


def annotate(name: str):
    """A named range in the trace (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)
