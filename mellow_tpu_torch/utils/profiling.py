"""Profiling hooks: ``torch.profiler`` traces written as Chrome trace files
(viewable in Perfetto or ``chrome://tracing``), opt-in by an environment
variable or a context manager, and the program's named spans.

The generate path marks its layer boundaries with ``annotate`` (every name
starts with ``mellow.``):

  mellow.generate_tokens  one call of ``models.mellow.generate_tokens`` or
                          ``generate_tokens_dynamic``: the root of the rest
  mellow.encode           one ``htsat.encode_audio_compact`` call (a clip)
  mellow.prefix           ``build_prefix``
  mellow.prefill          ``generate._init_state``: the cache and the prefill
  mellow.host_sync        a host wait for the device: a read of device
                          state while decoding, or a copy from host memory
                          (which ends in a stream sync) before the prefill
                          and before the decode windows
  mellow.decode_window    one flush window of the decode loop
  mellow.token_choice     one token's logits and choice
  mellow.decode_step      one decode step, its token's embedding included

Under any ``torch.profiler`` session (``trace``, ``MELLOW_TORCH_PROFILE``,
or a caller's own) each is a host range on the profiler's clock, beside the
device's kernels; with none, a span costs one check. A span is a function
range (``torch._C._profiler._RecordFunctionFast``), not a user range
(``record_function``): the profiler copies a user range onto the device
timeline over the kernels launched in it, and a reader that takes every
device event for a kernel would count the spans as device work.
"""

from __future__ import annotations

import itertools
import os
from contextlib import contextmanager, nullcontext

import torch
import torch.distributed as dist

ENV_VAR = "MELLOW_TORCH_PROFILE"  # set to a directory to trace every traced block
_CALLS = itertools.count()
_OFF = nullcontext()
_RANGE = torch._C._profiler._RecordFunctionFast


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
    """A named host range in the trace while a ``torch.profiler`` session is
    active; otherwise a shared null context, with no range built."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return _RANGE(name)
