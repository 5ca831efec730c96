"""Numeric tripwires: with them on, the first operation that produces a NaN
(or an Inf) raises FloatingPointError naming that operation, before any
later operation reads its output.

The switch is process-wide. Two checks read it:

  * every hand-written kernel's wrapper (``ops/*_cuda``) checks its own
    outputs after the launch (``check_outputs``): the kernels launch
    through ``ctypes``, so torch never sees their outputs;
  * torch operations are checked by a dispatch mode, which torch keeps per
    thread: it runs inside ``checking()``, which the port's request entry
    points enter in whatever thread runs them (``MellowWrapper.generate``
    and ``generate_stream``, and so ``BatchingEngine``'s worker and the
    server; the mesh path's ranks; ``ContinuousBatchingEngine``'s worker).
    Other code, such as a direct call of a model function or training,
    enters ``checking()`` itself.

A NaN is flagged in any operation's output. An Inf is flagged where the
operation made it from finite values (an overflow, a division by zero); an
Inf that was handed to it (a ``-inf`` mask fill) or carried from an input
is not, as the producer was already checked. Outputs of allocations
(``empty``) and views compute nothing and are not checked.

With the tripwires off, each check costs one flag read.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_NANS = False
_INFS = False
_ON = False
_LOCAL = threading.local()  # .active: this thread is inside checking()
_UNCHECKED = {torch.ops.aten.empty, torch.ops.aten.empty_like, torch.ops.aten.empty_strided,
              torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided}


def enable_debug(nans: bool = True, infs: bool = True, disable_jit: bool = False) -> None:
    """Turn on the tripwires, in every thread. ``disable_jit`` is accepted
    for the JAX package's signature and does nothing: eager PyTorch has no
    compiled region to switch off."""
    global _NANS, _INFS, _ON
    _NANS, _INFS = bool(nans), bool(infs)
    _ON = _NANS or _INFS


def disable_debug() -> None:
    global _NANS, _INFS, _ON
    _NANS = _INFS = _ON = False


def enabled() -> bool:
    """Whether the tripwires are on."""
    return _ON


def _floating(x) -> bool:
    return isinstance(x, torch.Tensor) and (x.is_floating_point() or x.is_complex())


def _has_inf(x) -> bool:
    if isinstance(x, float):
        return math.isinf(x)
    return _floating(x) and bool(torch.isinf(x).any())


def _nonfinite(outputs, inputs=None):
    """The kind of the first non-finite value in ``outputs`` to flag
    ("NaN" or "Inf"), or None. With ``inputs`` given, an Inf is flagged
    only if no input holds one."""
    outs = [t for t in outputs if _floating(t)]
    if _NANS and any(bool(torch.isnan(t).any()) for t in outs):
        return "NaN"
    if _INFS and any(bool(torch.isinf(t).any()) for t in outs):
        if inputs is None or not any(_has_inf(x) for x in inputs):
            return "Inf"
    return None


def check_outputs(what: str, *outputs) -> None:
    """Raise FloatingPointError if a kernel's output holds a NaN or an Inf
    that the tripwires flag; ``what`` names the kernel's wrapper."""
    if not _ON:
        return
    kind = _nonfinite(outputs)
    if kind:
        raise FloatingPointError(f"{what}: the kernel's output holds {kind}")


class _Tripwire(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _ON and func.overloadpacket not in _UNCHECKED and not func.is_view:
            kind = _nonfinite(tree_leaves(out), tree_leaves((args, kwargs)))
            if kind:
                raise FloatingPointError(f"{func} produced {kind}")
        return out


@contextlib.contextmanager
def _tripwire():
    _LOCAL.active = True
    try:
        with _Tripwire():
            yield
    finally:
        _LOCAL.active = False


def checking():
    """Check torch operations in this thread for the enclosed block while a
    tripwire is on; a no-op otherwise, and inside another ``checking()``."""
    if not _ON or getattr(_LOCAL, "active", False):
        return contextlib.nullcontext()
    return _tripwire()


def checked(iterator):
    """Yield ``iterator``'s items, each produced inside ``checking()`` (a
    generator's steps run in the consumer's thread, between its other
    work)."""
    while True:
        with checking():
            try:
                item = next(iterator)
            except StopIteration:
                return
        yield item
