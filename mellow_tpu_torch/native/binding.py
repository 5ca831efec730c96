"""ctypes binding for the native audio runtime (libmellow_audio.so).

The port's own copy of ``mellow_tpu/native/binding.py``. The library is
compiled from ``src/audio.cc`` with the host C++ compiler into the
package's build directory (``utils/build_dir.py``: the git-ignored
``build/mellow_tpu_torch/`` in a checkout, the user's cache directory for
an installed package), at first use (not beside the source). Without a
toolchain the pure-Python readers in ``mellow_tpu_torch/io`` are used
instead; they are the correctness reference for the native code."""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

from mellow_tpu_torch.utils.build_dir import build_dir

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src", "audio.cc")
_BUILD_DIR = build_dir(os.path.dirname(_DIR))
_LIB_PATH = os.path.join(_BUILD_DIR, "libmellow_audio.so")
_lib = None
_load_attempted = False


def _build() -> bool:
    """Compile to a per-process file and rename it into place, so a
    concurrent loader never sees a half-written library."""
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        subprocess.run(
            [os.environ.get("CXX", "g++"), "-O3", "-fPIC", "-std=c++17", "-shared",
             "-o", tmp, _SRC],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, _LIB_PATH)
        return True
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    stale = os.path.exists(_LIB_PATH) and os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC)
    if (stale or not os.path.exists(_LIB_PATH)) and not _build():
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.mellow_wav_info.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.mellow_wav_info.restype = ctypes.c_int
    lib.mellow_wav_read.argtypes = [
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
    ]
    lib.mellow_wav_read.restype = ctypes.c_int
    lib.mellow_resample.argtypes = [
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ctypes.c_long, ctypes.c_int, ctypes.c_int,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
    ]
    lib.mellow_resample.restype = ctypes.c_long
    lib.mellow_load_segment.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_long, ctypes.c_long,
        ctypes.c_int,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ctypes.POINTER(ctypes.c_long),
    ]
    lib.mellow_load_segment.restype = ctypes.c_int
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Native wav decode -> ((channels, frames) float32, sample_rate)."""
    lib = get_lib()
    assert lib is not None
    ch = ctypes.c_int()
    fr = ctypes.c_long()
    sr = ctypes.c_int()
    rc = lib.mellow_wav_info(path.encode(), ctypes.byref(ch), ctypes.byref(fr), ctypes.byref(sr))
    if rc != 0:
        raise ValueError(f"native wav decode failed ({rc}): {path}")
    out = np.empty((ch.value, fr.value), np.float32)
    rc = lib.mellow_wav_read(path.encode(), out.reshape(-1))
    if rc != 0:
        raise ValueError(f"native wav read failed ({rc}): {path}")
    return out, sr.value


def resample(x: np.ndarray, orig_freq: int, new_freq: int) -> np.ndarray:
    lib = get_lib()
    assert lib is not None
    x = np.ascontiguousarray(x, np.float32)
    cap = int(np.ceil(new_freq * len(x) / orig_freq))
    out = np.empty(cap, np.float32)
    n = lib.mellow_resample(x, len(x), orig_freq, new_freq, out)
    if n < 0:
        raise ValueError(f"native resample failed ({n})")
    return out[:n]


def load_segment(
    path: str, target_sr: int, segment_len: int,
    crop_start: int = -1, do_resample: bool = True,
) -> Tuple[np.ndarray, int, bool]:
    """Decode + resample + repeat-pad/crop in one native call.
    Returns (segment (segment_len,), full_length, needs_crop). When
    needs_crop is True the caller must draw a crop start (reference keeps
    the random draw in Python, wrapper.py:161-167) and call again."""
    lib = get_lib()
    assert lib is not None
    out = np.empty(segment_len, np.float32)
    full = ctypes.c_long()
    rc = lib.mellow_load_segment(
        path.encode(), target_sr, segment_len, crop_start,
        int(do_resample), out, ctypes.byref(full),
    )
    if rc == 1:
        return out, full.value, True
    if rc != 0:
        raise ValueError(f"native load_segment failed ({rc}): {path}")
    return out, full.value, False
