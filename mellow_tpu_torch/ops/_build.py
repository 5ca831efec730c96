"""Build the port's CUDA kernels into one shared library and load it.

Every ``mellow_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together, and
the objects are linked into ``libmellow_kernels.so`` in the build directory
(``utils/build_dir.py``: ``build/mellow_tpu_torch/`` in a checkout, the
user's cache directory for an installed package), at first use; the
library is loaded with ``ctypes``.
The sources carry a plain C interface (no PyTorch headers), so a build
takes seconds. The library is rebuilt when the hash of the sources, the
headers they include (``csrc/*.cuh``, ``csrc/*.h``) and the flags changes.
A failed build raises with nvcc's stderr; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess

import torch

from mellow_tpu_torch.utils.build_dir import build_dir

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = build_dir(_PKG_DIR)
LIB_PATH = os.path.join(BUILD_DIR, "libmellow_kernels.so")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", CSRC_DIR,
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# The C entry points and their argument types (every pointer and the
# stream as c_void_p, so ctypes never cuts a pointer to 32 bits).
SIGNATURES = {
    "mellow_log_mel": [_P] * 5 + [_I, _P, _I, _I, _F, _F, _P],
    "mellow_decode_attention": [_P] * 5 + [_I] * 5 + [_L, _I, _I, _P],
    "mellow_attn_block": [_P] * 11 + [_L] + [_P] * 4 + [_L, _P, _P, _L] + [_I] * 6 + [_F, _P],
    "mellow_mlp_block": [_P] * 7 + [_I, _I, _I, _F, _P],
    "mellow_swin_block": [_P] * 20 + [_I, _I, _I, _I, _F, _F, _P],
    "mellow_decode_attention_int8": [_P] * 9 + [_I] * 6 + [_L, _I, _L, _L, _I, _P],
    "mellow_attn_block_w8a8": [_P] * 15 + [_L] + [_P] * 6 + [_L, _P, _P, _L] + [_I] * 6 + [_F, _P],
    "mellow_mlp_block_w8a8": [_P] * 11 + [_I, _I, _I, _F, _P],
    "mellow_flash_gqa_prefill": [_P] * 4 + [_L, _I, _L, _I] + [_I] * 5 + [_P],
    "mellow_window_attention": [_P] * 4 + [_I] * 4 + [_F, _P],
}


def _sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _headers() -> list:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")) + glob.glob(os.path.join(CSRC_DIR, "*.h")))


def _digest(paths) -> str:
    # Flags enter without the absolute include path, so a checkout's
    # location does not force a rebuild.
    flags = [f for f in NVCC_FLAGS if f != CSRC_DIR]
    h = hashlib.sha256(" ".join(flags).encode())
    for path in paths:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return h.hexdigest()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")


def build() -> str:
    """Compile the kernels unless an up-to-date library exists; return its
    path. Objects and the library go to per-process files and the library
    is renamed into place, so a concurrent loader never sees a half-written
    one. A missing nvcc raises FileNotFoundError naming the path tried.
    nvcc's output (with ``-Xptxas -v``: registers and shared memory per
    kernel) is kept in ``nvcc.log`` beside the library."""
    sources = _sources()
    digest = _digest(sources + _headers())
    stamp = LIB_PATH + ".sha256"
    if os.path.exists(LIB_PATH) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == digest:
                return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, os.path.basename(s) + f".{tag}.o") for s in sources]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, s] for s, o in zip(sources, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    results = [(c, p.returncode, out, err) for c, p, (out, err) in zip(cmds, procs, outs)]
    tmp = f"{LIB_PATH}.{tag}"
    link = [nvcc, "-shared", "-o", tmp, *objs]
    failed = [r for r in results if r[1] != 0]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        results.append((link, proc.returncode, proc.stdout, proc.stderr))
        if proc.returncode != 0:
            failed.append(results[-1])
    with open(os.path.join(BUILD_DIR, "nvcc.log"), "w") as f:
        for cmd, _, out, err in results:
            f.write(" ".join(cmd) + "\n" + out + err)
    for o in objs:
        if os.path.exists(o):
            os.unlink(o)
    if failed:
        if os.path.exists(tmp):
            os.unlink(tmp)
        cmd, rc, _, err = failed[0]
        raise RuntimeError(f"nvcc failed (exit {rc}):\n{' '.join(cmd)}\n{err}")
    os.replace(tmp, LIB_PATH)
    with open(stamp, "w") as f:
        f.write(digest + "\n")
    return LIB_PATH


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C signatures."""
    lib = ctypes.CDLL(build())
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def refuse_grad(what: str, *tensors) -> None:
    """Raise if any of ``tensors`` (None allowed) requires grad while
    autograd records: the kernels have no backward (nor do their Pallas
    originals), and a launch would cut the graph without a word. Training
    takes the plain formulations instead."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: the CUDA kernel has no backward, and an input requires grad; "
                           "the training path runs the plain formulation")


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {err}")
