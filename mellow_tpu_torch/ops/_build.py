"""Build the port's CUDA kernels into one shared library and load it.

Every ``mellow_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into ``build/mellow_tpu_torch/libmellow_kernels.so`` beside the
package, at first use, and loaded with ``ctypes``. The sources carry a plain
C interface (no PyTorch headers), so a build takes seconds. The library is
rebuilt when the hash of the sources and flags changes. A failed build
raises with nvcc's stderr; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "mellow_tpu_torch")
LIB_PATH = os.path.join(BUILD_DIR, "libmellow_kernels.so")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return h.hexdigest()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")


def build() -> str:
    """Compile the kernels unless an up-to-date library exists; return its
    path. The build goes to a per-process file that is renamed into place,
    so a concurrent loader never sees a half-written library. A missing
    nvcc raises FileNotFoundError naming the path tried. nvcc's output
    (with ``-Xptxas -v``: registers and shared memory per kernel) is kept
    in ``nvcc.log`` beside the library."""
    sources = _sources()
    digest = _digest(sources)
    stamp = LIB_PATH + ".sha256"
    if os.path.exists(LIB_PATH) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == digest:
                return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    with open(os.path.join(BUILD_DIR, "nvcc.log"), "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, LIB_PATH)
    with open(stamp, "w") as f:
        f.write(digest + "\n")
    return LIB_PATH


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C signatures."""
    lib = ctypes.CDLL(build())
    lib.mellow_log_mel.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p,
    ]
    lib.mellow_log_mel.restype = ctypes.c_int
    return lib
