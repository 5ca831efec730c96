"""Decode-step GQA attention over the port's KV cache: the CUDA kernel
(``csrc/decode_attention.cu``) and its plain PyTorch version.

Port of the TPU kernel ``mellow_tpu/ops/pallas_decode_attention.py``
(``flash_gqa_decode``) for a bf16 cache. The TPU kernel reads a packed
384-lane ``[K | V]`` cache with ``HEAD_PAD`` query rows and a flush window
of extra positions; the port keeps its ``(L, B, S_max, KV, hd)`` cache and
writes the step's k/v before attending, so the math is the same softmax
over positions ``[0, n)``:

    s = (q . k) / sqrt(hd) in fp32;  e = exp(s - max(s));
    o = (e rounded to the input dtype) @ v, accumulated in fp32, / sum(e).

The kernel splits the positions of each (KV head, batch row) over a
thread-block cluster of ``cluster_blocks(n)`` blocks, about
``POSITIONS_PER_BLOCK`` positions each, at most ``MAX_CLUSTER``; the
blocks combine their maxima, sums and partial outputs through distributed
shared memory inside the one launch.

An optional per-row ``start`` ((B,) int32 on the tensors' device) limits
row b to positions ``[start[b], n)``: continuous batching admits a
request's prefix at the cache column where the batch stands, so the
columns before it belong to other requests. The blocks still split
``[0, n)``; a block whose positions all lie below ``start[b]`` holds none.

``decode_attention`` dispatches by device: a CUDA tensor goes through the
kernel (it raises on what the kernel does not take), a CPU tensor through
``decode_attention_plain``. ``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from mellow_tpu_torch.ops._build import check, load_library, refuse_grad
from mellow_tpu_torch.utils.debug import check_outputs

LAUNCHES = 0
KERNELS_PER_CALL = 1
POSITIONS_PER_BLOCK = 48
# The kernel's largest cluster. Above 8 blocks a cluster is non-portable;
# the H100 takes 16, which read faster than 8 on long caches and even with it
# at v0's lengths when the kernel was designed (PERF.md).
MAX_CLUSTER = 16


def start_mask(start: torch.Tensor, n: int) -> torch.Tensor:
    """(B, 1, 1, n) bool: True at the positions below each row's start."""
    return (torch.arange(n, device=start.device) < start[:, None].long())[:, None, None, :]


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n: int,
                           start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, H, hd); k, v (B, S_max, KV, hd), positions [0, n) attended, or
    [start[b], n) for row b with a (B,) ``start``. Returns (B, H, hd) in
    q's dtype; head h = g * (H // KV) + r reads KV head g."""
    B, H, hd = q.shape
    KV = k.shape[2]
    qg = q.float().reshape(B, KV, H // KV, hd)
    s = torch.einsum("bgrd,bngd->bgrn", qg, k[:, :n].float()) * (1.0 / math.sqrt(hd))
    if start is not None:
        s = s.masked_fill(start_mask(start, n), float("-inf"))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bgrn,bngd->bgrd", e.to(q.dtype).float(), v[:, :n].float())
    return (o / e.sum(-1, keepdim=True)).to(q.dtype).reshape(B, H, hd)


def cluster_blocks(n: int) -> int:
    """Blocks per (KV head, batch row) for ``n`` positions."""
    return max(1, min(MAX_CLUSTER, -(-n // POSITIONS_PER_BLOCK)))


def check_start(start: Optional[torch.Tensor], B: int, device) -> None:
    """``start`` is None or a contiguous (B,) int32 tensor on ``device``."""
    if start is not None and (start.shape != (B,) or start.dtype != torch.int32 or start.device != device
                              or not start.is_contiguous()):
        raise ValueError(f"start must be a contiguous ({B},) int32 tensor on {device}, got "
                         f"{tuple(start.shape)} {start.dtype} on {start.device}")


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n: int,
                          start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel on the current stream: q (B, H, hd) contiguous bf16 CUDA;
    k, v (B, S_max, KV, hd) bf16 with contiguous (KV, hd) rows (a layer of
    the cache), split over clusters of ``cluster_blocks(n)`` blocks;
    ``start`` None or (B,) int32 on the device, each ``start[b] < n`` (not
    checked: reading it would sync with the host). Raises on any input it
    does not take and on a failed launch."""
    global LAUNCHES
    refuse_grad("decode_attention_cuda", q, k, v)
    B, H, hd = q.shape
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("decode_attention_cuda needs CUDA tensors")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(f"decode_attention_cuda needs bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"cache layer {tuple(k.shape)} does not match q {tuple(q.shape)}")
    KV = k.shape[2]
    if H % KV or H // KV > 8 or hd not in (8, 16, 32, 64, 128):
        raise ValueError(f"unsupported geometry H={H}, KV={KV}, hd={hd}")
    if not 1 <= n <= k.shape[1]:
        raise ValueError(f"n={n} outside the cache's {k.shape[1]} positions")
    blocks = cluster_blocks(n)
    # Shared memory per block: q, the scores of the block's positions, the
    # warps' partial PV sums and the cluster's partial sums of its outputs.
    if ((H // KV) * (hd + -(-n // blocks) + 5 * hd) + blocks) * 4 > 200 * 1024:
        raise ValueError(f"n={n} over {blocks} blocks exceeds the kernel's shared-memory score buffer")
    if not q.is_contiguous() or k.stride() != v.stride() or k.stride()[2:] != (hd, 1):
        raise ValueError("decode_attention_cuda needs contiguous q and (KV, hd)-contiguous cache rows")
    check_start(start, B, q.device)
    lib = load_library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.mellow_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if start is None else start.data_ptr(), B, H, KV, hd, n,
            k.stride(0), k.stride(1), blocks, torch.cuda.current_stream().cuda_stream,
        )
    check(err, "decode attention kernel")
    LAUNCHES += 1
    check_outputs("decode_attention_cuda", out)
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n: int,
                     start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version otherwise."""
    if q.is_cuda:
        return decode_attention_cuda(q, k, v, n, start)
    return decode_attention_plain(q, k, v, n, start)
