"""Decode-step GQA attention over an int8 KV cache: the CUDA kernel
(``csrc/decode_attention_int8.cu``) and its plain PyTorch version.

Port of the TPU kernel ``mellow_tpu/ops/pallas_decode_attention.py``
``flash_gqa_decode_tiled`` (the group-tiled int8 kernel of the v0 geometry),
which computes the same function as ``flash_gqa_decode``'s int8 branch; only
the TPU lane tiling differs. The port keeps its ``(L, B, S_max, KV, hd)``
cache with fp32 per-position scales ``(L, B, S_max)`` (one per position over
all KV heads, ``llama.quantize_kv``). The flush window's pending rows and
the step's own row ride in bf16 as the E extra positions ``k_extra``,
``v_extra`` ``(B, E, KV, hd)``, 1 <= E <= 8, all live (the TPU kernel's
``extra`` rows below ``n_extra``). Per batch row and query head h of KV
group g, over cached positions n < ``n`` and extra rows x < E:

    qmax = max(max|q_h|, 1e-8);  q8 = round(q_h * (127 / qmax))
    s_n = float(q8 . k8_n) * (qmax * (1/sqrt(hd) / 127)) * ks_n
    s_x = (q_h . k_extra_x) / sqrt(hd)                 fp32 from bf16
    m = max(s, s_x);  e = exp(s - m);  e_x = exp(s_x - m);  d = sum(e) + sum(e_x)
    w = e * vs;  wmax = max(max w, 1e-30);  w8 = trunc(w * (127 / wmax))
    o = (float(w8 . v8) * (wmax / 127) + sum_x bf16(e_x) * v_extra_x) / d, as bf16

The kernel splits the positions of each (KV group, batch row) over a
thread-block cluster of ``cluster_blocks(n)`` blocks (the rule of
``decode_attention.cluster_blocks``: about 48 positions a block, at most
16), which exchange their maxima, sums and int32 partial value sums
through distributed shared memory inside the one launch. Only the order of
the fp32 sum ``d`` depends on the split, so any two cluster sizes agree
within one bf16 ulp, and one block gives the single-block kernel's output
bit for bit.

An optional per-row ``start`` ((B,) int32 on the device) limits row b to
cached positions ``[start[b], n)`` (``decode_attention``'s rule); its extra
rows always lie past it and are always attended.

``decode_attention_int8`` dispatches by device: a CUDA tensor goes through
the kernel (it raises on what the kernel does not take), a CPU tensor
through ``decode_attention_int8_plain``. ``LAUNCHES`` counts the kernel's
launches.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from mellow_tpu_torch.ops._build import check, load_library, refuse_grad
from mellow_tpu_torch.ops.decode_attention import MAX_CLUSTER, check_start, cluster_blocks, start_mask
from mellow_tpu_torch.utils.debug import check_outputs

LAUNCHES = 0
KERNELS_PER_CALL = 1
MAX_EXTRA = 8  # the TPU kernel's EP: the default flush window
THREADS = 128  # a block's threads (csrc ITHREADS)
MAX_SHARED = 200 * 1024  # the dynamic shared memory a launch may ask for (csrc IMAX_DSMEM)
# The most positions whose int32 value sum w8 . v8 cannot overflow
# (|w8|, |v8| <= 127; csrc IMAX_N).
MAX_N = (2 ** 31 - 1) // (127 * 127)


def _score_scale(hd: int) -> float:
    """(1/sqrt(hd)) / 127 in fp32, as the TPU kernel folds it."""
    return float(np.float32(1.0 / math.sqrt(hd)) / np.float32(127.0))


def decode_attention_int8_plain(q, k8, v8, k_scale, v_scale, n: int, k_extra, v_extra,
                                start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, H, hd) bf16; k8, v8 (B, S_max, KV, hd) int8 with positions
    [0, n) attended ([start[b], n) for row b with a (B,) ``start``);
    k_scale, v_scale (B, S_max) fp32; k_extra, v_extra (B, E, KV, hd) bf16,
    the window's pending rows and this step's. Returns (B, H, hd) bf16;
    head h = g * (H // KV) + r reads KV head g."""
    B, H, hd = q.shape
    KV = k8.shape[2]
    scale = 1.0 / math.sqrt(hd)
    qf = q.float().reshape(B, KV, H // KV, hd)
    qmax = qf.abs().amax(-1, keepdim=True).clamp_min(1e-8)
    q8 = torch.round(qf * (127.0 / qmax))
    # Integer dots, exact in float64 as in the kernels' int32 sums.
    s32 = torch.einsum("bgrd,bngd->bgrn", q8.double(), k8[:, :n].double()).float()
    s = s32 * (qmax * _score_scale(hd)) * k_scale[:, None, None, :n]
    if start is not None:
        s = s.masked_fill(start_mask(start, n), float("-inf"))
    kx = k_extra.float().permute(0, 2, 1, 3)  # (B, KV, E, hd)
    vx = v_extra.float().permute(0, 2, 1, 3)
    s_x = (qf[:, :, :, None] * kx[:, :, None]).sum(-1) * scale  # (B, KV, rep, E)
    m = torch.maximum(s.amax(-1, keepdim=True), s_x.amax(-1, keepdim=True))
    e = torch.exp(s - m)
    e_x = torch.exp(s_x - m)
    denom = e.sum(-1, keepdim=True) + e_x.sum(-1, keepdim=True)
    w = e * v_scale[:, None, None, :n]
    wmax = w.amax(-1, keepdim=True).clamp_min(1e-30)
    w8 = torch.trunc(w * (127.0 / wmax))
    o32 = torch.einsum("bgrn,bngd->bgrd", w8.double(), v8[:, :n].double()).float()
    o = o32 * (wmax / 127.0) + torch.einsum("bgrx,bgxd->bgrd", e_x.to(q.dtype).float(), vx)
    return (o / denom).to(q.dtype).reshape(B, H, hd)


def shared_bytes(rep: int, hd: int, n: int, blocks: int) -> int:
    """A block's dynamic shared memory for ``n`` positions over ``blocks``
    blocks (csrc ``int8_smem``, each region rounded up to 16 bytes): the
    slice's fp32 scores, int8 q, the slice's int8 weights (rounded up to 4
    positions), the value pass's int32 partial sums, and the cluster's
    partial sums of the block's outputs."""
    def a16(x):
        return -(-x // 16) * 16
    chunk, per, groups = -(-n // blocks), -(-(rep * hd) // blocks), THREADS // (hd // 4)
    return (a16(rep * chunk * 4) + a16(rep * hd) + a16(rep * -(-chunk // 4) * 4)
            + a16(groups * rep * hd * 4) + a16(blocks * per * 4))


def cluster_launch(rep: int, hd: int, n: int, blocks: Optional[int] = None) -> tuple:
    """(blocks a cluster, shared bytes a block) of a launch over ``n``
    positions with ``rep`` query heads a KV group; ``blocks`` defaults to
    ``cluster_blocks(n)``. The batch only sizes the grid (one cluster per
    KV group and batch row). Raises ValueError where the kernel would
    refuse: a cluster outside 1..16, more than ``MAX_N`` positions, or a
    block's slice over ``MAX_SHARED``."""
    blocks = cluster_blocks(n) if blocks is None else blocks
    if not 1 <= blocks <= MAX_CLUSTER:
        raise ValueError(f"blocks={blocks} outside 1..{MAX_CLUSTER}")
    if n > MAX_N:
        raise ValueError(f"n={n} over the {MAX_N} positions whose int32 value sums cannot overflow")
    need = shared_bytes(rep, hd, n, blocks)
    if need > MAX_SHARED:
        raise ValueError(f"n={n} over {blocks} blocks needs {need} bytes of shared memory a block, "
                         f"over the kernel's {MAX_SHARED}")
    return blocks, need


def decode_attention_int8_cuda(q, k8, v8, k_scale, v_scale, n: int, k_extra, v_extra,
                               start: Optional[torch.Tensor] = None, blocks: Optional[int] = None) -> torch.Tensor:
    """The kernel on the current stream. q (B, H, hd) contiguous bf16 CUDA;
    k8, v8 (B, S_max, KV, hd) int8 with contiguous (KV, hd) rows and equal
    strides (a layer of the cache); k_scale, v_scale (B, S_max) fp32 with
    unit position stride; k_extra, v_extra (B, E, KV, hd) bf16, 1 <= E <= 8,
    with contiguous (E, KV, hd) rows and equal strides (a slice of the
    window's pending buffer). The positions are split over clusters of
    ``blocks`` blocks (default ``cluster_blocks(n)``; blocks past n hold no
    position); ``start`` None or (B,) int32 on the device. Raises on any
    input it does not take and on a failed launch."""
    global LAUNCHES
    refuse_grad("decode_attention_int8_cuda", q, k8, v8, k_scale, v_scale, k_extra, v_extra)
    B, H, hd = q.shape
    tensors = (q, k8, v8, k_scale, v_scale, k_extra, v_extra)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("decode_attention_int8_cuda needs CUDA tensors")
    if not (q.dtype == k_extra.dtype == v_extra.dtype == torch.bfloat16
            and k8.dtype == v8.dtype == torch.int8 and k_scale.dtype == v_scale.dtype == torch.float32):
        raise ValueError("decode_attention_int8_cuda needs bf16 q/k_extra/v_extra, int8 k8/v8, fp32 scales")
    if k8.ndim != 4 or k8.shape != v8.shape or k8.shape[0] != B or k8.shape[3] != hd:
        raise ValueError(f"cache layer {tuple(k8.shape)} does not match q {tuple(q.shape)}")
    KV, s_max = k8.shape[2], k8.shape[1]
    E = k_extra.shape[1] if k_extra.ndim == 4 else 0
    if k_extra.shape != (B, E, KV, hd) or v_extra.shape != k_extra.shape or not 1 <= E <= MAX_EXTRA:
        raise ValueError(f"k_extra/v_extra must be (B={B}, E, KV={KV}, hd={hd}) with 1 <= E <= "
                         f"{MAX_EXTRA}, got {tuple(k_extra.shape)}, {tuple(v_extra.shape)}")
    if k_scale.shape != (B, s_max) or v_scale.shape != (B, s_max):
        raise ValueError(f"scales must be {(B, s_max)}")
    if H % KV or H // KV > 8 or hd % 16 or not 16 <= hd <= 128:
        raise ValueError(f"unsupported geometry H={H}, KV={KV}, hd={hd}")
    if not 1 <= n <= s_max:
        raise ValueError(f"n={n} outside the cache's {s_max} positions")
    blocks, _ = cluster_launch(H // KV, hd, n, blocks)
    if (not q.is_contiguous() or k_extra.stride() != v_extra.stride()
            or k_extra.stride()[1:] != (KV * hd, hd, 1)
            or k8.stride() != v8.stride() or k8.stride()[2:] != (hd, 1)
            or k_scale.stride() != v_scale.stride() or k_scale.stride(1) != 1):
        raise ValueError("decode_attention_int8_cuda needs contiguous q, (E, KV, hd)-contiguous extra "
                         "rows, (KV, hd)-contiguous cache rows and unit-stride scales")
    check_start(start, B, q.device)
    lib = load_library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.mellow_decode_attention_int8(
            q.data_ptr(), k8.data_ptr(), v8.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
            k_extra.data_ptr(), v_extra.data_ptr(), out.data_ptr(),
            None if start is None else start.data_ptr(), B, H, KV, hd, n, E,
            k8.stride(0), k8.stride(1), k_scale.stride(0), k_extra.stride(0), blocks,
            torch.cuda.current_stream().cuda_stream,
        )
    check(err, "int8 decode attention kernel")
    LAUNCHES += 1
    check_outputs("decode_attention_int8_cuda", out)
    return out


def decode_attention_int8(q, k8, v8, k_scale, v_scale, n: int, k_extra, v_extra,
                          start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version otherwise."""
    fn = decode_attention_int8_cuda if q.is_cuda else decode_attention_int8_plain
    return fn(q, k8, v8, k_scale, v_scale, n, k_extra, v_extra, start)
