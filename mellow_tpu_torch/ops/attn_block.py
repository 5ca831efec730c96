"""The prefill attention block: the CUDA kernel chain (``csrc/attn_block.cu``)
and its plain PyTorch version.

Port of the TPU kernel ``mellow_tpu/ops/pallas_attn_block.py``
(``fused_attn_block``), with its rounding points:

    h = rms_norm(x) (fp32, rounded to x's dtype)
    q, k, v = (h @ wq), (h @ wk), (h @ wv), each rounded
    q, k = rope(q), rope(k): fp32 from the rounded values, rounded once
    o = causal GQA: s = (q . k) / sqrt(hd) in fp32, masked above the
        diagonal; e = exp(s - max); o = (e rounded) @ v / sum(e), rounded
    out = x + (o @ wo) rounded

Returns ``(out, k, v)`` with k (post-RoPE) and v as ``(B, S, KV*hd)``; the
CUDA path can write k and v straight into a strided KV-cache slice. In the
TPU kernel's ``kv_quant`` mode (an int8 cache, ``_emit_quantized_kv``) k and
v come back quantized per position over all KV*hd lanes (``ops/int8.py``
``rowquant``): ``(out, k8, v8, k_scale, v_scale)``, the scales ``(B, S)``
fp32. ``attn_block`` dispatches by device. ``LAUNCHES`` counts calls of the
kernel chain, each ``KERNELS_PER_CALL`` launches (one q/k/v projection
over the column tiles of all three weights, the causal attention, the
o-projection); ``LAUNCHES_KV_QUANT`` counts the ``kv_quant`` calls, each
``KERNELS_PER_CALL_KV_QUANT`` launches (the chain and the k/v quantizer).
``check_geometry`` refuses what the kernels do not take;
``ops/attn_block_w8a8.py`` shares it.
"""

from __future__ import annotations

from typing import Optional

import torch

from mellow_tpu_torch.ops._build import check, load_library, refuse_grad
from mellow_tpu_torch.ops.int8 import rowquant
from mellow_tpu_torch.ops.mlp_block import mm, rms_norm
from mellow_tpu_torch.utils.debug import check_outputs

LAUNCHES = 0
KERNELS_PER_CALL = 3
LAUNCHES_KV_QUANT = 0
KERNELS_PER_CALL_KV_QUANT = 4

HEAD_DIM = 64  # a projection column tile is one head (csrc PJ_BN); the attention core's width
MAX_S = 8192  # the attention core's cap (csrc FP_MAX_S)
MAX_SHARED = 200 * 1024  # the projections' dynamic shared memory cap (csrc PJ_MAX_DSMEM)
TILE_ROWS = {False: 64, True: 32}  # the projections' rows a block, bf16 and int8 (csrc launch_proj)
RING_STAGES, RING_ROWS = 4, 32  # the weight ring (csrc PJ_STAGES, PJ_BK)


def proj_shared_bytes(K: int, int8: bool, qkv: bool = True) -> int:
    """A projection launch's dynamic shared memory (csrc
    ``proj_smem_bytes``): the block's bf16 rows of the (M, K) operand (in
    int8, x staged for the q/k/v launch's quantizer), the int8 panel, the
    weight ring."""
    rows = TILE_ROWS[int8]
    kp = -(-K // RING_ROWS) * RING_ROWS
    rows16 = rows * (kp + 8) * 2
    if not int8:
        return rows16 + RING_STAGES * RING_ROWS * (HEAD_DIM + 8) * 2
    return (rows16 if qkv else 0) + rows * (kp + 16) + RING_STAGES * RING_ROWS * (HEAD_DIM + 16)


def check_geometry(D: int, num_heads: int, num_kv_heads: int, head_dim: int, seq: int, int8: bool) -> None:
    """Raises ValueError on a geometry the kernels do not take: hd other
    than 64, H not a multiple of KV, D not a multiple of 8 (16 in int8), S
    outside 1..``MAX_S``, or a projection's shared memory over
    ``MAX_SHARED``."""
    H, KV = num_heads, num_kv_heads
    if head_dim != HEAD_DIM or KV < 1 or H % KV or D % (16 if int8 else 8) or not 1 <= seq <= MAX_S:
        raise ValueError(f"unsupported geometry hd={head_dim}, H={H}, KV={KV}, D={D}, S={seq}")
    need = max(proj_shared_bytes(D, int8), proj_shared_bytes(H * head_dim, int8, False))
    if need > MAX_SHARED:
        raise ValueError(f"D={D}, H*hd={H * head_dim} need {need} bytes of shared memory a projection "
                         f"block of {TILE_ROWS[int8]} rows, over the kernels' {MAX_SHARED}")


def rope_rounded(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, n_heads: int, hd: int) -> torch.Tensor:
    """x (B, S, n_heads*hd) -> x * cos + rotate_half(x) * sin computed in
    fp32 and rounded once to x's dtype; cos, sin (S, hd)."""
    B, S, _ = x.shape
    xf = x.float().reshape(B, S, n_heads, hd)
    x1, x2 = xf.chunk(2, dim=-1)
    rot = torch.cat([-x2, x1], dim=-1)
    out = xf * cos.float()[None, :, None] + rot * sin.float()[None, :, None]
    return out.to(x.dtype).reshape(B, S, n_heads * hd)


def causal_gqa_plain(q, k, v, *, num_heads: int, num_kv_heads: int, head_dim: int) -> torch.Tensor:
    """q (B, S, H*hd), k and v (B, S, KV*hd) -> (B, S, H*hd) in q's dtype."""
    B, S, _ = q.shape
    KV, hd = num_kv_heads, head_dim
    rep = num_heads // KV
    qg = q.float().reshape(B, S, KV, rep, hd)
    kf = k.float().reshape(B, S, KV, hd)
    vf = v.float().reshape(B, S, KV, hd)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, kf) * (1.0 / hd ** 0.5)
    causal = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~causal, -1e30)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bgrqk,bkgd->bgrqd", e.to(q.dtype).float(), vf) / e.sum(-1, keepdim=True)
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, num_heads * hd).to(q.dtype)


def kv_quant_plain(k: torch.Tensor, v: torch.Tensor):
    """k, v (B, S, KV*hd) -> (k8, v8 int8 (B, S, KV*hd), k_scale, v_scale
    fp32 (B, S)): the TPU kernels' in-kernel k/v quantization."""
    k8, ks = rowquant(k.float())
    v8, vs = rowquant(v.float())
    return k8, v8, ks[..., 0], vs[..., 0]


def attn_block_plain(x, ln_w, wq, wk, wv, wo, cos, sin, *, num_heads: int, num_kv_heads: int,
                     head_dim: int, eps: float, kv_quant: bool = False):
    """The plain version: (out (B, S, D), k, v (B, S, KV*hd)), or with
    ``kv_quant`` (out, k8, v8, k_scale, v_scale)."""
    dt = x.dtype
    H, KV, hd = num_heads, num_kv_heads, head_dim
    h = rms_norm(x, ln_w, eps)
    q = rope_rounded(mm(h, wq).to(dt), cos, sin, H, hd)
    k = rope_rounded(mm(h, wk).to(dt), cos, sin, KV, hd)
    v = mm(h, wv).to(dt)
    o = causal_gqa_plain(q, k, v, num_heads=H, num_kv_heads=KV, head_dim=hd)
    out = (x.float() + mm(o, wo).to(dt).float()).to(dt)
    return (out, *kv_quant_plain(k, v)) if kv_quant else (out, k, v)


def _check_rows(k_out, v_out, want, dtype, device) -> None:
    for t in (k_out, v_out):
        if (t.shape != want or t.dtype != dtype or t.device != device
                or t.stride()[1:] != (want[2] * want[3], want[3], 1) or t.stride(0) != k_out.stride(0)):
            raise ValueError(f"k_out/v_out must be {dtype} {want} with contiguous rows")


def kv_destinations(x, num_kv_heads: int, head_dim: int, k_out, v_out, kv_quant: bool,
                    k_scale_out, v_scale_out):
    """Where a prefill block's CUDA chain puts k and v. Returns (k_rows,
    v_rows, k8, v8, k_scale, v_scale): the bf16 (B, S, KV, hd) rows the k/v
    products write (the given destinations, or new tensors; contiguous
    scratch in ``kv_quant`` mode) and, in ``kv_quant`` mode, the int8 rows
    and (B, S) fp32 scales the quantizer writes (given or new), else None.
    Raises on destinations the kernels do not take."""
    B, S = x.shape[:2]
    dev, want = x.device, (B, S, num_kv_heads, head_dim)
    if not kv_quant:
        if k_out is None:
            k_out, v_out = (torch.empty(want, dtype=x.dtype, device=dev) for _ in range(2))
        _check_rows(k_out, v_out, want, x.dtype, dev)
        return k_out, v_out, None, None, None, None
    k_rows, v_rows = (torch.empty(want, dtype=x.dtype, device=dev) for _ in range(2))
    if k_out is None:
        k_out, v_out = (torch.empty(want, dtype=torch.int8, device=dev) for _ in range(2))
        k_scale_out, v_scale_out = (torch.empty((B, S), dtype=torch.float32, device=dev) for _ in range(2))
    _check_rows(k_out, v_out, want, torch.int8, dev)
    for t in (k_scale_out, v_scale_out):
        if (t is None or t.shape != (B, S) or t.dtype != torch.float32 or t.device != dev
                or t.stride(1) != 1 or t.stride() != k_scale_out.stride()):
            raise ValueError("k_scale_out/v_scale_out must be fp32 (B, S) with unit position stride")
    return k_rows, v_rows, k_out, v_out, k_scale_out, v_scale_out


def kv_results(k_rows, v_rows, k8, v8, ks, vs) -> tuple:
    """A block's k/v results as (B, S, KV*hd) views: (k, v), or (k8, v8,
    k_scale, v_scale) in ``kv_quant`` mode."""
    B, S, KV, hd = k_rows.shape
    if k8 is None:
        return k_rows.reshape(B, S, KV * hd), v_rows.reshape(B, S, KV * hd)
    return k8.reshape(B, S, KV * hd), v8.reshape(B, S, KV * hd), ks, vs


def copy_kv(results, k_out, v_out, k_scale_out, v_scale_out) -> None:
    """Write a plain version's k/v results into the given destinations."""
    if k_out is None:
        return
    k_out.copy_(results[0].reshape(k_out.shape))
    v_out.copy_(results[1].reshape(v_out.shape))
    if k_scale_out is not None:
        k_scale_out.copy_(results[2])
        v_scale_out.copy_(results[3])


def quant_args(k8, v8, ks, vs) -> tuple:
    """The C chains' kv_quant arguments: the int8 rows and their batch
    stride, the scales and theirs; null pointers without kv_quant."""
    if k8 is None:
        return 0, 0, 0, 0, 0, 0
    return k8.data_ptr(), v8.data_ptr(), k8.stride(0), ks.data_ptr(), vs.data_ptr(), ks.stride(0)


def attn_block_cuda(x, ln_w, wq, wk, wv, wo, cos, sin, *, num_heads: int, num_kv_heads: int,
                    head_dim: int, eps: float, k_out: Optional[torch.Tensor] = None,
                    v_out: Optional[torch.Tensor] = None, kv_quant: bool = False,
                    k_scale_out: Optional[torch.Tensor] = None,
                    v_scale_out: Optional[torch.Tensor] = None):
    """The kernel chain on the current stream. x (B, S, D) contiguous bf16
    CUDA, weights contiguous bf16, cos/sin (S, hd) bf16. ``k_out``/``v_out``:
    optional (B, S, KV, hd) destinations (e.g. ``cache.k[layer, :, :S]``)
    whose rows are contiguous, bf16, or int8 with (B, S) fp32
    ``k_scale_out``/``v_scale_out`` in ``kv_quant`` mode; the kernels write
    them in place, and they are returned viewed as (B, S, KV*hd)."""
    global LAUNCHES, LAUNCHES_KV_QUANT
    refuse_grad("attn_block_cuda", x, ln_w, wq, wk, wv, wo, cos, sin)
    B, S, D = x.shape
    H, KV, hd = num_heads, num_kv_heads, head_dim
    tensors = (x, ln_w, wq, wk, wv, wo, cos, sin)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("attn_block_cuda needs CUDA tensors")
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise ValueError("attn_block_cuda needs bfloat16 tensors")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("attn_block_cuda needs contiguous tensors")
    if (wq.shape != (D, H * hd) or wk.shape != (D, KV * hd) or wv.shape != (D, KV * hd)
            or wo.shape != (H * hd, D) or cos.shape != (S, hd) or sin.shape != (S, hd)
            or ln_w.shape != (D,)):
        raise ValueError("attn_block_cuda: weight shapes do not match x and the head geometry")
    check_geometry(D, H, KV, hd, S, False)
    dev = x.device
    k_rows, v_rows, k8, v8, ks, vs = kv_destinations(x, KV, hd, k_out, v_out, kv_quant,
                                                     k_scale_out, v_scale_out)
    lib = load_library()
    q_buf = torch.empty((B, S, H * hd), dtype=x.dtype, device=dev)
    o_buf = torch.empty_like(q_buf)
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        err = lib.mellow_attn_block(
            x.data_ptr(), ln_w.data_ptr(), wq.data_ptr(), wk.data_ptr(), wv.data_ptr(),
            wo.data_ptr(), cos.data_ptr(), sin.data_ptr(), q_buf.data_ptr(),
            k_rows.data_ptr(), v_rows.data_ptr(), k_rows.stride(0), o_buf.data_ptr(),
            out.data_ptr(), *quant_args(k8, v8, ks, vs), B, S, D, H, KV, hd, float(eps),
            torch.cuda.current_stream().cuda_stream,
        )
    check(err, "attention block kernel")
    if kv_quant:
        LAUNCHES_KV_QUANT += 1
    else:
        LAUNCHES += 1
    res = (out, *kv_results(k_rows, v_rows, k8, v8, ks, vs))
    check_outputs("attn_block_cuda", *res)
    return res


def attn_block(x, ln_w, wq, wk, wv, wo, cos, sin, *, num_heads: int, num_kv_heads: int,
               head_dim: int, eps: float, k_out: Optional[torch.Tensor] = None,
               v_out: Optional[torch.Tensor] = None, kv_quant: bool = False,
               k_scale_out: Optional[torch.Tensor] = None,
               v_scale_out: Optional[torch.Tensor] = None):
    """The kernel chain for CUDA tensors, the plain version otherwise. With
    ``k_out``/``v_out`` (and, in ``kv_quant`` mode, the scale destinations)
    given, k and v also land there."""
    kw = dict(num_heads=num_heads, num_kv_heads=num_kv_heads, head_dim=head_dim, eps=eps,
              kv_quant=kv_quant)
    dst = dict(k_out=k_out, v_out=v_out, k_scale_out=k_scale_out, v_scale_out=v_scale_out)
    if x.is_cuda:
        return attn_block_cuda(x, ln_w, wq, wk, wv, wo, cos, sin, **dst, **kw)
    res = attn_block_plain(x, ln_w, wq, wk, wv, wo, cos, sin, **kw)
    copy_kv(res[1:], **dst)
    return res
