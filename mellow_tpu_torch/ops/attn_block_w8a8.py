"""The W8A8 prefill attention block: the CUDA kernel chain
(``csrc/attn_block_w8a8.cu``) and its plain PyTorch version.

Port of the TPU kernel ``mellow_tpu/ops/pallas_attn_block.py``
(``fused_attn_block_w8a8``), with its quantization and rounding points:

    h8, hs = rowquant(rms_norm_f32(x))          the fp32 norm, not rounded
    q, k, v = (h8 @ w8) * hs * w_scale, as int32 sums, each rounded
    q, k = rope(q), rope(k): fp32, rounded once
    o = the bf16 causal GQA core of ``ops/attn_block.py``
    o8, os = rowquant(o)
    out = x + ((o8 @ wo8) * os * wo_scale) rounded

The weights are ``llama.quantize_weight``'s ``(in, out)`` int8 values with
per-column scales, which the wrapper casts to the compute dtype (the kernels
widen them to fp32). With ``kv_quant`` (an int8 cache) k and v come back
quantized per position as in ``ops/attn_block.py``. ``attn_block_w8a8``
dispatches by device; ``LAUNCHES`` counts calls of the kernel chain, each
``KERNELS_PER_CALL`` launches in ``kv_quant`` mode (one q/k/v projection
that norms and quantizes its rows itself, causal attention, the quantizer
of o, the o-projection, the k/v quantizer), one fewer without it.
"""

from __future__ import annotations

from typing import Optional

import torch

from mellow_tpu_torch.ops._build import check, load_library, refuse_grad
from mellow_tpu_torch.ops.attn_block import (
    causal_gqa_plain, check_geometry, copy_kv, kv_destinations, kv_quant_plain, kv_results, quant_args,
    rope_rounded)
from mellow_tpu_torch.ops.int8 import mm8, rms_norm_f32, rowquant
from mellow_tpu_torch.utils.debug import check_outputs

LAUNCHES = 0
KERNELS_PER_CALL = 5


def attn_block_w8a8_plain(x, ln_w, wq_q, wq_s, wk_q, wk_s, wv_q, wv_s, wo_q, wo_s, cos, sin, *,
                          num_heads: int, num_kv_heads: int, head_dim: int, eps: float,
                          kv_quant: bool = False):
    """The plain version: (out (B, S, D), k, v (B, S, KV*hd)), or with
    ``kv_quant`` (out, k8, v8, k_scale, v_scale)."""
    dt = x.dtype
    H, KV, hd = num_heads, num_kv_heads, head_dim
    h8, hs = rowquant(rms_norm_f32(x, ln_w, eps))
    q = rope_rounded((mm8(h8, wq_q) * hs * wq_s.float()).to(dt), cos, sin, H, hd)
    k = rope_rounded((mm8(h8, wk_q) * hs * wk_s.float()).to(dt), cos, sin, KV, hd)
    v = (mm8(h8, wv_q) * hs * wv_s.float()).to(dt)
    o = causal_gqa_plain(q, k, v, num_heads=H, num_kv_heads=KV, head_dim=hd)
    o8, os_ = rowquant(o.float())
    out = (x.float() + (mm8(o8, wo_q) * os_ * wo_s.float()).to(dt).float()).to(dt)
    return (out, *kv_quant_plain(k, v)) if kv_quant else (out, k, v)


def attn_block_w8a8_cuda(x, ln_w, wq_q, wq_s, wk_q, wk_s, wv_q, wv_s, wo_q, wo_s, cos, sin, *,
                         num_heads: int, num_kv_heads: int, head_dim: int, eps: float,
                         k_out: Optional[torch.Tensor] = None, v_out: Optional[torch.Tensor] = None,
                         kv_quant: bool = False, k_scale_out: Optional[torch.Tensor] = None,
                         v_scale_out: Optional[torch.Tensor] = None):
    """The kernel chain on the current stream. x (B, S, D) contiguous bf16
    CUDA; weights contiguous int8 (in, out) with bf16 (out,) scales; ln_w,
    cos/sin bf16. K/V destinations as ``attn_block.attn_block_cuda``."""
    global LAUNCHES
    refuse_grad("attn_block_w8a8_cuda", x, ln_w, wq_s, wk_s, wv_s, wo_s, cos, sin)
    B, S, D = x.shape
    H, KV, hd = num_heads, num_kv_heads, head_dim
    weights = (wq_q, wk_q, wv_q, wo_q)
    others = (x, ln_w, wq_s, wk_s, wv_s, wo_s, cos, sin)
    if not all(t.is_cuda for t in weights + others):
        raise ValueError("attn_block_w8a8_cuda needs CUDA tensors")
    if any(t.dtype != torch.int8 for t in weights) or any(t.dtype != torch.bfloat16 for t in others):
        raise ValueError("attn_block_w8a8_cuda needs int8 weights and bfloat16 x, scales and tables")
    if not all(t.is_contiguous() for t in weights + others):
        raise ValueError("attn_block_w8a8_cuda needs contiguous tensors")
    if (wq_q.shape != (D, H * hd) or wk_q.shape != (D, KV * hd) or wv_q.shape != (D, KV * hd)
            or wo_q.shape != (H * hd, D) or wq_s.shape != (H * hd,) or wk_s.shape != (KV * hd,)
            or wv_s.shape != (KV * hd,) or wo_s.shape != (D,) or cos.shape != (S, hd)
            or sin.shape != (S, hd) or ln_w.shape != (D,)):
        raise ValueError("attn_block_w8a8_cuda: weight shapes do not match x and the head geometry")
    # int8 rows load as 16-byte vectors: D is a multiple of 16.
    check_geometry(D, H, KV, hd, S, True)
    dev = x.device
    k_rows, v_rows, k8, v8, ks, vs = kv_destinations(x, KV, hd, k_out, v_out, kv_quant,
                                                     k_scale_out, v_scale_out)
    lib = load_library()
    q_buf = torch.empty((B, S, H * hd), dtype=x.dtype, device=dev)
    o_buf = torch.empty_like(q_buf)
    o8 = torch.empty((B * S, H * hd), dtype=torch.int8, device=dev)
    os_ = torch.empty((B * S,), dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        err = lib.mellow_attn_block_w8a8(
            x.data_ptr(), ln_w.data_ptr(), wq_q.data_ptr(), wq_s.data_ptr(), wk_q.data_ptr(),
            wk_s.data_ptr(), wv_q.data_ptr(), wv_s.data_ptr(), wo_q.data_ptr(), wo_s.data_ptr(),
            cos.data_ptr(), sin.data_ptr(), q_buf.data_ptr(), k_rows.data_ptr(), v_rows.data_ptr(),
            k_rows.stride(0), o_buf.data_ptr(), o8.data_ptr(), os_.data_ptr(), out.data_ptr(),
            *quant_args(k8, v8, ks, vs),
            B, S, D, H, KV, hd, float(eps), torch.cuda.current_stream().cuda_stream,
        )
    check(err, "W8A8 attention block kernel")
    LAUNCHES += 1
    res = (out, *kv_results(k_rows, v_rows, k8, v8, ks, vs))
    check_outputs("attn_block_w8a8_cuda", *res)
    return res


def attn_block_w8a8(x, ln_w, wq_q, wq_s, wk_q, wk_s, wv_q, wv_s, wo_q, wo_s, cos, sin, *,
                    num_heads: int, num_kv_heads: int, head_dim: int, eps: float,
                    k_out: Optional[torch.Tensor] = None, v_out: Optional[torch.Tensor] = None,
                    kv_quant: bool = False, k_scale_out: Optional[torch.Tensor] = None,
                    v_scale_out: Optional[torch.Tensor] = None):
    """The kernel chain for CUDA tensors, the plain version otherwise. With
    destinations given, k and v (or their int8 rows and scales) also land
    there."""
    args = (x, ln_w, wq_q, wq_s, wk_q, wk_s, wv_q, wv_s, wo_q, wo_s, cos, sin)
    kw = dict(num_heads=num_heads, num_kv_heads=num_kv_heads, head_dim=head_dim, eps=eps,
              kv_quant=kv_quant)
    dst = dict(k_out=k_out, v_out=v_out, k_scale_out=k_scale_out, v_scale_out=v_scale_out)
    if x.is_cuda:
        return attn_block_w8a8_cuda(*args, **dst, **kw)
    res = attn_block_w8a8_plain(*args, **kw)
    copy_kv(res[1:], **dst)
    return res
