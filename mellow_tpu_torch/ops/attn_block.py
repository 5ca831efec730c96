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
CUDA path can write k and v straight into a strided KV-cache slice.
``attn_block`` dispatches by device; ``LAUNCHES`` counts calls of the
kernel chain; each call launches ``KERNELS_PER_CALL`` kernels (q, k, v
projections, causal attention, o-projection).
"""

from __future__ import annotations

from typing import Optional

import torch

from mellow_tpu_torch.ops._build import check, load_library
from mellow_tpu_torch.ops.mlp_block import mm, rms_norm

LAUNCHES = 0
KERNELS_PER_CALL = 5


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


def attn_block_plain(x, ln_w, wq, wk, wv, wo, cos, sin, *, num_heads: int, num_kv_heads: int,
                     head_dim: int, eps: float):
    """The plain version: (out (B, S, D), k, v (B, S, KV*hd))."""
    dt = x.dtype
    H, KV, hd = num_heads, num_kv_heads, head_dim
    h = rms_norm(x, ln_w, eps)
    q = rope_rounded(mm(h, wq).to(dt), cos, sin, H, hd)
    k = rope_rounded(mm(h, wk).to(dt), cos, sin, KV, hd)
    v = mm(h, wv).to(dt)
    o = causal_gqa_plain(q, k, v, num_heads=H, num_kv_heads=KV, head_dim=hd)
    out = (x.float() + mm(o, wo).to(dt).float()).to(dt)
    return out, k, v


def attn_block_cuda(x, ln_w, wq, wk, wv, wo, cos, sin, *, num_heads: int, num_kv_heads: int,
                    head_dim: int, eps: float, k_out: Optional[torch.Tensor] = None,
                    v_out: Optional[torch.Tensor] = None):
    """The kernel chain on the current stream. x (B, S, D) contiguous bf16
    CUDA, weights contiguous bf16, cos/sin (S, hd) bf16. ``k_out``/``v_out``:
    optional (B, S, KV, hd) destinations (e.g. ``cache.k[layer, :, :S]``)
    whose rows are contiguous; the kernel writes them in place and returns
    them viewed as (B, S, KV*hd) when their layout allows, else as given."""
    global LAUNCHES
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
    # The RoPE epilogue pairs columns within one 64-wide GEMM tile, and the
    # attention kernel is built for hd = 64 only (every config's head size).
    if hd != 64 or H % KV or D % 8 or not 1 <= S <= 1024:
        raise ValueError(f"unsupported geometry hd={hd}, H={H}, KV={KV}, D={D}, S={S}")
    dev = x.device
    if k_out is None:
        k_out = torch.empty((B, S, KV, hd), dtype=x.dtype, device=dev)
        v_out = torch.empty((B, S, KV, hd), dtype=x.dtype, device=dev)
    want = (B, S, KV, hd)
    for t in (k_out, v_out):
        if (t.shape != want or t.dtype != x.dtype or t.device != dev
                or t.stride()[1:] != (KV * hd, hd, 1) or t.stride(0) != k_out.stride(0)):
            raise ValueError("k_out/v_out must be (B, S, KV, hd) with contiguous rows")
    lib = load_library()
    q_buf = torch.empty((B, S, H * hd), dtype=x.dtype, device=dev)
    o_buf = torch.empty_like(q_buf)
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        err = lib.mellow_attn_block(
            x.data_ptr(), ln_w.data_ptr(), wq.data_ptr(), wk.data_ptr(), wv.data_ptr(),
            wo.data_ptr(), cos.data_ptr(), sin.data_ptr(), q_buf.data_ptr(),
            k_out.data_ptr(), v_out.data_ptr(), k_out.stride(0), o_buf.data_ptr(),
            out.data_ptr(), B, S, D, H, KV, hd, float(eps),
            torch.cuda.current_stream().cuda_stream,
        )
    check(err, "attention block kernel")
    LAUNCHES += 1
    return out, k_out.reshape(B, S, KV * hd), v_out.reshape(B, S, KV * hd)


def attn_block(x, ln_w, wq, wk, wv, wo, cos, sin, *, num_heads: int, num_kv_heads: int,
               head_dim: int, eps: float, k_out: Optional[torch.Tensor] = None,
               v_out: Optional[torch.Tensor] = None):
    """The kernel chain for CUDA tensors, the plain version otherwise. With
    ``k_out``/``v_out`` given, k and v also land there."""
    kw = dict(num_heads=num_heads, num_kv_heads=num_kv_heads, head_dim=head_dim, eps=eps)
    if x.is_cuda:
        return attn_block_cuda(x, ln_w, wq, wk, wv, wo, cos, sin, k_out=k_out, v_out=v_out, **kw)
    out, k, v = attn_block_plain(x, ln_w, wq, wk, wv, wo, cos, sin, **kw)
    if k_out is not None:
        k_out.copy_(k.reshape(k_out.shape))
        v_out.copy_(v.reshape(v_out.shape))
    return out, k, v
