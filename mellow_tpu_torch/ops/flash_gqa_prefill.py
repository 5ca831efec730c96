"""Causal GQA prefill attention: the CUDA kernel (``csrc/flash_gqa_prefill.cu``)
and its plain PyTorch version.

Port of the TPU kernel ``mellow_tpu/ops/pallas_attention.py``
(``flash_gqa_prefill``), which the GPT-2 prefill runs in every layer in
bf16 (MHA is its KV == H case). Layout, as the TPU kernel's: q (B, S, H*hd),
k and v (B, S, KV*hd), query head h reading KV group h // (H // KV);
returns (B, S, H*hd) in q's dtype:

    s = (q . k) / sqrt(hd) in fp32, -1e30 above the diagonal;
    e = exp(s - max(s));  o = (e rounded to q's dtype) @ v in fp32 / sum(e).

The CUDA path reads q, k and v through their batch and row strides, so they
may be the column slices of one packed qkv product. ``flash_gqa_prefill``
dispatches by device: a CUDA tensor goes through the kernel (it raises on
what the kernel does not take), a CPU tensor through
``flash_gqa_prefill_plain``. ``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import torch

from mellow_tpu_torch.ops._build import check, load_library, refuse_grad
from mellow_tpu_torch.ops.attn_block import causal_gqa_plain
from mellow_tpu_torch.utils.debug import check_outputs

LAUNCHES = 0
KERNELS_PER_CALL = 1
# The longest sequence the kernel takes: its shared memory does not grow
# with S, and the card's tests hold it against the plain version up to 4096.
MAX_SEQ = 8192


def flash_gqa_prefill_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, num_heads: int,
                            num_kv_heads: int, head_dim: int) -> torch.Tensor:
    """The plain version: the attention core of the prefill blocks."""
    return causal_gqa_plain(q, k, v, num_heads=num_heads, num_kv_heads=num_kv_heads, head_dim=head_dim)


def _check_strides(t: torch.Tensor, name: str) -> None:
    # The kernel loads 16 bytes (8 bf16) at a time from every row.
    if t.stride(2) != 1 or t.stride(0) % 8 or t.stride(1) % 8 or t.data_ptr() % 16:
        raise ValueError(f"flash_gqa_prefill_cuda: {name} needs unit column stride, batch and row "
                         f"strides in multiples of 8 and a 16-byte aligned base; got strides "
                         f"{t.stride()}")


def flash_gqa_prefill_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, num_heads: int,
                           num_kv_heads: int, head_dim: int) -> torch.Tensor:
    """The kernel on the current stream: q (B, S, H*hd), k and v (B, S,
    KV*hd), bf16 CUDA, with strided rows allowed (k and v share strides).
    Raises on any input it does not take and on a failed launch."""
    global LAUNCHES
    refuse_grad("flash_gqa_prefill_cuda", q, k, v)
    H, KV, hd = num_heads, num_kv_heads, head_dim
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_gqa_prefill_cuda needs CUDA tensors")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(f"flash_gqa_prefill_cuda needs bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 3:
        raise ValueError(f"q must be (B, S, H*hd), got {tuple(q.shape)}")
    B, S, _ = q.shape
    if q.shape[2] != H * hd or k.shape != (B, S, KV * hd) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} do not match "
                         f"H={H}, KV={KV}, hd={hd}")
    # The kernel is built for hd = 64 (every GPT-2 and SmolLM2 head).
    if hd != 64 or H % KV or not 1 <= S <= MAX_SEQ:
        raise ValueError(f"unsupported geometry hd={hd}, H={H}, KV={KV}, S={S}")
    if k.stride() != v.stride():
        raise ValueError("flash_gqa_prefill_cuda needs k and v with the same strides")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check_strides(t, name)
    lib = load_library()
    out = torch.empty((B, S, H * hd), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.mellow_flash_gqa_prefill(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), q.stride(0), q.stride(1),
            k.stride(0), k.stride(1), B, S, H, KV, hd, torch.cuda.current_stream().cuda_stream,
        )
    check(err, "prefill attention kernel")
    LAUNCHES += 1
    check_outputs("flash_gqa_prefill_cuda", out)
    return out


def flash_gqa_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, num_heads: int,
                      num_kv_heads: int, head_dim: int) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version otherwise."""
    kw = dict(num_heads=num_heads, num_kv_heads=num_kv_heads, head_dim=head_dim)
    if q.is_cuda:
        return flash_gqa_prefill_cuda(q, k, v, **kw)
    return flash_gqa_prefill_plain(q, k, v, **kw)
