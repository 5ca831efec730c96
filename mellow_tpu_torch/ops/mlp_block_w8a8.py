"""The W8A8 prefill MLP block: the CUDA kernel chain
(``csrc/mlp_block_w8a8.cu``) and its plain PyTorch version.

Port of the TPU kernel ``mellow_tpu/ops/pallas_mlp_block.py``
(``fused_mlp_block_w8a8``):

    h8, hs = rowquant(rms_norm_f32(x))          the fp32 norm, not rounded
    gate = silu((h8 @ wg8) * hs * sg);  up = (h8 @ wu8) * hs * su   fp32
    p8, ps = rowquant(gate * up)                over all I columns
    out = x + ((p8 @ wd8) * ps * sd) rounded

with int8 weights in ``llama.quantize_weight``'s ``(in, out)`` layout and
per-column scales in the compute dtype (widened to fp32). ``mlp_block_w8a8``
dispatches by device; ``LAUNCHES`` counts calls of the kernel chain, each
``KERNELS_PER_CALL`` launches (norm and quantize, gate/up, quantize, down).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mellow_tpu_torch.ops._build import check, load_library
from mellow_tpu_torch.ops.int8 import mm8, rms_norm_f32, rowquant

LAUNCHES = 0
KERNELS_PER_CALL = 4


def mlp_block_w8a8_plain(x, ln_w, wg_q, wg_s, wu_q, wu_s, wd_q, wd_s, *, eps: float) -> torch.Tensor:
    """x (B, S, D) -> x + down(silu(gate) * up), W8A8 as the TPU kernel."""
    h8, hs = rowquant(rms_norm_f32(x, ln_w, eps))
    gate = F.silu(mm8(h8, wg_q) * hs * wg_s.float())
    up = mm8(h8, wu_q) * hs * wu_s.float()
    p8, ps = rowquant(gate * up)
    y = mm8(p8, wd_q) * ps * wd_s.float()
    return (x.float() + y.to(x.dtype).float()).to(x.dtype)


def mlp_block_w8a8_cuda(x, ln_w, wg_q, wg_s, wu_q, wu_s, wd_q, wd_s, *, eps: float) -> torch.Tensor:
    """The kernel chain on the current stream. x (B, S, D) contiguous bf16
    CUDA; weights contiguous int8 (in, out) with bf16 (out,) scales."""
    global LAUNCHES
    weights = (wg_q, wu_q, wd_q)
    others = (x, ln_w, wg_s, wu_s, wd_s)
    if not all(t.is_cuda for t in weights + others):
        raise ValueError("mlp_block_w8a8_cuda needs CUDA tensors")
    if any(t.dtype != torch.int8 for t in weights) or any(t.dtype != torch.bfloat16 for t in others):
        raise ValueError("mlp_block_w8a8_cuda needs int8 weights and bfloat16 x and scales")
    if not all(t.is_contiguous() for t in weights + others):
        raise ValueError("mlp_block_w8a8_cuda needs contiguous tensors")
    D = x.shape[-1]
    I = wg_q.shape[1]
    # int8 rows load as 16-byte vectors: D and I are multiples of 16.
    if (wg_q.shape != (D, I) or wu_q.shape != (D, I) or wd_q.shape != (I, D) or wg_s.shape != (I,)
            or wu_s.shape != (I,) or wd_s.shape != (D,) or ln_w.shape != (D,) or D % 16 or I % 16):
        raise ValueError(f"unsupported shapes x {tuple(x.shape)}, w_gate {tuple(wg_q.shape)}")
    M = x.numel() // D
    dev = x.device
    lib = load_library()
    h8 = torch.empty((M, D), dtype=torch.int8, device=dev)
    hs = torch.empty((M,), dtype=torch.float32, device=dev)
    prod = torch.empty((M, I), dtype=torch.float32, device=dev)
    p8 = torch.empty((M, I), dtype=torch.int8, device=dev)
    ps = torch.empty((M,), dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        err = lib.mellow_mlp_block_w8a8(
            x.data_ptr(), ln_w.data_ptr(), wg_q.data_ptr(), wg_s.data_ptr(), wu_q.data_ptr(),
            wu_s.data_ptr(), wd_q.data_ptr(), wd_s.data_ptr(), h8.data_ptr(), hs.data_ptr(),
            prod.data_ptr(), p8.data_ptr(), ps.data_ptr(), out.data_ptr(), M, D, I, float(eps),
            torch.cuda.current_stream().cuda_stream,
        )
    check(err, "W8A8 MLP block kernel")
    LAUNCHES += 1
    return out


def mlp_block_w8a8(x, ln_w, wg_q, wg_s, wu_q, wu_s, wd_q, wd_s, *, eps: float) -> torch.Tensor:
    """The kernel chain for CUDA tensors, the plain version otherwise."""
    fn = mlp_block_w8a8_cuda if x.is_cuda else mlp_block_w8a8_plain
    return fn(x, ln_w, wg_q, wg_s, wu_q, wu_s, wd_q, wd_s, eps=eps)
