"""Swin window attention: the CUDA kernel (``csrc/window_attention.cu``) and
its plain PyTorch version.

Port of the TPU kernel ``mellow_tpu/ops/pallas_window_attention.py``
(``window_attention_fused``): the attention between a Swin block's qkv and
proj products, which stay outside (``models/htsat.window_attention``), with
its rounding points:

    s = (q * scale) . k + bias + mask[w % nW]   (fp32; scale = fp32 hd^-0.5,
                                                 q not rounded after it)
    p = (exp(s - max) / sum) rounded;  o = (p @ v in fp32) rounded

``qkv`` is (Bn, N, 3C) for Bn packed windows of N = 64 tokens, ``bias`` the
(H, N, N) relative-position bias in fp32, ``mask`` the (nW, N, N) fp32
shifted-window mask or None. ``window_attention`` dispatches by device;
``LAUNCHES`` counts the kernel's launches (``KERNELS_PER_CALL`` = 1 per
call). The JAX package takes the kernel for a bf16 block when one window
needs <= 6 MB (``window_vmem_bytes``) and the whole-block kernel's 10 MB gate
has failed; the port's ``htsat`` gates the same way.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mellow_tpu_torch.ops._build import check, load_library, refuse_grad
from mellow_tpu_torch.utils.debug import check_outputs

LAUNCHES = 0
KERNELS_PER_CALL = 1
N_TOKENS = 64  # the kernel's 8 x 8 window
WINDOW_BUDGET = 6 << 20  # the JAX gate's 6 MB (mellow_tpu/models/htsat.py)


def window_vmem_bytes(C: int, num_heads: int, N: int) -> int:
    """The JAX package's per-window gate for the kernel (a copy of the
    expression in ``htsat.window_attention``)."""
    return num_heads * N * (C * 6 + N * 6)


def qk_scale(hd: int) -> float:
    """hd^-0.5 as the TPU kernel's ``np.float32`` scale."""
    return float(np.float32(hd ** -0.5))


def window_attention_plain(qkv: torch.Tensor, bias: torch.Tensor, mask: Optional[torch.Tensor], *,
                           num_heads: int) -> torch.Tensor:
    """qkv (Bn, N, 3C) -> (Bn, N, C) in qkv's dtype."""
    dt = qkv.dtype
    Bn, N, C3 = qkv.shape
    C, H = C3 // 3, num_heads
    hd = C // H
    q, k, v = qkv.float().reshape(Bn, N, 3, H, hd).unbind(2)
    s = torch.einsum("bnhd,bmhd->bhnm", q * qk_scale(hd), k) + bias.float()[None]
    if mask is not None:
        windows = torch.arange(Bn, device=qkv.device) % mask.shape[0]
        s = s + mask.float()[windows][:, None]
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(dt).float()
    return torch.einsum("bhnm,bmhd->bnhd", p, v).reshape(Bn, N, C).to(dt)


def window_attention_cuda(qkv: torch.Tensor, bias: torch.Tensor, mask: Optional[torch.Tensor], *,
                          num_heads: int) -> torch.Tensor:
    """One launch on the current stream. qkv (Bn, 64, 3C) contiguous bf16
    CUDA; bias (H, 64, 64) and mask (nW, 64, 64) contiguous float32 on the
    same device; hd = C / H <= 64. Raises on anything else and on a failed
    launch."""
    global LAUNCHES
    refuse_grad("window_attention_cuda", qkv, bias, mask)
    tensors = [qkv, bias] + ([] if mask is None else [mask])
    if not all(t.is_cuda and t.device == qkv.device for t in tensors):
        raise ValueError("window_attention_cuda needs its tensors on one CUDA device")
    if qkv.dtype != torch.bfloat16:
        raise ValueError(f"window_attention_cuda needs bfloat16 qkv, got {qkv.dtype}")
    if bias.dtype != torch.float32 or (mask is not None and mask.dtype != torch.float32):
        raise ValueError("window_attention_cuda needs a float32 bias and mask")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("window_attention_cuda needs contiguous tensors")
    H = num_heads
    if qkv.ndim != 3 or qkv.shape[1] != N_TOKENS or qkv.shape[2] % 3 or qkv.shape[0] < 1:
        raise ValueError(f"qkv must be (Bn, {N_TOKENS}, 3C), got {tuple(qkv.shape)}")
    Bn, C = qkv.shape[0], qkv.shape[2] // 3
    if H < 1 or C % H or C // H > 64:
        raise ValueError(f"unsupported heads: C={C}, H={H} (hd = C / H <= 64)")
    if bias.shape != (H, N_TOKENS, N_TOKENS):
        raise ValueError(f"bias must be ({H}, {N_TOKENS}, {N_TOKENS}), got {tuple(bias.shape)}")
    if mask is not None and (mask.ndim != 3 or mask.shape[0] < 1 or mask.shape[1:] != (N_TOKENS, N_TOKENS)):
        raise ValueError(f"mask must be (nW, {N_TOKENS}, {N_TOKENS}), got {tuple(mask.shape)}")
    lib = load_library()
    out = torch.empty((Bn, N_TOKENS, C), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = lib.mellow_window_attention(
            qkv.data_ptr(), bias.data_ptr(), 0 if mask is None else mask.data_ptr(), out.data_ptr(),
            Bn, C, H, 0 if mask is None else mask.shape[0], qk_scale(C // H),
            torch.cuda.current_stream().cuda_stream,
        )
    check(err, "window attention kernel")
    LAUNCHES += 1
    check_outputs("window_attention_cuda", out)
    return out


def window_attention(qkv: torch.Tensor, bias: torch.Tensor, mask: Optional[torch.Tensor], *,
                     num_heads: int) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version otherwise."""
    fn = window_attention_cuda if qkv.is_cuda else window_attention_plain
    return fn(qkv, bias, mask, num_heads=num_heads)
