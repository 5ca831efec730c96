"""Plain PyTorch pieces shared by the int8 kernels' plain versions
(``ops/attn_block.py`` in its ``kv_quant`` mode, ``ops/attn_block_w8a8.py``,
``ops/mlp_block_w8a8.py``), with the TPU kernels' formulas:

    rms_norm_f32(x)  the fp32 RMSNorm, not rounded (the W8A8 kernels
                     quantize the fp32 value)
    rowquant(x)      per-row symmetric int8: sc = max(max|x|, 1e-8) * (1/127),
                     q = clip(round(x / sc), -127, 127), round half to even
                     (``pallas_mlp_block._rowquant``; the in-kernel k/v
                     quantization ``pallas_attn_block._emit_quantized_kv``
                     is the same formula over the KV*hd lanes)
    mm8(a8, w8)      an int8 x int8 product with exact integer sums, as fp32
"""

from __future__ import annotations

import numpy as np
import torch

# The TPU kernels multiply by 1/127 taken in fp32 (a weakly typed Python
# constant in a float32 product).
INV127 = float(np.float32(1.0 / 127.0))


def rms_norm_f32(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * weight in fp32, left in fp32."""
    xf = x.float()
    return xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps) * weight.float()


def rowquant(x: torch.Tensor):
    """fp32 (..., N) -> (int8 (..., N), fp32 scale (..., 1))."""
    sc = x.abs().amax(-1, keepdim=True).clamp_min(1e-8) * INV127
    return torch.round(x / sc).clamp(-127, 127).to(torch.int8), sc


def mm8(a8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """int8 (..., K) @ int8 (K, N) -> fp32. The sums run in float64, where
    every partial sum of int8 products is an exact integer (as the int32
    sums of the kernels are), and are rounded to fp32 once."""
    return (a8.double() @ w8.double()).float()
