"""One Swin block: the CUDA kernel chain (``csrc/swin_block.cu``) and its
plain PyTorch version.

Port of the TPU kernel ``mellow_tpu/ops/pallas_swin_block.py``
(``swin_block_fused``), with its rounding points:

    qkv = (LN1(x) rounded @ w_qkv + b_qkv) rounded
    q = (q * scale rounded) rounded, scale = hd^-0.5 in x's dtype
    s = q . k + bias + mask (fp32); p = (exp(s - max) / sum) rounded
    o = (p @ v) rounded;  x1 = x + (o @ w_proj + b_proj) rounded
    g = (LN2(x1) rounded @ w_fc1 + b_fc1) rounded
    out = x1 + (tanh_gelu(g) rounded @ w_fc2 + b_fc2) rounded

Input and output are the (B, R, R, C) grid after the SW-MSA roll; the rolls
stay with the caller, as in the JAX package. ``bias`` is the (H, N, N)
relative-position bias, ``mask`` the (nW, N, N) shifted-window mask or
None. ``swin_block`` dispatches by device; ``LAUNCHES`` counts calls of
the kernel chain; each call launches ``KERNELS_PER_CALL`` kernels (qkv,
window attention, proj, fc1, fc2). ``check_geometry`` refuses what the
kernels do not take.
"""

from __future__ import annotations

from typing import Optional

import torch

from mellow_tpu_torch.ops._build import check, load_library, refuse_grad
from mellow_tpu_torch.ops.mlp_block import MAX_SHARED, mm, panel_shared_bytes
from mellow_tpu_torch.utils.debug import check_outputs

LAUNCHES = 0
KERNELS_PER_CALL = 5
_GELU_C = 0.7978845608028654  # sqrt(2 / pi)


def fused_block_vmem_bytes(C: int, num_heads: int, ws: int, R: int) -> int:
    """The JAX package's gate for the fused Swin block (a copy of
    ``pallas_swin_block.fused_block_vmem_bytes``): the port takes the
    kernel exactly where the TPU path does: stages 1-3 at v0, stage 1 at
    HTSAT-large."""
    N = ws * ws
    weights = 2 * (C * 3 * C + C * C + 2 * C * 4 * C)
    bias = 4 * num_heads * (2 * N) * (2 * N) + 4 * (R // ws) ** 2 * 2 * N * N
    acts = 2 * ws * R * C * (1 + 3 + 4 + 1 + 1) * 2
    return weights + bias + acts


FUSED_BLOCK_BUDGET = 10 << 20  # the JAX gate's 10 MB (models/htsat.py)


def _ln(v: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    vf = v.float()
    d = vf - vf.mean(-1, keepdim=True)
    var = (d * d).mean(-1, keepdim=True)
    return (d * torch.rsqrt(var + eps) * p["scale"].float() + p["bias"].float()).to(v.dtype)


def _linear(a: torch.Tensor, p: dict) -> torch.Tensor:
    return (mm(a, p["kernel"]) + p["bias"].float()).to(a.dtype)


def qk_scale(hd: int, dtype: torch.dtype) -> float:
    """hd^-0.5 rounded to the compute dtype, as the TPU kernel's
    ``jnp.asarray(scale, dt)``."""
    return float(torch.tensor(float(hd) ** -0.5, dtype=torch.float32).to(dtype).float())


def swin_block_plain(x: torch.Tensor, p: dict, bias: torch.Tensor, mask: Optional[torch.Tensor], *,
                     num_heads: int, window_size: int, eps: float = 1e-5) -> torch.Tensor:
    """x (B, R, R, C) -> (B, R, R, C), both residuals applied."""
    dt = x.dtype
    B, R, _, C = x.shape
    ws, H = window_size, num_heads
    N, hd, nWw = ws * ws, C // num_heads, R // window_size
    qkv = _linear(_ln(x, p["norm1"], eps), p["qkv"])  # (B, R, R, 3C)
    win = qkv.reshape(B, nWw, ws, nWw, ws, 3 * C).permute(0, 1, 3, 2, 4, 5).reshape(-1, N, 3, H, hd)
    q = (win[:, :, 0].float() * qk_scale(hd, dt)).to(dt).float()
    k, v = win[:, :, 1].float(), win[:, :, 2].float()
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) + bias.float()[None]
    if mask is not None:
        nW = mask.shape[0]
        s = (s.reshape(-1, nW, H, N, N) + mask.float()[None, :, None]).reshape(-1, H, N, N)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    prob = (e / e.sum(-1, keepdim=True)).to(dt).float()
    o = torch.einsum("bhnm,bmhd->bnhd", prob, v).to(dt)
    o = o.reshape(B, nWw, nWw, ws, ws, C).permute(0, 1, 3, 2, 4, 5).reshape(B, R, R, C)
    x1 = (x.float() + _linear(o, p["proj"]).float()).to(dt)
    g = _linear(_ln(x1, p["norm2"], eps), p["fc1"]).float()
    hid = (0.5 * g * (1.0 + torch.tanh(_GELU_C * (g + 0.044715 * g * g * g)))).to(dt)
    return (x1.float() + _linear(hid, p["fc2"]).float()).to(dt)


def check_geometry(batch: int, R: int, C: int, num_heads: int, window_size: int) -> None:
    """Raises ValueError on what the kernels do not take: a window other
    than 8 x 8, R not a positive multiple of 8, C not a multiple of 8 or of
    the heads, hd = C / H over 64 (the attention pads hd to 32 or 64), no
    batch row, or a LayerNorm launch (a panel of C columns and the weight
    ring) over ``MAX_SHARED`` (C > 1440). The proj and fc2 launches stream
    their K columns and take any width."""
    H = num_heads
    if (window_size != 8 or batch < 1 or R < 8 or R % 8 or C < 8 or C % 8 or H < 1 or C % H
            or C // H > 64):
        raise ValueError(f"unsupported block: B={batch}, R={R}, C={C}, H={H}, ws={window_size}")
    need = panel_shared_bytes(C, 1)
    if need > MAX_SHARED:
        raise ValueError(f"C={C} needs {need} bytes of shared memory a LayerNorm block, over the kernels' "
                         f"{MAX_SHARED}")


# The block's weights in the order the C entry point takes them.
WEIGHT_KEYS = (("norm1", "scale"), ("norm1", "bias"), ("qkv", "kernel"), ("qkv", "bias"),
               ("proj", "kernel"), ("proj", "bias"), ("norm2", "scale"), ("norm2", "bias"),
               ("fc1", "kernel"), ("fc1", "bias"), ("fc2", "kernel"), ("fc2", "bias"))


def swin_block_cuda(x: torch.Tensor, p: dict, bias: torch.Tensor, mask: Optional[torch.Tensor], *,
                    num_heads: int, window_size: int, eps: float = 1e-5) -> torch.Tensor:
    """The kernel chain on the current stream. x (B, R, R, C) contiguous
    bf16 CUDA; the block's weights bf16; bias (H, 64, 64) and mask
    (nW, 64, 64) float32 on the same device; the geometry
    ``check_geometry`` takes."""
    global LAUNCHES
    refuse_grad("swin_block_cuda", x, bias, *(p[a][b] for a, b in WEIGHT_KEYS))
    B, R, R2, C = x.shape
    H = num_heads
    weights = [p[a][b] for a, b in WEIGHT_KEYS]
    if not (x.is_cuda and bias.is_cuda and all(w.is_cuda for w in weights)):
        raise ValueError("swin_block_cuda needs CUDA tensors")
    if x.dtype != torch.bfloat16 or any(w.dtype != torch.bfloat16 for w in weights):
        raise ValueError("swin_block_cuda needs bfloat16 activations and weights")
    if not (x.is_contiguous() and all(w.is_contiguous() for w in weights)):
        raise ValueError("swin_block_cuda needs contiguous tensors")
    if R != R2:
        raise ValueError(f"unsupported block: a {R} x {R2} grid")
    check_geometry(B, R, C, H, window_size)
    nW = (R // 8) ** 2
    bias = bias.float().contiguous()
    if bias.shape != (H, 64, 64):
        raise ValueError(f"bias must be (H, 64, 64), got {tuple(bias.shape)}")
    if mask is not None:
        mask = mask.float().contiguous()
        if mask.shape != (nW, 64, 64) or not mask.is_cuda:
            raise ValueError(f"mask must be ({nW}, 64, 64) on the card")
    lib = load_library()
    M = B * R * R
    qkv = torch.empty((M, 3 * C), dtype=x.dtype, device=x.device)
    o = torch.empty((M, C), dtype=x.dtype, device=x.device)
    x1 = torch.empty_like(o)
    hid = torch.empty((M, 4 * C), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.mellow_swin_block(
            x.data_ptr(), *(w.data_ptr() for w in weights), bias.data_ptr(),
            0 if mask is None else mask.data_ptr(), qkv.data_ptr(), o.data_ptr(),
            x1.data_ptr(), hid.data_ptr(), out.data_ptr(), B, R, C, H,
            qk_scale(C // H, x.dtype), float(eps), torch.cuda.current_stream().cuda_stream,
        )
    check(err, "Swin block kernel")
    LAUNCHES += 1
    check_outputs("swin_block_cuda", out)
    return out


def swin_block(x: torch.Tensor, p: dict, bias: torch.Tensor, mask: Optional[torch.Tensor], *,
               num_heads: int, window_size: int, eps: float = 1e-5) -> torch.Tensor:
    """The kernel chain for CUDA tensors, the plain version otherwise."""
    fn = swin_block_cuda if x.is_cuda else swin_block_plain
    return fn(x, p, bias, mask, num_heads=num_heads, window_size=window_size, eps=eps)
