"""The prefill MLP block: the CUDA kernel (``csrc/mlp_block.cu``) and its
plain PyTorch version.

Port of the TPU kernel ``mellow_tpu/ops/pallas_mlp_block.py``
(``fused_mlp_block``):

    h = rms_norm(x) (fp32, rounded to x's dtype)
    gate = silu(h @ w_gate in fp32) rounded;  up = (h @ w_up) rounded
    out = x + ((gate * up) rounded @ w_down) rounded

``mlp_block`` dispatches by device: the kernel for a CUDA tensor, the plain
version for a CPU one. ``LAUNCHES`` counts calls of the kernel chain;
each call launches ``KERNELS_PER_CALL`` kernels (gate/up, then down).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mellow_tpu_torch.ops._build import check, load_library

LAUNCHES = 0
KERNELS_PER_CALL = 2


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in fp32, cast back to x's dtype (llama.rms_norm)."""
    xf = x.float()
    return (xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps) * weight.float()).to(x.dtype)


def mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w with exact products and fp32 sums (the kernels' tensor-core
    contract), result in fp32."""
    return a.float() @ w.float()


def mlp_block_plain(x, ln_w, w_gate, w_up, w_down, *, eps: float) -> torch.Tensor:
    """x (B, S, D) -> x + down(silu(gate(norm x)) * up(norm x)), with the
    TPU kernel's rounding points."""
    dt = x.dtype
    h = rms_norm(x, ln_w, eps)
    gate = F.silu(mm(h, w_gate)).to(dt)
    up = mm(h, w_up).to(dt)
    y = mm((gate.float() * up.float()).to(dt), w_down).to(dt)
    return (x.float() + y.float()).to(dt)


def mlp_block_cuda(x, ln_w, w_gate, w_up, w_down, *, eps: float) -> torch.Tensor:
    """The kernel chain on the current stream. x (B, S, D) contiguous bf16
    CUDA; weights contiguous bf16 on the same device."""
    global LAUNCHES
    tensors = (x, ln_w, w_gate, w_up, w_down)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("mlp_block_cuda needs CUDA tensors")
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise ValueError("mlp_block_cuda needs bfloat16 tensors")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("mlp_block_cuda needs contiguous tensors")
    D = x.shape[-1]
    I = w_gate.shape[1]
    if (w_gate.shape != (D, I) or w_up.shape != (D, I) or w_down.shape != (I, D)
            or ln_w.shape != (D,) or D % 8 or I % 8):
        raise ValueError(f"unsupported shapes x {tuple(x.shape)}, w_gate {tuple(w_gate.shape)}")
    M = x.numel() // D
    lib = load_library()
    act = torch.empty((M, I), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.mellow_mlp_block(
            x.data_ptr(), ln_w.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
            w_down.data_ptr(), act.data_ptr(), out.data_ptr(), M, D, I, float(eps),
            torch.cuda.current_stream().cuda_stream,
        )
    check(err, "MLP block kernel")
    LAUNCHES += 1
    return out


def mlp_block(x, ln_w, w_gate, w_up, w_down, *, eps: float) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version otherwise."""
    fn = mlp_block_cuda if x.is_cuda else mlp_block_plain
    return fn(x, ln_w, w_gate, w_up, w_down, eps=eps)
