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
``check_geometry`` refuses what the kernels do not take; the shared-memory
sizes of ``csrc/proj_mma_core.cuh``'s dense products are here too, for
``ops/swin_block.py`` as well.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mellow_tpu_torch.ops._build import check, load_library, refuse_grad
from mellow_tpu_torch.utils.debug import check_outputs

LAUNCHES = 0
KERNELS_PER_CALL = 2

# csrc/proj_mma_core.cuh's dense products: 64-row blocks (launch_dense_*),
# a ring of 4 stages of 32 weight rows x 64 columns (PJ_STAGES, PJ_BK,
# PJ_BN; rows padded to 72 bf16), streamed A stages of 32 columns (rows
# padded to 40), and the dynamic shared-memory cap (PJ_MAX_DSMEM).
TILE_ROWS, RING_STAGES, RING_ROWS, TILE_COLS = 64, 4, 32, 64
MAX_SHARED = 200 * 1024


def panel_shared_bytes(K: int, weights: int) -> int:
    """A panel launch's dynamic shared memory (csrc
    ``dense_panel_smem_bytes``): the block's whole-row panel of K columns,
    padded to a multiple of 32, and a weight ring for each weight."""
    kp = -(-K // RING_ROWS) * RING_ROWS
    return TILE_ROWS * (kp + 8) * 2 + weights * RING_STAGES * RING_ROWS * (TILE_COLS + 8) * 2


# A stream launch's (csrc ``dense_stream_smem_bytes``): the A ring beside
# the weight ring, whatever K is.
STREAM_SHARED_BYTES = RING_STAGES * (TILE_ROWS * (RING_ROWS + 8) + RING_ROWS * (TILE_COLS + 8)) * 2


def check_geometry(rows: int, D: int, I: int) -> None:
    """Raises ValueError on what the kernels do not take: no rows, D or I
    not a multiple of 8, or a gate/up launch (a panel of D columns and two
    weight rings) over ``MAX_SHARED`` (D > 1280). The down launch streams
    its K = I columns and takes any I."""
    if rows < 1 or D % 8 or I % 8 or D < 8 or I < 8:
        raise ValueError(f"unsupported MLP geometry: {rows} rows, D={D}, I={I}")
    need = panel_shared_bytes(D, 2)
    if need > MAX_SHARED:
        raise ValueError(f"D={D} needs {need} bytes of shared memory a gate/up block, over the kernels' "
                         f"{MAX_SHARED}")


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
    refuse_grad("mlp_block_cuda", x, ln_w, w_gate, w_up, w_down)
    tensors = (x, ln_w, w_gate, w_up, w_down)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("mlp_block_cuda needs CUDA tensors")
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise ValueError("mlp_block_cuda needs bfloat16 tensors")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("mlp_block_cuda needs contiguous tensors")
    D = x.shape[-1]
    I = w_gate.shape[1]
    if w_gate.shape != (D, I) or w_up.shape != (D, I) or w_down.shape != (I, D) or ln_w.shape != (D,):
        raise ValueError(f"unsupported shapes x {tuple(x.shape)}, w_gate {tuple(w_gate.shape)}")
    M = x.numel() // D
    check_geometry(M, D, I)
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
    check_outputs("mlp_block_cuda", out)
    return out


def mlp_block(x, ln_w, w_gate, w_up, w_down, *, eps: float) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version otherwise."""
    fn = mlp_block_cuda if x.is_cuda else mlp_block_plain
    return fn(x, ln_w, w_gate, w_up, w_down, eps=eps)
