"""The W8A8 prefill MLP block: the CUDA kernels (``csrc/mlp_block_w8a8.cu``)
and their plain PyTorch version.

Port of the TPU kernel ``mellow_tpu/ops/pallas_mlp_block.py``
(``fused_mlp_block_w8a8``):

    h8, hs = rowquant(rms_norm_f32(x))          the fp32 norm, not rounded
    gate = silu((h8 @ wg8) * hs * sg);  up = (h8 @ wu8) * hs * su   fp32
    p8, ps = rowquant(gate * up)                over all I columns
    out = x + ((p8 @ wd8) * ps * sd) rounded

with int8 weights in ``llama.quantize_weight``'s ``(in, out)`` layout and
per-column scales in the compute dtype (widened to fp32). ``mlp_block_w8a8``
dispatches by device; ``LAUNCHES`` counts calls of the kernels, each
``KERNELS_PER_CALL`` launches (gate/up with both quantizers, then down).
``check_geometry`` refuses what the kernels do not take.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mellow_tpu_torch.ops._build import check, load_library, refuse_grad
from mellow_tpu_torch.ops.int8 import mm8, rms_norm_f32, rowquant
from mellow_tpu_torch.utils.debug import check_outputs

LAUNCHES = 0
KERNELS_PER_CALL = 2

# csrc/mlp_block_w8a8.cu's gate/up launch: 32-row blocks, a cluster of 8
# blocks over a row block's 64-column tiles of I, each block working on up
# to 4 of its tiles at once with a ring for each weight and tile (4 stages
# of 32 weight rows x 80 bytes), each quantizing 4 rows for the cluster; and
# the dynamic shared-memory cap.
ROWS, CLUSTER, TILE_COLS, MAX_AT_ONCE, RING_BYTES = 32, 8, 64, 4, 4 * 32 * 80
MAX_SHARED = 200 * 1024


def gate_up_shared_bytes(D: int, I: int) -> int:
    """The gate/up launch's dynamic shared memory (csrc
    ``w8_gate_up_smem_bytes``): the fp32 product of the block's tiles, the
    bf16 rows of x it quantizes, the int8 panel, gate's and up's rings for
    each tile worked on at once, the tiles' column scales."""
    kp = -(-D // 32) * 32
    tiles = -(-I // (TILE_COLS * CLUSTER))
    at_once = min(tiles, MAX_AT_ONCE)
    return (ROWS * (tiles * TILE_COLS + 16) * 4 + ROWS // CLUSTER * (kp + 8) * 2 + ROWS * (kp + 16)
            + 2 * at_once * RING_BYTES + 2 * tiles * TILE_COLS * 2)


def check_geometry(rows: int, D: int, I: int) -> None:
    """Raises ValueError on what the kernels do not take: no rows, D or I
    not a multiple of 16 (int8 rows load as 16-byte vectors), or a gate/up
    launch over ``MAX_SHARED``."""
    if rows < 1 or D % 16 or I % 16 or D < 16 or I < 16:
        raise ValueError(f"unsupported W8A8 MLP geometry: {rows} rows, D={D}, I={I}")
    need = gate_up_shared_bytes(D, I)
    if need > MAX_SHARED:
        raise ValueError(f"D={D}, I={I} need {need} bytes of shared memory a gate/up block, over the "
                         f"kernels' {MAX_SHARED}")


def mlp_block_w8a8_plain(x, ln_w, wg_q, wg_s, wu_q, wu_s, wd_q, wd_s, *, eps: float) -> torch.Tensor:
    """x (B, S, D) -> x + down(silu(gate) * up), W8A8 as the TPU kernel."""
    h8, hs = rowquant(rms_norm_f32(x, ln_w, eps))
    gate = F.silu(mm8(h8, wg_q) * hs * wg_s.float())
    up = mm8(h8, wu_q) * hs * wu_s.float()
    p8, ps = rowquant(gate * up)
    y = mm8(p8, wd_q) * ps * wd_s.float()
    return (x.float() + y.to(x.dtype).float()).to(x.dtype)


def mlp_block_w8a8_cuda(x, ln_w, wg_q, wg_s, wu_q, wu_s, wd_q, wd_s, *, eps: float) -> torch.Tensor:
    """The kernels on the current stream. x (B, S, D) contiguous bf16
    CUDA; weights contiguous int8 (in, out) with bf16 (out,) scales."""
    global LAUNCHES
    refuse_grad("mlp_block_w8a8_cuda", x, ln_w, wg_s, wu_s, wd_s)
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
    if (wg_q.shape != (D, I) or wu_q.shape != (D, I) or wd_q.shape != (I, D) or wg_s.shape != (I,)
            or wu_s.shape != (I,) or wd_s.shape != (D,) or ln_w.shape != (D,)):
        raise ValueError(f"unsupported shapes x {tuple(x.shape)}, w_gate {tuple(wg_q.shape)}")
    M = x.numel() // D
    check_geometry(M, D, I)
    dev = x.device
    lib = load_library()
    p8 = torch.empty((M, I), dtype=torch.int8, device=dev)
    ps = torch.empty((M,), dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        err = lib.mellow_mlp_block_w8a8(
            x.data_ptr(), ln_w.data_ptr(), wg_q.data_ptr(), wg_s.data_ptr(), wu_q.data_ptr(),
            wu_s.data_ptr(), wd_q.data_ptr(), wd_s.data_ptr(), p8.data_ptr(), ps.data_ptr(),
            out.data_ptr(), M, D, I, float(eps), torch.cuda.current_stream().cuda_stream,
        )
    check(err, "W8A8 MLP block kernel")
    LAUNCHES += 1
    check_outputs("mlp_block_w8a8_cuda", out)
    return out


def mlp_block_w8a8(x, ln_w, wg_q, wg_s, wu_q, wu_s, wd_q, wd_s, *, eps: float) -> torch.Tensor:
    """The kernels for CUDA tensors, the plain version otherwise."""
    fn = mlp_block_w8a8_cuda if x.is_cuda else mlp_block_w8a8_plain
    return fn(x, ln_w, wg_q, wg_s, wu_q, wu_s, wd_q, wd_s, eps=eps)
