"""The prefill MLP block's plain version (mellow_tpu_torch.ops.mlp_block)
against the TPU kernel it ports, ``pallas_mlp_block.fused_mlp_block``, run in
interpret mode on the CPU as the JAX package's own tests run it. S = 13
leaves a ragged tail.

Tolerances: fp32 within atol 1e-4 (sums in another order); bf16 within
3e-2 x max|ref| (the same rounding points, sums in another order)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mellow_tpu.ops.pallas_mlp_block import fused_mlp_block
from mellow_tpu_torch.ops import mlp_block as mb
from mellow_tpu_torch.ops import mlp_block_w8a8 as mw

B, S, D, I = 2, 13, 64, 128


def _inputs():
    rng = np.random.RandomState(5)
    return [
        (rng.randn(B, S, D) * 0.5).astype(np.float32),
        (rng.randn(D) * 0.1 + 1.0).astype(np.float32),
        (rng.randn(D, I) * 0.1).astype(np.float32),
        (rng.randn(D, I) * 0.1).astype(np.float32),
        (rng.randn(I, D) * 0.1).astype(np.float32),
    ]


@pytest.mark.parametrize(
    "dtype, jdtype", [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)], ids=["fp32", "bf16"])
def test_plain_matches_tpu_kernel(dtype, jdtype):
    args = [torch.from_numpy(a).to(dtype) for a in _inputs()]
    ours = mb.mlp_block_plain(*args, eps=1e-5).float().numpy()
    theirs = np.asarray(fused_mlp_block(
        *(jnp.asarray(t.float().numpy(), jdtype) for t in args), eps=1e-5, interpret=True,
    ).astype(jnp.float32))
    assert ours.shape == theirs.shape == (B, S, D)
    assert np.isfinite(ours).all()
    atol = 1e-4 if dtype == torch.float32 else 3e-2 * np.abs(theirs).max()
    np.testing.assert_allclose(ours, theirs, atol=atol, rtol=0)


def test_dispatch_uses_plain_version_on_cpu():
    args = [torch.from_numpy(a).to(torch.bfloat16) for a in _inputs()]
    before = mb.LAUNCHES
    out = mb.mlp_block(*args, eps=1e-5)
    assert mb.LAUNCHES == before
    torch.testing.assert_close(out, mb.mlp_block_plain(*args, eps=1e-5), rtol=0, atol=0)


def test_cuda_wrapper_rejects_cpu_tensors():
    args = [torch.from_numpy(a).to(torch.bfloat16) for a in _inputs()]
    with pytest.raises(ValueError, match="CUDA"):
        mb.mlp_block_cuda(*args, eps=1e-5)


def test_mlp_block_geometry_and_shared_memory():
    """The geometry #6's kernels take (``mb.check_geometry``), without a card:
    the gate/up launch's shared memory against the kernels' layout (csrc
    ``dense_panel_smem_bytes``: a 64-row panel of D columns padded to a
    multiple of 32, plus 8, and a ring of 4 stages of 32 x 72 bf16 for each
    of the two weights), the down launch's
    (``dense_stream_smem_bytes``: 4 stages of 64 x 40 A and 32 x 72 weight
    values, whatever I is), and the refusals at every edge."""
    assert mb.panel_shared_bytes(576, 2) == 64 * 584 * 2 + 2 * 4 * 32 * 72 * 2
    assert mb.panel_shared_bytes(560, 2) == mb.panel_shared_bytes(576, 2)  # D padded to 576
    assert mb.panel_shared_bytes(64, 2) == 64 * 72 * 2 + 2 * 4 * 32 * 72 * 2
    assert mb.STREAM_SHARED_BYTES == 4 * (64 * 40 + 32 * 72) * 2
    for rows, D_, I_ in ((389, 576, 1536), (1556, 576, 1536), (1, 64, 128), (100, 768, 2048), (1, 1280, 8)):
        mb.check_geometry(rows, D_, I_)
    for rows, D_, I_ in ((0, 576, 1536), (389, 580, 1536), (389, 576, 1540), (389, 0, 1536), (389, 576, 0)):
        with pytest.raises(ValueError, match="unsupported"):
            mb.check_geometry(rows, D_, I_)
    # The last D whose panel fits 200 KB is 1280; 1288 pads to 1312.
    with pytest.raises(ValueError, match="shared memory"):
        mb.check_geometry(389, 1288, 1536)


def test_mlp_block_w8a8_geometry_and_shared_memory():
    """The geometry #7's kernels take (``mw.check_geometry``), without a card:
    the gate/up launch's shared memory against the kernel's layout (csrc
    ``w8_gate_up_smem_bytes``: the fp32 product of a block's
    ceil(I / 512) column tiles over 32 rows, row stride 64 per tile plus 16;
    the 4 rows of x the block quantizes for its cluster, D padded to a
    multiple of 32, plus 8, in bf16; the 32-row int8 panel, plus 16; gate's
    and up's rings of 4 stages of 32 x 80 bytes for each of up to 4 tiles at
    once; the tiles' bf16 gate and up scales), and the refusals at every
    edge."""
    def layout(D, I):
        kp, t = -(-D // 32) * 32, -(-I // 512)
        return (32 * (64 * t + 16) * 4 + 4 * (kp + 8) * 2 + 32 * (kp + 16) + 2 * min(t, 4) * 4 * 32 * 80
                + 2 * t * 64 * 2)

    assert mw.gate_up_shared_bytes(576, 1536) == layout(576, 1536) == 112448
    for D, I in ((64, 128), (768, 2048), (560, 1536), (576, 2560), (2880, 1536)):
        assert mw.gate_up_shared_bytes(D, I) == layout(D, I)
    for rows, D, I in ((389, 576, 1536), (1556, 576, 1536), (1, 16, 16), (100, 768, 2048), (1, 576, 5632),
                       (1, 2880, 1536)):
        mw.check_geometry(rows, D, I)
    for rows, D, I in ((0, 576, 1536), (389, 584, 1536), (389, 576, 1544), (389, 0, 1536), (389, 576, 0)):
        with pytest.raises(ValueError, match="unsupported"):
            mw.check_geometry(rows, D, I)
    # The last I at D = 576 and the last D at I = 1536 whose gate/up block fits 200 KB.
    for D, I in ((576, 5648), (2896, 1536)):
        with pytest.raises(ValueError, match="shared memory"):
            mw.check_geometry(389, D, I)
