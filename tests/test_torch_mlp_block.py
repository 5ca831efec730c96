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
