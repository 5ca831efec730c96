"""The prefill attention block's plain version (mellow_tpu_torch.ops.
attn_block) against the TPU kernel it ports,
``pallas_attn_block.fused_attn_block``, run in interpret mode on the CPU as
the JAX package's own tests run it. S = 13 leaves a ragged tail of the
kernel's 8-row alignment.

Tolerances: fp32 within atol 1e-4 (sums in another order); bf16 within
3e-2 x max|ref| per output (RoPE is rounded once here and after each of its
three steps on the TPU; sums run in another order)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mellow_tpu.config import LlamaConfig
from mellow_tpu.models.llama import rope_tables
from mellow_tpu.ops.pallas_attn_block import fused_attn_block
from mellow_tpu_torch.ops import attn_block as ab

B, S, D, H, KV, HD = 2, 13, 64, 4, 2, 16
KW = dict(num_heads=H, num_kv_heads=KV, head_dim=HD, eps=1e-5)


def _inputs():
    rng = np.random.RandomState(4)
    cos, sin = rope_tables(LlamaConfig(head_dim=HD), S)
    return {
        "x": (rng.randn(B, S, D) * 0.5).astype(np.float32),
        "ln_w": (rng.randn(D) * 0.1 + 1.0).astype(np.float32),
        "wq": (rng.randn(D, H * HD) * 0.1).astype(np.float32),
        "wk": (rng.randn(D, KV * HD) * 0.1).astype(np.float32),
        "wv": (rng.randn(D, KV * HD) * 0.1).astype(np.float32),
        "wo": (rng.randn(H * HD, D) * 0.1).astype(np.float32),
        "cos": cos, "sin": sin,
    }


@pytest.fixture(scope="module", params=["fp32", "bf16"])
def pair(request):
    dtype, jdtype = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}[request.param]
    args = {k: torch.from_numpy(v).to(dtype) for k, v in _inputs().items()}
    ours = ab.attn_block_plain(*args.values(), **KW)
    theirs = fused_attn_block(
        *(jnp.asarray(t.float().numpy(), jdtype) for t in args.values()), interpret=True, **KW)
    return request.param, [t.float().numpy() for t in ours], [np.asarray(t.astype(jnp.float32)) for t in theirs]


@pytest.mark.parametrize("i, name", [(0, "out"), (1, "k"), (2, "v")])
def test_plain_matches_tpu_kernel(pair, i, name):
    mode, ours, theirs = pair
    assert ours[i].shape == theirs[i].shape
    assert np.isfinite(ours[i]).all()
    atol = 1e-4 if mode == "fp32" else 3e-2 * np.abs(theirs[i]).max()
    np.testing.assert_allclose(ours[i], theirs[i], atol=atol, rtol=0, err_msg=name)


def test_dispatch_writes_kv_destinations_on_cpu():
    args = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in _inputs().items()}
    cache = torch.zeros((2, B, S + 5, KV, HD), dtype=torch.bfloat16)
    before = ab.LAUNCHES
    out, k, v = ab.attn_block(*args.values(), **KW, k_out=cache[0, :, :S], v_out=cache[1, :, :S])
    assert ab.LAUNCHES == before
    ref = ab.attn_block_plain(*args.values(), **KW)
    torch.testing.assert_close(out, ref[0], rtol=0, atol=0)
    torch.testing.assert_close(cache[0, :, :S].reshape(B, S, -1), ref[1], rtol=0, atol=0)
    torch.testing.assert_close(cache[1, :, :S].reshape(B, S, -1), ref[2], rtol=0, atol=0)
    assert cache[:, :, S:].abs().sum() == 0


def test_cuda_wrapper_rejects_cpu_tensors():
    args = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in _inputs().items()}
    with pytest.raises(ValueError, match="CUDA"):
        ab.attn_block_cuda(*args.values(), **KW)


def test_attn_block_geometry_and_shared_memory():
    """The geometry #4's and #5's kernels take (``ab.check_geometry``),
    without a card: four head geometries from one position to the
    attention core's cap, the projections' shared memory at v0 against the
    kernels' layout (csrc ``proj_smem_bytes``: 64-row blocks in bf16, 32 in
    int8), and the refusals at every edge."""
    for int8 in (False, True):
        for S in (1, 389, ab.MAX_S):
            for H, KV in ((9, 3), (12, 12), (8, 2), (12, 4)):
                ab.check_geometry(576, H, KV, 64, S, int8)
    # bf16: 64 rows of (576 + 8) bf16 and 4 stages of 32 x 72 bf16; the int8
    # q/k/v launch stages 32 rows of x, its 32 rows of 576 + 16 int8 and the
    # int8 ring's 4 x 32 x 80; the int8 o launch has no bf16 rows.
    assert ab.proj_shared_bytes(576, False) == 64 * 584 * 2 + 4 * 32 * 72 * 2
    assert ab.proj_shared_bytes(576, True) == 32 * 584 * 2 + 32 * 592 + 4 * 32 * 80
    assert ab.proj_shared_bytes(560, False) == 64 * 584 * 2 + 4 * 32 * 72 * 2  # K padded to 576
    assert ab.proj_shared_bytes(576, True, qkv=False) == 32 * 592 + 4 * 32 * 80  # o8 straight in
    for bad in (dict(seq=0), dict(seq=ab.MAX_S + 1), dict(head_dim=32), dict(num_kv_heads=2), dict(D=580)):
        args = dict(D=576, num_heads=9, num_kv_heads=3, head_dim=64, seq=389, int8=False)
        with pytest.raises(ValueError, match="unsupported"):
            ab.check_geometry(**{**args, **bad})
    with pytest.raises(ValueError, match="unsupported"):
        ab.check_geometry(584, 9, 3, 64, 389, True)  # int8 rows need D % 16 == 0
    ab.check_geometry(584, 9, 3, 64, 389, False)
    # 64 bf16 rows of K = 1536 overflow the projections' shared memory; 32
    # int8 rows with x staged fit, and at K = 2048 they do not.
    with pytest.raises(ValueError, match="shared memory"):
        ab.check_geometry(1536, 24, 8, 64, 389, False)
    ab.check_geometry(1536, 24, 8, 64, 389, True)
    with pytest.raises(ValueError, match="shared memory"):
        ab.check_geometry(2048, 32, 8, 64, 389, True)
