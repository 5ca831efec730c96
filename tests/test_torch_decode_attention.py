"""The decode-attention kernel's plain version (mellow_tpu_torch.ops.
decode_attention) against the TPU kernel it ports,
``pallas_decode_attention.flash_gqa_decode``, run in interpret mode on the
CPU as the JAX package's own tests run it.

The TPU kernel reads a packed [K | V] cache, block-diagonal dense queries
and a window of extra positions; that layout is built here only, from the
same seeded k/v: the cache holds positions [0, n - 1) and the last position
rides as the one extra row, which is the port's "write, then attend over
[0, n)" in the TPU kernel's terms.

Tolerances: fp32 within atol 1e-5 (sums in another order); bf16 within
3e-2 x max|ref| (the unnormalised exp is rounded to bf16 in both, but the
dots' sums differ in order and a rounding can land on either side)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mellow_tpu.ops.pallas_decode_attention import HEAD_PAD, flash_gqa_decode
from mellow_tpu_torch.ops import decode_attention as da

B, H, KV, HD, S_MAX = 2, 4, 2, 16, 24


def _inputs(seed, n):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, H, HD) * 0.5).astype(np.float32)
    k = (rng.randn(B, S_MAX, KV, HD) * 0.5).astype(np.float32)
    v = (rng.randn(B, S_MAX, KV, HD)).astype(np.float32)
    k[:, n:] = 1e3  # positions past n must not be read
    v[:, n:] = np.nan
    return q, k, v


def _tpu_kernel(q, k, v, n, dtype):
    """flash_gqa_decode on the packed layout; returns (B, H, hd)."""
    KL = KV * HD
    rep = H // KV
    P2 = 2 * KL
    flushed = n - 1
    S8 = -(-flushed // 8) * 8
    q_dense = np.zeros((B, HEAD_PAD, P2), np.float32)
    for h in range(H):
        g = h // rep
        q_dense[:, h, g * HD:(g + 1) * HD] = q[:, h]
    rows = np.concatenate([k.reshape(B, S_MAX, KL), v.reshape(B, S_MAX, KL)], axis=-1)
    kv = np.zeros((1, B, S8, P2), np.float32)
    kv[0, :, :flushed] = rows[:, :flushed]
    extra = np.zeros((B, 8, P2), np.float32)
    extra[:, 0] = rows[:, flushed]
    out = flash_gqa_decode(
        jnp.asarray(q_dense, dtype), jnp.asarray(kv, dtype), None, jnp.asarray(extra, dtype),
        jnp.int32(0), jnp.int32(flushed), jnp.int32(1), head_dim=HD, interpret=True,
    )
    o_pk = np.asarray(out.astype(jnp.float32))[:, :H, KL:]
    return np.stack([o_pk[:, h, (h // rep) * HD:(h // rep + 1) * HD] for h in range(H)], axis=1)


@pytest.mark.parametrize(
    "dtype, jdtype, n",
    [(torch.float32, jnp.float32, 9), (torch.float32, jnp.float32, 17),
     (torch.bfloat16, jnp.bfloat16, 9), (torch.bfloat16, jnp.bfloat16, 17)],
    ids=["fp32-n9", "fp32-n17", "bf16-n9", "bf16-n17"],
)
def test_plain_matches_tpu_kernel(dtype, jdtype, n):
    q, k, v = _inputs(n, n)
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    ours = da.decode_attention_plain(tq, tk, tv, n).float().numpy()
    # The TPU kernel sees the same (dtype-rounded) values.
    rq, rk, rv = (t.float().numpy() for t in (tq, tk, tv))
    theirs = _tpu_kernel(rq, rk, rv, n, jdtype)
    assert ours.shape == theirs.shape == (B, H, HD)
    assert np.isfinite(ours).all()
    if dtype == torch.float32:
        np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(ours, theirs, atol=3e-2 * np.abs(theirs).max(), rtol=0)


def test_dispatch_uses_plain_version_on_cpu():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(1, 6))
    before = da.LAUNCHES
    out = da.decode_attention(q, k, v, 6)
    assert da.LAUNCHES == before
    torch.testing.assert_close(out, da.decode_attention_plain(q, k, v, 6), rtol=0, atol=0)


def test_cuda_wrapper_rejects_cpu_tensors():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(2, 6))
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_attention_cuda(q, k, v, 6)
