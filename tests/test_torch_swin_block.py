"""The Swin block's plain version (mellow_tpu_torch.ops.swin_block) against
the TPU kernel it ports, ``pallas_swin_block.swin_block_fused``, run in
interpret mode on the CPU as ``tests/test_pallas_swin_block.py`` runs it:
the rolls outside, W-MSA and SW-MSA (with the -100 mask). hd = 24, as at
every v0 stage, which is not a multiple of the 16-deep tensor-core step.

Tolerances: fp32 within atol 1e-4 (both use the tanh GELU; sums in another
order); bf16 within 3e-2 x max|ref|. The port's ``htsat.swin_block`` in
bf16 takes this path where the JAX gate does, checked on the CPU too."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mellow_tpu.models import htsat as jhtsat
from mellow_tpu.ops.pallas_swin_block import swin_block_fused
from mellow_tpu_torch.models import htsat as thtsat
from mellow_tpu_torch.ops import swin_block as sb

B, R, C, H, WS = 2, 16, 48, 2, 8
N = WS * WS
_ORDER = [("norm1", "scale"), ("norm1", "bias"), ("qkv", "kernel"), ("qkv", "bias"),
          ("proj", "kernel"), ("proj", "bias"), ("norm2", "scale"), ("norm2", "bias"),
          ("fc1", "kernel"), ("fc1", "bias"), ("fc2", "kernel"), ("fc2", "bias")]


def _params(rng):
    def lin(i, o):
        return {"kernel": (rng.randn(i, o) * 0.1).astype(np.float32),
                "bias": (rng.randn(o) * 0.05).astype(np.float32)}

    def ln():
        return {"scale": (rng.randn(C) * 0.1 + 1.0).astype(np.float32),
                "bias": (rng.randn(C) * 0.05).astype(np.float32)}

    return {"norm1": ln(), "qkv": lin(C, 3 * C), "proj": lin(C, C), "norm2": ln(),
            "fc1": lin(C, 4 * C), "fc2": lin(4 * C, C),
            "rel_bias_table": (rng.randn((2 * WS - 1) ** 2, H) * 0.5).astype(np.float32)}


def _bias(table):
    idx = jhtsat.relative_position_index(WS).reshape(-1)
    return table[idx].reshape(N, N, H).transpose(2, 0, 1)  # (H, N, N)


def _run_tpu_kernel(x4, p, shift, jdtype):
    mask = jhtsat.shifted_window_mask(R, WS, shift) if shift else None
    out = swin_block_fused(
        jnp.asarray(x4, jdtype), *(jnp.asarray(p[a][b], jdtype) for a, b in _ORDER),
        jnp.asarray(_bias(p["rel_bias_table"]).reshape(H * N, N), jnp.float32), mask,
        num_heads=H, window_size=WS, interpret=True,
    )
    return np.asarray(out.astype(jnp.float32))


def _cast(p, dtype):
    return {k: (_cast(v, dtype) if isinstance(v, dict) else torch.from_numpy(v).to(dtype))
            for k, v in p.items()}


@pytest.mark.parametrize("shift", [0, 4], ids=["W-MSA", "SW-MSA"])
@pytest.mark.parametrize(
    "dtype, jdtype", [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)], ids=["fp32", "bf16"])
def test_plain_matches_tpu_kernel(dtype, jdtype, shift):
    rng = np.random.RandomState(shift + 7)
    x4 = (rng.randn(B, R, R, C) * 0.5).astype(np.float32)
    p = _params(rng)
    tp = _cast(p, dtype)
    tx = torch.from_numpy(x4).to(dtype)
    mask = torch.from_numpy(thtsat.shifted_window_mask(R, WS, shift)) if shift else None
    bias = torch.from_numpy(_bias(tp["rel_bias_table"].float().numpy()))
    ours = sb.swin_block_plain(tx, tp, bias, mask, num_heads=H, window_size=WS).float().numpy()
    # The TPU kernel gets the same dtype-rounded inputs.
    rounded = {k: ({kk: vv.float().numpy() for kk, vv in v.items()} if isinstance(v, dict)
                   else v.float().numpy()) for k, v in tp.items()}
    theirs = _run_tpu_kernel(tx.float().numpy(), rounded, shift, jdtype)
    assert ours.shape == theirs.shape == (B, R, R, C)
    assert np.isfinite(ours).all()
    atol = 1e-4 if dtype == torch.float32 else 3e-2 * np.abs(theirs).max()
    np.testing.assert_allclose(ours, theirs, atol=atol, rtol=0)


@pytest.mark.parametrize("shift", [0, 4], ids=["W-MSA", "SW-MSA"])
def test_htsat_swin_block_takes_the_kernel_path_in_bf16(shift):
    """htsat.swin_block in bf16 = roll, the block's plain version, unroll;
    no kernel launch on the CPU."""
    rng = np.random.RandomState(11)
    x = torch.from_numpy((rng.randn(B, R * R, C) * 0.5).astype(np.float32)).to(torch.bfloat16)
    tp = _cast(_params(rng), torch.bfloat16)
    before = sb.LAUNCHES
    got = thtsat.swin_block(x, tp, R, H, WS, shift)
    assert sb.LAUNCHES == before
    x4 = torch.roll(x.reshape(B, R, R, C), (-shift, -shift), (1, 2))
    mask = torch.from_numpy(thtsat.shifted_window_mask(R, WS, shift)) if shift else None
    bias = torch.from_numpy(_bias(tp["rel_bias_table"].float().numpy()))
    want = torch.roll(sb.swin_block_plain(x4, tp, bias, mask, num_heads=H, window_size=WS),
                      (shift, shift), (1, 2)).reshape(B, R * R, C)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_gate_matches_jax_package():
    from mellow_tpu.ops.pallas_swin_block import fused_block_vmem_bytes

    for C_, H_, R_ in [(96, 4, 64), (192, 8, 32), (384, 16, 16), (768, 32, 8)]:
        assert sb.fused_block_vmem_bytes(C_, H_, 8, R_) == fused_block_vmem_bytes(C_, H_, 8, R_)
    # v0: stages 1-3 take the kernel, stage 4 does not.
    assert [sb.fused_block_vmem_bytes(c, h, 8, r) <= sb.FUSED_BLOCK_BUDGET
            for c, h, r in [(96, 4, 64), (192, 8, 32), (384, 16, 16), (768, 32, 8)]] == [True, True, True, False]


def test_swin_block_geometry_and_shared_memory():
    """The geometry #8's kernels take (``sb.check_geometry``), without a card:
    every stage that takes the kernel at v0 and at HTSAT-large's widths, the
    LayerNorm launches' shared memory against the kernels' layout (csrc
    ``dense_panel_smem_bytes``: a 64-row panel of C columns padded to a
    multiple of 32, plus 8, and one ring of 4 stages of 32 x 72 bf16), and
    the refusals at every edge."""
    from mellow_tpu_torch.config import get_config

    enc = get_config("v0").encoder
    res, C_ = enc.grid_size, enc.embed_dim
    for H_ in enc.num_heads:
        if thtsat.kernel_route(C_, H_, 8, res) == "swin_block":
            for batch in (1, 4):
                sb.check_geometry(batch, res, C_, H_, 8)
        res, C_ = res // 2, C_ * 2
    sb.check_geometry(4, 64, 256, 4, 8)  # HTSAT-large stage 1, hd = 64
    sb.check_geometry(1, 8, 1440, 24, 8)  # the widest panel that fits
    assert sb.panel_shared_bytes(96, 1) == 64 * 104 * 2 + 4 * 32 * 72 * 2
    assert sb.panel_shared_bytes(384, 1) == 64 * 392 * 2 + 4 * 32 * 72 * 2
    assert sb.panel_shared_bytes(60, 1) == 64 * 72 * 2 + 4 * 32 * 72 * 2  # C padded to 64
    for bad in (dict(window_size=7), dict(batch=0), dict(R=0), dict(R=12), dict(C=100, num_heads=4),
                dict(C=96, num_heads=5), dict(C=520, num_heads=8)):
        args = {**dict(batch=1, R=64, C=96, num_heads=4, window_size=8), **bad}
        with pytest.raises(ValueError, match="unsupported"):
            sb.check_geometry(**args)
    with pytest.raises(ValueError, match="shared memory"):
        sb.check_geometry(1, 8, 1472, 23, 8)
