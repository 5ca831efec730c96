"""The window-attention kernel's plain version
(mellow_tpu_torch.ops.window_attention) against the TPU kernel it ports,
``pallas_window_attention.window_attention_fused``, run in interpret mode on
the CPU as ``tests/test_pallas_window_attention.py`` runs it; the port's
route table (#8, #9 or plain) for every HTSAT stage against the JAX gates;
one HTSAT-large stage-2 block in bf16 through the port's #9 route against
the JAX package's block on the CPU (its einsum formulation); and the Swin
block's plain version at hd = 64 against ``swin_block_fused``.

Tolerances: fp32 within atol 1e-5 for #9 (the same rounding points; sums
in another order) and 1e-4 for the whole block (#8, as
``tests/test_torch_swin_block.py``); bf16 within
3e-2 x max|ref| (a probability or output may round to the neighbouring bf16
value; the JAX einsum block rounds q * scale and more intermediates to
bf16, which the kernels do not)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mellow_tpu.models import htsat as jhtsat
from mellow_tpu.ops.pallas_swin_block import fused_block_vmem_bytes, swin_block_fused
from mellow_tpu.ops.pallas_window_attention import window_attention_fused
from mellow_tpu_torch.models import htsat as thtsat
from mellow_tpu_torch.ops import swin_block as sb
from mellow_tpu_torch.ops import window_attention as wa

DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]


def _tol(dtype, ref):
    return 1e-5 if dtype == torch.float32 else 3e-2 * np.abs(ref).max()


def _inputs(seed, Bn, ws, H, C, grid, dtype):
    """qkv rounded to ``dtype``, the (H, N, N) bias from a random table and
    the shifted-window mask of a ``grid`` x ``grid`` image (None: W-MSA)."""
    N = ws * ws
    rng = np.random.RandomState(seed)
    qkv = torch.from_numpy((rng.randn(Bn, N, 3 * C) * 0.3).astype(np.float32)).to(dtype)
    table = rng.randn((2 * ws - 1) ** 2, H).astype(np.float32) * 0.5
    bias = table[jhtsat.relative_position_index(ws).reshape(-1)].reshape(N, N, H).transpose(2, 0, 1)
    mask = None if grid is None else jhtsat.shifted_window_mask(grid, ws, ws // 2)
    return qkv, np.ascontiguousarray(bias), mask


@functools.lru_cache(maxsize=None)
def _pallas(Bn, ws, H, C, grid, jdtype_name):
    """The Pallas kernel's output on ``_inputs``."""
    dtype = torch.float32 if jdtype_name == "float32" else torch.bfloat16
    qkv, bias, mask = _inputs(Bn + C, Bn, ws, H, C, grid, dtype)
    N = ws * ws
    out = window_attention_fused(
        jnp.asarray(qkv.float().numpy(), jdtype_name), jnp.asarray(bias.reshape(H * N, N)), mask,
        num_heads=H, window_size=ws, interpret=True,
    )
    return np.asarray(out.astype(jnp.float32))


# The shapes of tests/test_pallas_window_attention.py (their shifted mask
# over a 2 x 2 window grid), then HTSAT-large's stage 2 (C=512, H=8, hd=64)
# with the 16 windows of one clip's 32 x 32 grid, shifted.
@pytest.mark.parametrize("Bn, ws, H, C, grid", [
    (8, 4, 4, 32, None), (8, 4, 4, 32, 8), (16, 8, 4, 96, None), (16, 8, 4, 96, 16),
    (16, 8, 8, 512, 32),
], ids=["small-W", "small-SW", "stage1-W", "stage1-SW", "large-stage2-SW"])
@pytest.mark.parametrize("dtype, jdtype", DTYPES, ids=["fp32", "bf16"])
def test_plain_matches_tpu_kernel(Bn, ws, H, C, grid, dtype, jdtype):
    qkv, bias, mask = _inputs(Bn + C, Bn, ws, H, C, grid, dtype)
    ours = wa.window_attention_plain(
        qkv, torch.from_numpy(bias), None if mask is None else torch.from_numpy(mask), num_heads=H)
    assert ours.dtype == dtype
    ours = ours.float().numpy()
    theirs = _pallas(Bn, ws, H, C, grid, jnp.dtype(jdtype).name)
    assert ours.shape == theirs.shape == (Bn, ws * ws, C)
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, theirs, atol=_tol(dtype, theirs), rtol=0)


def test_plain_selects_the_mask_per_window():
    """Window w takes mask[w % nW] also when Bn is not a multiple of nW, as
    the TPU kernel's ``rem(w, n_mask)`` does."""
    qkv, bias, mask = _inputs(5, 6, 4, 2, 16, 8, torch.float32)  # 6 windows, 4 masks
    ours = wa.window_attention_plain(qkv, torch.from_numpy(bias), torch.from_numpy(mask), num_heads=2)
    theirs = window_attention_fused(
        jnp.asarray(qkv.numpy()), jnp.asarray(bias.reshape(2 * 16, 16)), mask,
        num_heads=2, window_size=4, interpret=True, chunk=1,
    )
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-5, rtol=0)


# The published HTSAT sizes (LAION-CLAP create_htsat_model): window 8,
# heads (4, 8, 16, 32); and the route each stage must take in bf16.
SIZES = {
    "tiny": (96, ["swin_block", "swin_block", "swin_block", "plain"]),
    "base": (128, ["swin_block", "swin_block", "swin_block", "plain"]),
    "large": (256, ["swin_block", "window_attention", "plain", "plain"]),
}


@pytest.mark.parametrize("size", list(SIZES))
def test_route_table_matches_jax_gates(size):
    embed, want = SIZES[size]
    routes, jax_routes = [], []
    C, R = embed, 64
    for H in (4, 8, 16, 32):
        routes.append(thtsat.kernel_route(C, H, 8, R))
        # The JAX package's two gates (models/htsat.py): the whole block
        # within 10 MB, else one window within 6 MB.
        if fused_block_vmem_bytes(C, H, 8, R) <= (10 << 20):
            jax_routes.append("swin_block")
        elif H * 64 * (C * 6 + 64 * 6) <= (6 << 20):
            jax_routes.append("window_attention")
        else:
            jax_routes.append("plain")
        assert sb.fused_block_vmem_bytes(C, H, 8, R) == fused_block_vmem_bytes(C, H, 8, R)
        assert wa.window_vmem_bytes(C, H, 64) == H * 64 * (C * 6 + 64 * 6)
        C, R = 2 * C, R // 2
    assert routes == jax_routes == want


def _block_params(rng, C, H, ws=8):
    def lin(i, o):
        return {"kernel": (rng.randn(i, o) * 0.05).astype(np.float32),
                "bias": (rng.randn(o) * 0.02).astype(np.float32)}

    def ln():
        return {"scale": (rng.randn(C) * 0.1 + 1.0).astype(np.float32),
                "bias": (rng.randn(C) * 0.02).astype(np.float32)}

    return {"norm1": ln(), "qkv": lin(C, 3 * C), "proj": lin(C, C), "norm2": ln(),
            "fc1": lin(C, 4 * C), "fc2": lin(4 * C, C),
            "rel_bias_table": (rng.randn((2 * ws - 1) ** 2, H) * 0.5).astype(np.float32)}


def _tree(p, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in p.items()}


def test_large_stage2_block_takes_the_window_route_in_bf16(monkeypatch):
    """HTSAT-large stage 2 (R=32, C=512, H=8), SW-MSA, bf16: the port's
    block runs the #9 route (its plain version on the CPU) and agrees with
    the JAX package's block on the CPU."""
    R, C, H, shift = 32, 512, 8, 4
    rng = np.random.RandomState(2)
    p = _block_params(rng, C, H)
    x = (rng.randn(1, R * R, C) * 0.5).astype(np.float32)
    tp = _tree(p, lambda a: torch.from_numpy(a).bfloat16())
    calls = []
    real = wa.window_attention
    monkeypatch.setattr(wa, "window_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    ours = thtsat.swin_block(torch.from_numpy(x).bfloat16(), tp, R, H, 8, shift).float().numpy()
    assert len(calls) == 1
    jp = _tree(p, lambda a: jnp.asarray(a, jnp.bfloat16))
    theirs = np.asarray(jax.jit(jhtsat.swin_block, static_argnums=(2, 3, 4, 5))(
        jnp.asarray(x, jnp.bfloat16), jp, R, H, 8, shift).astype(jnp.float32))
    assert ours.shape == theirs.shape and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, theirs, atol=3e-2 * np.abs(theirs).max(), rtol=0)


_ORDER = [("norm1", "scale"), ("norm1", "bias"), ("qkv", "kernel"), ("qkv", "bias"),
          ("proj", "kernel"), ("proj", "bias"), ("norm2", "scale"), ("norm2", "bias"),
          ("fc1", "kernel"), ("fc1", "bias"), ("fc2", "kernel"), ("fc2", "bias")]


@pytest.mark.parametrize("dtype, jdtype", DTYPES, ids=["fp32", "bf16"])
def test_swin_block_plain_at_hd64_matches_tpu_kernel(dtype, jdtype):
    """#8 at hd = 64 (HTSAT-large's stage 1 head width), SW-MSA."""
    B, R, C, H, ws, shift = 1, 16, 128, 2, 8, 4
    N = ws * ws
    rng = np.random.RandomState(9)
    tp = _tree(_block_params(rng, C, H), lambda a: torch.from_numpy(a).to(dtype))
    x = torch.from_numpy((rng.randn(B, R, R, C) * 0.5).astype(np.float32)).to(dtype)
    idx = jhtsat.relative_position_index(ws).reshape(-1)
    bias = tp["rel_bias_table"].float()[torch.from_numpy(idx)].reshape(N, N, H).permute(2, 0, 1)
    mask = jhtsat.shifted_window_mask(R, ws, shift)
    ours = sb.swin_block_plain(x, tp, bias.contiguous(), torch.from_numpy(mask), num_heads=H,
                               window_size=ws).float().numpy()
    theirs = swin_block_fused(
        jnp.asarray(x.float().numpy(), jdtype), *(jnp.asarray(tp[a][b].float().numpy(), jdtype) for a, b in _ORDER),
        jnp.asarray(bias.reshape(H * N, N).numpy()), mask, num_heads=H, window_size=ws, interpret=True,
    )
    theirs = np.asarray(theirs.astype(jnp.float32))
    assert ours.shape == theirs.shape == (B, R, R, C) and np.isfinite(ours).all()
    atol = 1e-4 if dtype == torch.float32 else 3e-2 * np.abs(theirs).max()
    np.testing.assert_allclose(ours, theirs, atol=atol, rtol=0)
