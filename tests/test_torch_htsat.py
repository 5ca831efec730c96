"""The port's HTSAT encoder (mellow_tpu_torch.models.htsat) against the JAX
package's at the tiny configuration, same weights and seeded inputs, within
atol 1e-4 / rtol 1e-4 (fp32 with sums in another order)."""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mellow_tpu.models import htsat as jhtsat
from mellow_tpu_torch.models import htsat as thtsat
from mellow_tpu_torch.models.params import params_from_jax
from tests.torch_port_common import ENC, TINY, jax_params_np, waves

RES = 16  # a small grid: 4 windows of 8x8, so the shifted mask is exercised


@pytest.fixture(scope="module")
def params():
    jp = jax_params_np()
    return jax.tree.map(jnp.asarray, jp), params_from_jax(jp, "cpu")


def _tokens(seed, c):
    rng = np.random.RandomState(seed)
    return rng.randn(2, RES * RES, c).astype(np.float32)


@pytest.mark.parametrize("shift", [0, 4])
def test_swin_block_matches_jax(params, shift):
    jp, tp = params
    x = _tokens(shift, ENC.embed_dim)
    bj = jp["encoder"]["stages"][0]["blocks"][1]
    bt = tp["encoder"]["stages"][0]["blocks"][1]
    heads = ENC.num_heads[0]
    theirs = np.asarray(jhtsat.swin_block(jnp.asarray(x), bj, RES, heads, ENC.window_size, shift))
    ours = thtsat.swin_block(torch.from_numpy(x), bt, RES, heads, ENC.window_size, shift).numpy()
    np.testing.assert_allclose(ours, theirs, atol=1e-4, rtol=1e-4)


def test_patch_merging_matches_jax(params):
    jp, tp = params
    x = _tokens(7, ENC.embed_dim)
    theirs = np.asarray(jhtsat.patch_merging(
        jnp.asarray(x), jp["encoder"]["stages"][0]["downsample"], RES))
    ours = thtsat.patch_merging(
        torch.from_numpy(x), tp["encoder"]["stages"][0]["downsample"], RES).numpy()
    assert ours.shape == (2, (RES // 2) ** 2, 2 * ENC.embed_dim)
    np.testing.assert_allclose(ours, theirs, atol=1e-4, rtol=1e-4)


def test_encode_audio_compact_matches_jax(params):
    jp, tp = params
    wave = waves(2, 11)
    enc = jax.jit(functools.partial(
        jhtsat.encode_audio_compact, fe_cfg=TINY.frontend, cfg=ENC))
    theirs = np.asarray(enc(jnp.asarray(wave), jp))
    ours = thtsat.encode_audio_compact(torch.from_numpy(wave), tp, TINY.frontend, ENC).numpy()
    assert ours.shape == theirs.shape == (2, 33, TINY.d_proj)
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, theirs, atol=1e-4, rtol=1e-4)
