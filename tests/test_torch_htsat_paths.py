"""The encoder's other entry points (mellow_tpu_torch.models.htsat) against
the JAX package's at the tiny configuration of tests/torch_port_common.py
(``embed_dim=24``), same weights and seeded waves: ``htsat_embedding`` with
``tscam_head``, ``encode_audio``, ``htsat_embedding_long`` (15 s),
``htsat_embedding_infer_mode`` (3 s), ``swin_features_with_attn`` and
``downsample_tokens``, in fp32 within atol 1e-4 / rtol 1e-4 (sums in another
order; the attention maps within atol 1e-5, probabilities below 1). Then the
tiny bf16 encoder with every block on the window-attention route (#9's plain
version; the whole-block gate closed in the test) against the JAX package's
bf16 ``encode_audio_compact``, within 3e-2 x max|ref|; the registries; and
the init trees at an HTSAT-large-shaped encoder of reduced width and depth
(hd = 64)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mellow_tpu.config import get_config
from mellow_tpu.models import htsat as jhtsat
from mellow_tpu.models import mellow as jmellow
from mellow_tpu.models import registry as jregistry
from mellow_tpu_torch import config as tconfig
from mellow_tpu_torch.models import htsat as thtsat
from mellow_tpu_torch.models import mellow as tmellow
from mellow_tpu_torch.models import registry as tregistry
from mellow_tpu_torch.models.params import params_from_jax
from mellow_tpu_torch.ops import swin_block as sb
from mellow_tpu_torch.ops import window_attention as wa
from tests.torch_port_common import ENC, TINY, TINY_LARGE, jax_params_np

FE = TINY.frontend
TOL = dict(atol=1e-4, rtol=1e-4)
SR = FE.sample_rate


@pytest.fixture(scope="module")
def params():
    jp = jax_params_np()
    return jax.tree.map(jnp.asarray, jp), params_from_jax(jp, "cpu")


def _wave(b, seconds, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, int(seconds * SR)) * 0.1).astype(np.float32)


def _jit(fn, **kw):
    return jax.jit(functools.partial(fn, fe_cfg=FE, cfg=ENC, **kw))


def _close_dict(ours: dict, theirs: dict, keys, **tol):
    for k in keys:
        got, want = ours[k].numpy(), np.asarray(theirs[k])
        assert got.shape == want.shape, k
        assert np.isfinite(got).all(), k
        np.testing.assert_allclose(got, want, err_msg=k, **tol)


OUTPUTS = ("framewise_output", "clipwise_output", "latent_output", "embedding")


def test_htsat_embedding_and_tscam_head_match_jax(params):
    jp, tp = params
    wave = _wave(2, 10, 1)
    theirs = _jit(jhtsat.htsat_embedding)(jnp.asarray(wave), jp)
    ours = thtsat.htsat_embedding(torch.from_numpy(wave), tp, FE, ENC)
    assert ours["embedding"].shape == (2, 1025, ENC.num_features)
    assert ours["framewise_output"].shape == (2, 1024, ENC.num_classes)
    _close_dict(ours, theirs, OUTPUTS, **TOL)
    # The head alone on the same seeded tokens.
    tokens = np.random.RandomState(2).randn(2, 64, ENC.num_features).astype(np.float32)
    head_t = thtsat.tscam_head(torch.from_numpy(tokens), tp["encoder"], ENC)
    head_j = jax.jit(functools.partial(jhtsat.tscam_head, cfg=ENC))(jnp.asarray(tokens), jp["encoder"])
    _close_dict(head_t, head_j, OUTPUTS[:3], **TOL)


def test_encode_audio_matches_jax(params):
    jp, tp = params
    wave = _wave(2, 10, 3)
    theirs = np.asarray(_jit(jhtsat.encode_audio)(jnp.asarray(wave), jp))
    ours = thtsat.encode_audio(torch.from_numpy(wave), tp, FE, ENC).numpy()
    assert ours.shape == theirs.shape == (2, 1025, TINY.d_proj)
    np.testing.assert_allclose(ours, theirs, **TOL)
    # The train-time arguments, which the port refused before training was
    # ported: mixup weights (1, 0) give the first row's encoding, on the
    # full 1025-row path; a generator draws dropout, so frame rows stop
    # repeating.
    mixed = thtsat.encode_audio(torch.from_numpy(wave), tp, FE, ENC, mixup_lambda=torch.tensor([1.0, 0.0]),
                                training=True)
    np.testing.assert_allclose(mixed.numpy(), ours[:1], **TOL)
    g = torch.Generator()
    g.manual_seed(0)
    drawn = thtsat.encode_audio(torch.from_numpy(wave), tp, FE, ENC, rng=g, training=True)
    assert drawn.shape == ours.shape and not torch.equal(drawn[:, 1], drawn[:, 2])


def test_htsat_embedding_long_matches_jax(params):
    """15 s: 1501 frames, crops at 0, 344 and 688."""
    jp, tp = params
    wave = _wave(2, 15, 4)
    theirs = _jit(jhtsat.htsat_embedding_long)(jnp.asarray(wave), jp)
    ours = thtsat.htsat_embedding_long(torch.from_numpy(wave), tp, FE, ENC)
    assert ours["embedding"].shape == (2, 1025, ENC.num_features)
    _close_dict(ours, theirs, OUTPUTS, **TOL)
    with pytest.raises(ValueError):
        thtsat.htsat_embedding_long(torch.from_numpy(_wave(1, 10, 5)), tp, FE, ENC)


def test_htsat_embedding_infer_mode_matches_jax(params):
    """3 s: 301 frames, repeated 3 times, then resized to 1024."""
    jp, tp = params
    wave = _wave(2, 3, 6)
    theirs = _jit(jhtsat.htsat_embedding_infer_mode)(jnp.asarray(wave), jp)
    ours = thtsat.htsat_embedding_infer_mode(torch.from_numpy(wave), tp, FE, ENC)
    _close_dict(ours, theirs, OUTPUTS, **TOL)


def test_swin_features_with_attn_matches_jax(params):
    jp, tp = params
    img = np.random.RandomState(7).randn(2, ENC.spec_size, ENC.spec_size).astype(np.float32)
    fn = jax.jit(functools.partial(jhtsat.swin_features_with_attn, cfg=ENC))
    tokens_j, attns_j = fn(jnp.asarray(img), jp["encoder"])
    tokens_t, attns_t = thtsat.swin_features_with_attn(torch.from_numpy(img), tp["encoder"], ENC)
    np.testing.assert_allclose(tokens_t.numpy(), np.asarray(tokens_j), **TOL)
    # The plain formulation runs also where the trunk would take a kernel.
    np.testing.assert_allclose(
        tokens_t.numpy(), thtsat.swin_features(torch.from_numpy(img), tp["encoder"], ENC).numpy(), **TOL)
    assert len(attns_t) == len(attns_j) == len(ENC.depths)
    for got, want in zip(attns_t, attns_j):
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_downsample_tokens_matches_jax():
    x = np.random.RandomState(8).randn(2, 1025, 16).astype(np.float32)
    ours = thtsat.downsample_tokens(torch.from_numpy(x)).numpy()
    theirs = np.asarray(jax.jit(jhtsat.downsample_tokens)(jnp.asarray(x)))
    assert ours.shape == (2, 129, 16)
    np.testing.assert_allclose(ours, theirs, atol=1e-6, rtol=1e-6)
    # The compact form gives the same tokens on repeated rows.
    c = torch.from_numpy(x[:, :33])
    full = torch.cat([c[:, :1], c[:, 1:].repeat_interleave(32, dim=1)], dim=1)
    torch.testing.assert_close(thtsat.downsample_tokens(full), thtsat.downsample_tokens_compact(c))


def test_bf16_window_route_matches_jax(params, monkeypatch):
    """Every tiny block on the #9 route (hd = 6; the whole-block gate closed
    here only), against the JAX package's bf16 einsum formulation."""
    jp, _ = params
    tp16 = params_from_jax(jax_params_np(), "cpu", torch.bfloat16)
    monkeypatch.setattr(sb, "FUSED_BLOCK_BUDGET", 0)
    calls = []
    real = wa.window_attention
    monkeypatch.setattr(wa, "window_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    wave = _wave(1, 10, 9)
    ours = thtsat.encode_audio_compact(torch.from_numpy(wave).bfloat16(), tp16, FE, ENC).float().numpy()
    assert len(calls) == sum(ENC.depths)
    jp16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    theirs = np.asarray(_jit(jhtsat.encode_audio_compact)(jnp.asarray(wave, jnp.bfloat16), jp16)
                        .astype(jnp.float32))
    assert ours.shape == theirs.shape == (1, 33, TINY.d_proj) and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, theirs, atol=3e-2 * np.abs(theirs).max(), rtol=0)


def test_registries_name_the_same_functions():
    ours, theirs = tregistry.get_audio_encoder(), jregistry.get_audio_encoder()
    assert sorted(vars(ours)) == sorted(vars(theirs))
    assert all(getattr(thtsat, n) is f for n, f in vars(ours).items() if n != "projection")
    model = tregistry.get_model("Mellow")
    assert sorted(vars(model)) == sorted(vars(jregistry.get_model()))  # forward_train since training
    with pytest.raises(ValueError):
        tregistry.get_audio_encoder("PANN")
    with pytest.raises(ValueError):
        tregistry.get_model("clap")


def _shapes(tree):
    return jax.tree.map(lambda a: tuple(np.shape(a)), tree)


def test_init_trees_match_at_htsat_large_shape():
    """The port's init and the JAX package's at HTSAT-large's shape (hd = 64
    at every stage), reduced in width and depth: the same tree, and the
    same port tree through ``params_from_jax``."""
    jcfg, tcfg = get_config(TINY_LARGE.name), tconfig.get_config(TINY_LARGE.name)
    enc = tcfg.encoder
    assert [enc.embed_dim * 2 ** i // h for i, h in enumerate(enc.num_heads)] == [64] * 4
    ours = tmellow.init_params(tcfg, 0)
    theirs = jax.tree.map(np.asarray, jmellow.init_params(jax.random.PRNGKey(0), jcfg))
    assert _shapes(ours) == _shapes(theirs)
    assert _shapes(params_from_jax(ours, "cpu")) == _shapes(params_from_jax(theirs, "cpu"))
