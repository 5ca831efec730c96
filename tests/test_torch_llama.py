"""The port's Llama decoder (mellow_tpu_torch.models.llama) against the JAX
package's at the tiny configuration: logits after prefill and after each of
4 decode steps, same weights and seeded inputs, within atol 1e-4 (fp32 with
sums in another order)."""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mellow_tpu.models import llama as jllama
from mellow_tpu_torch.models import llama as tllama
from mellow_tpu_torch.models.params import params_from_jax
from tests.torch_port_common import DEC, jax_params_np

B, P, STEPS = 2, 12, 4


@functools.partial(jax.jit, static_argnums=(1,))
def _jax_logits(params, cfg, prefix, step_tokens):
    cache = jllama.KVCache.create(cfg, B, P + STEPS, jnp.float32)
    hidden, cache = jllama.prefill(params, cfg, prefix, cache)
    cos, sin = (jnp.asarray(t) for t in jllama.rope_tables(cfg, P + STEPS))
    logits = [jllama.logits_from_hidden(params, cfg, hidden)]
    for i in range(STEPS):
        emb = params["embed"][step_tokens[:, i]]
        hidden, cache, pending = jllama.decode_step(params, cfg, emb, cache, cos, sin)
        cache = jllama.flush_pending(cfg, cache, pending)
        logits.append(jllama.logits_from_hidden(params, cfg, hidden))
    return jnp.stack(logits, axis=1)  # (B, 1 + STEPS, V)


def _torch_logits(params, cfg, prefix, step_tokens):
    cache = tllama.KVCache.create(cfg, B, P + STEPS, "cpu")
    with torch.no_grad():
        hidden = tllama.prefill(params, cfg, prefix, cache)
        cos, sin = (torch.from_numpy(t) for t in tllama.rope_tables(cfg, P + STEPS))
        logits = [tllama.logits_from_hidden(params, cfg, hidden)]
        for i in range(STEPS):
            emb = params["embed"][step_tokens[:, i].long()]
            hidden = tllama.decode_step(params, cfg, emb, cache, P + i, cos, sin)
            logits.append(tllama.logits_from_hidden(params, cfg, hidden))
    return torch.stack(logits, dim=1)


@pytest.fixture(scope="module")
def logits_pair():
    dec = jax_params_np()["decoder"]
    rng = np.random.RandomState(5)
    prefix = (rng.randn(B, P, DEC.hidden_size) * 0.5).astype(np.float32)
    step_tokens = rng.randint(0, DEC.vocab_size, size=(B, STEPS)).astype(np.int32)
    theirs = np.asarray(_jax_logits(
        jax.tree.map(jnp.asarray, dec), DEC, jnp.asarray(prefix), jnp.asarray(step_tokens)))
    ours = _torch_logits(
        params_from_jax({"decoder": dec}, "cpu")["decoder"], DEC,
        torch.from_numpy(prefix), torch.from_numpy(step_tokens),
    ).numpy()
    return ours, theirs


def test_prefill_logits_match_jax(logits_pair):
    ours, theirs = logits_pair
    assert ours.shape == theirs.shape == (B, 1 + STEPS, DEC.vocab_size)
    np.testing.assert_allclose(ours[:, 0], theirs[:, 0], atol=1e-4, rtol=0)


@pytest.mark.parametrize("step", range(1, STEPS + 1))
def test_decode_step_logits_match_jax(logits_pair, step):
    ours, theirs = logits_pair
    np.testing.assert_allclose(ours[:, step], theirs[:, step], atol=1e-4, rtol=0)


def test_kv_cache_layout_and_in_place_writes():
    cache = tllama.KVCache.create(DEC, B, P + STEPS, "cpu")
    assert cache.k.shape == (DEC.num_layers, B, P + STEPS, DEC.num_kv_heads, DEC.head_dim)
    assert cache.k.dtype == torch.float32
    params = params_from_jax({"decoder": jax_params_np()["decoder"]}, "cpu")["decoder"]
    prefix = torch.from_numpy(np.random.RandomState(6).randn(B, P, DEC.hidden_size).astype(np.float32))
    with torch.no_grad():
        tllama.prefill(params, DEC, prefix, cache)
    assert cache.k[:, :, :P].abs().sum() > 0 and cache.v[:, :, :P].abs().sum() > 0
    assert cache.k[:, :, P:].abs().sum() == 0
