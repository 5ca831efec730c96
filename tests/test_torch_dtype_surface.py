"""The rest of the dtype surface (the JAX wrapper's ``kv_cache_dtype or
str(dtype)``): an int8 cache under fp32, int8 weights under fp32, and a
float cache in another dtype than the compute dtype (llama and GPT-2), each served by the
port's wrapper and held against the JAX package at the decoder level on
the CPU, at the tiny configuration (``tests/torch_port_common.py``)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mellow_tpu.io.tokenizer import ByteTokenizer
from mellow_tpu.models import generate as jgen
from mellow_tpu.models import gpt2 as jgpt2
from mellow_tpu.models import llama as jllama
from mellow_tpu_torch.models import generate as tgen
from mellow_tpu_torch.models import gpt2 as tgpt2
from mellow_tpu_torch.models import llama as tllama
from mellow_tpu_torch.wrapper import MellowWrapper as TorchWrapper
from tests.torch_port_common import TINY, TINY_GPT2, gpt2_params_np, port_params_np

MAX_LEN = 12

# Wrapper options, the request's kv_cache_dtype. ``int8-cache-fp32`` and
# ``bf16-cache-fp32`` were the cases of ``tests/test_torch_e2e.py``'s former
# ``test_wrapper_refuses_what_is_not_ported``; ``int8-cache-fp32``,
# ``int8-weights-fp32`` and ``fp16-cache-bf16`` were refusals in
# ``tests/test_torch_int8.py``, and ``fp32-cache-bf16`` in
# ``tests/test_torch_bf16.py``.
# The last column: the prefill logits' limit, x max|logits|. fp32: the same
# math with fp32 sums in another order. bf16: ROADMAP Queue 3's port-vs-JAX
# readings (prefill logits 4.1e-2 in bf16, 10.3e-2 with int8 weights), with
# headroom.
DTYPE_SURFACE = [
    ("int8-cache-fp32", {}, "int8", 1e-4),
    ("bf16-cache-fp32", {}, "bfloat16", 1e-4),
    ("int8-weights-fp32", {"weight_dtype": "int8"}, None, 1e-4),
    ("fp32-cache-bf16", {"compute_dtype": "bfloat16"}, "float32", 6e-2),
    ("fp16-cache-bf16", {"compute_dtype": "bfloat16", "weight_dtype": "int8"}, "float16", 1.5e-1),
]


@pytest.mark.parametrize("ctor, kv_cache_dtype, tol", [c[1:] for c in DTYPE_SURFACE],
                         ids=[c[0] for c in DTYPE_SURFACE])
def test_dtype_surface_matches_jax(ctor, kv_cache_dtype, tol):
    """The wrapper serves each combination (no refusal; its weights and
    ``cache_dtype`` rule), and the decoder's ``generate`` on a seeded
    prefix with those weights and that cache agrees with the JAX package's
    (its einsum path, where JAX sends all of these): the prefill logits
    within ``tol`` x max|logits|; in fp32 the greedy tokens identical at a
    flush window of 4, in bf16 (the port's kernels' plain versions against
    JAX's XLA formulation, ROADMAP Queue 3) the first token."""
    tw = TorchWrapper(TINY.name, "v0", "cpu", params=port_params_np(TINY), tokenizer=ByteTokenizer(),
                      use_native_audio=False, **ctor)
    cache = tw.cache_dtype(kv_cache_dtype)
    assert cache == kv_cache_dtype
    fp32 = tw.dtype == torch.float32
    jdt = jnp.float32 if fp32 else jnp.bfloat16
    jcache_dtype = kv_cache_dtype or tw.cfg.compute_dtype
    jd = jax.tree.map(jnp.asarray, port_params_np(TINY)["decoder"])
    if "weight_dtype" in ctor:
        jd = jllama.quantize_decoder(jd, TINY.decoder)
    jd = jax.tree.map(lambda a: a.astype(jdt) if jnp.issubdtype(a.dtype, jnp.floating) else a, jd)
    prefix = (np.random.RandomState(5).randn(2, 16, TINY.decoder.hidden_size) * 0.5).astype(np.float32)
    x = torch.from_numpy(prefix).to(tw.dtype)
    dec = tw.params["decoder"]

    cache_dt = tgen.cache_dtype(cache, tw.dtype)
    ours = tllama.logits_from_hidden(dec, TINY.decoder, tllama.prefill(
        dec, TINY.decoder, x, tllama.KVCache.create(TINY.decoder, 2, 16, "cpu", cache_dt))).float()
    jcache = jllama.KVCache.create(TINY.decoder, 2, 16, jnp.dtype(jcache_dtype))
    jx = jnp.asarray(prefix, jdt)
    theirs = torch.from_numpy(np.array(
        jllama.logits_from_hidden(jd, TINY.decoder, jllama.prefill(jd, TINY.decoder, jx, jcache)[0]), np.float32))
    err = (ours - theirs).abs().max().item() / theirs.abs().max().item()
    print(f"prefill logits: {err:.2e} x max|logits| (limit {tol})")
    assert err <= tol, err

    kw = dict(max_len=MAX_LEN, stop_token_id=-1, flush_window=4)
    got = tgen.generate(dec, TINY.decoder, x, kv_cache_dtype=cache, **kw).tokens.numpy()
    want = np.asarray(jgen.generate(jd, TINY.decoder, jx, cache_dtype=jcache_dtype,
                                    fused_decode=False, **kw).tokens)
    if fp32:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(got[:, 0], want[:, 0])


# GPT-2 with a float cache in another dtype than the compute dtype, which
# the port refused before: the last column as DTYPE_SURFACE's.
GPT2_SURFACE = [
    ("gpt2-bf16-cache-fp32", {}, "bfloat16", 1e-4),
    ("gpt2-fp32-cache-bf16", {"compute_dtype": "bfloat16"}, "float32", 6e-2),
]


@pytest.mark.parametrize("ctor, kv_cache_dtype, tol", [c[1:] for c in GPT2_SURFACE],
                         ids=[c[0] for c in GPT2_SURFACE])
def test_gpt2_float_cache_matches_jax(ctor, kv_cache_dtype, tol):
    """The GPT-2 wrapper serves the cache (``cache_dtype``), and the
    decoder's ``generate`` on a seeded prefix with that cache agrees with
    the JAX package's einsum path: the prefill logits within ``tol`` x
    max|logits|; in fp32 the greedy tokens identical at a flush window of 4
    (three windows, so flushed rows are read back), in bf16 the first
    token."""
    tw = TorchWrapper(TINY_GPT2.name, "v0", "cpu", params=gpt2_params_np(), tokenizer=ByteTokenizer(),
                      use_native_audio=False, **ctor)
    assert tw.cache_dtype(kv_cache_dtype) == kv_cache_dtype
    fp32 = tw.dtype == torch.float32
    jdt = jnp.float32 if fp32 else jnp.bfloat16
    cfg = TINY_GPT2.decoder
    jd = jax.tree.map(lambda a: jnp.asarray(a, jdt), gpt2_params_np()["decoder"])
    prefix = (np.random.RandomState(6).randn(2, 16, cfg.hidden_size) * 0.5).astype(np.float32)
    x = torch.from_numpy(prefix).to(tw.dtype)
    dec, tcfg = tw.params["decoder"], tw.cfg.decoder

    cache = tgpt2.GPT2Cache.create(tcfg, 2, 16, "cpu", tgen.cache_dtype(kv_cache_dtype, tw.dtype))
    ours = tgpt2.logits_from_hidden(dec, tcfg, tgpt2.prefill(dec, tcfg, x, cache)).float()
    jx = jnp.asarray(prefix, jdt)
    jcache = jgpt2.GPT2Cache.create(cfg, 2, 16, jnp.dtype(kv_cache_dtype))
    theirs = torch.from_numpy(np.array(
        jgpt2.logits_from_hidden(jd, cfg, jgpt2.prefill(jd, cfg, jx, jcache)[0]), np.float32))
    err = (ours - theirs).abs().max().item() / theirs.abs().max().item()
    print(f"prefill logits: {err:.2e} x max|logits| (limit {tol})")
    assert err <= tol, err

    kw = dict(max_len=MAX_LEN, stop_token_id=-1, flush_window=4)
    got = tgen.generate(dec, tcfg, x, kv_cache_dtype=kv_cache_dtype, family="gpt2", **kw).tokens.numpy()
    want = np.asarray(jgen.generate(jd, cfg, jx, cache_dtype=kv_cache_dtype, fused_decode=False,
                                    family="gpt2", **kw).tokens)
    if fp32:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
