"""The GPT-2 slice end to end against the JAX package, at the tiny GPT-2
configuration on the CPU (``tests/torch_port_common.py``), with the same
weights and clips on both sides:

* fp32 parity mode: both wrappers give identical strings (the prompt gets
  " <|endoftext|>" appended on both sides), and the port's
  ``BatchingEngine`` over the GPT-2 wrapper answers as the wrapper does;
* bf16 perf mode and bf16 with int8 weights (``quantize_gpt2``), at the
  ``generate_tokens`` level: the prefix within 3e-2 x max|ref|, the prefill
  logits within 5e-2 x max|ref|, and the first greedy token of each row
  identical (one JAX call per weight mode: its prefill logits).

On the CPU the port's bf16 prefill runs the plain version of TPU kernel
#10 (the kernel's rounding points) where the JAX package runs its einsum
formulation (its Pallas gate needs a TPU), and the encoder differs as
``tests/test_torch_bf16.py`` describes: a difference by design."""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mellow_tpu.models import gpt2 as jgpt2
from mellow_tpu.models import htsat as jhtsat
from mellow_tpu.models import mellow as jmellow
from mellow_tpu.wrapper import MellowWrapper as JaxWrapper
from mellow_tpu_torch.config import get_config
from mellow_tpu_torch.models import gpt2 as tgpt2
from mellow_tpu_torch.models import mellow as tmellow
from mellow_tpu_torch.models.params import cast_floating, params_from_jax
from mellow_tpu_torch.ops import flash_gqa_prefill as fp
from mellow_tpu_torch.serving import BatchingEngine
from mellow_tpu_torch.wrapper import MellowWrapper as TorchWrapper
from tests.test_torch_e2e import _DistinctTokenizer, _write_wav
from tests.torch_port_common import TINY_GPT2, gpt2_params_np, waves

MAX_LEN = 8
TCFG = get_config(TINY_GPT2.name)  # the port's own config tree


@pytest.fixture(scope="module")
def examples(tmp_path_factory):
    d = tmp_path_factory.mktemp("gpt2_wavs")
    short = _write_wav(d / "short.wav", 7.0, 5)  # repeat-padded to 10 s
    long = _write_wav(d / "long.wav", 11.0, 6)  # cropped at crop_start
    return [[short, long, "caption the audio."], [long, short, "what changed?"]]


def test_wrapper_strings_identical_to_jax_wrapper_fp32(examples):
    tok = _DistinctTokenizer()
    tw = TorchWrapper(TINY_GPT2.name, "v0", "cpu", params=gpt2_params_np(), tokenizer=tok,
                      use_native_audio=False)
    never = chr(tok.BASE + TINY_GPT2.decoder.vocab_size)  # an id no row can emit
    free = tw.generate(examples, max_len=MAX_LEN, crop_start=0, stop_token=never)
    assert all(len(s) == MAX_LEN for s in free)
    assert len(set(free[0])) > 3 and free[0] != free[1]
    stop = free[0][4]  # the token row 0 emits at step 4: the stop acts
    ours = tw.generate(examples, max_len=MAX_LEN, crop_start=0, stop_token=stop)
    jw = JaxWrapper(TINY_GPT2.name, "v0", 0, params=jax.tree.map(jnp.asarray, gpt2_params_np()),
                    tokenizer=tok, use_native_audio=False)
    prompts = [e[2] for e in examples]
    np.testing.assert_array_equal(tw.preprocess_text(prompts), jw.preprocess_text(prompts))
    theirs = jw.generate(examples, max_len=MAX_LEN, crop_start=0, stop_token=stop)
    assert ours == theirs
    assert ours[0] == free[0][: free[0].index(stop)]


def test_batching_engine_over_the_gpt2_wrapper(tmp_path):
    # Clips under 10 s: repeat-padded, so no random crop (submit takes no
    # crop_start).
    a = _write_wav(tmp_path / "a.wav", 7.0, 7)
    b = _write_wav(tmp_path / "b.wav", 9.0, 8)
    examples = [[a, b, "caption the audio."], [b, a, "what changed?"]]
    tw = TorchWrapper(TINY_GPT2.name, "v0", "cpu", params=gpt2_params_np(), tokenizer=_DistinctTokenizer(),
                      use_native_audio=False)
    direct = tw.generate(examples, max_len=MAX_LEN)
    engine = BatchingEngine(tw, dynamic_batch=False)
    try:
        futures = [engine.submit(*ex, max_len=MAX_LEN) for ex in examples]
        served = [f.result(timeout=120) for f in futures]
    finally:
        engine.shutdown()
    assert served == direct


def _bf16_tree(tree):
    """Floating leaves cast to bf16 on the host (round to nearest even, as
    XLA's convert), then put on the JAX device."""
    return jax.tree.map(
        lambda a: jnp.asarray(a.astype(jnp.bfloat16) if np.issubdtype(a.dtype, np.floating) else a), tree)


@functools.partial(jax.jit, static_argnums=(1,))
def _jax_prefix(params, cfg, a1, a2, text_ids):
    """``mellow.encode_and_prefix`` with both clip batches in one encoder
    call (the encoder is row-wise; one trace compiles in half the time)."""
    proj = jhtsat.encode_audio_compact(jnp.concatenate([a1, a2]), params, cfg.frontend, cfg.encoder)
    p1, p2 = jnp.split(proj, 2)
    return jmellow.build_prefix(params, cfg, p1, p2, text_ids, compact=True)


@functools.partial(jax.jit, static_argnums=(1,))
def _jax_prefill_logits(dec, cfg, prefix):
    cache = jgpt2.GPT2Cache.create(cfg, prefix.shape[0], prefix.shape[1], jnp.bfloat16)
    hidden, _ = jgpt2.prefill(dec, cfg, prefix, cache)
    return jgpt2.logits_from_hidden(dec, cfg, hidden)


@pytest.fixture(scope="module")
def bf16_runs():
    """Per weight mode: (port, JAX) prefix and prefill logits, and the
    port's greedy tokens, all in bf16. The JAX prefix is made once (the
    int8 weights change only the decoder)."""
    rng = np.random.RandomState(9)
    text_ids = rng.randint(2, 500, size=(2, TINY_GPT2.text_tokenization_len)).astype(np.int32)
    a1, a2 = waves(2, 41), waves(2, 42)
    tree = gpt2_params_np()
    cfg = TINY_GPT2.decoder
    jprefix = _jax_prefix(_bf16_tree(tree), TINY_GPT2,
                          jnp.asarray(a1, jnp.bfloat16), jnp.asarray(a2, jnp.bfloat16), jnp.asarray(text_ids))
    args = (torch.from_numpy(a1).bfloat16(), torch.from_numpy(a2).bfloat16(), torch.from_numpy(text_ids))
    runs = {}
    for mode in ("bf16-weights", "int8-weights"):
        jdec = tree["decoder"]
        p32 = params_from_jax(tree, "cpu")
        if mode == "int8-weights":
            # Eager, as the JAX wrapper quantizes (jit would fold the
            # scale's "/ 127" into a multiply).
            jdec = jax.tree.map(np.asarray, jgpt2.quantize_gpt2(jax.tree.map(jnp.asarray, jdec), cfg))
            p32["decoder"] = tgpt2.quantize_gpt2(p32["decoder"], TCFG.decoder)
        jdec = _bf16_tree(jdec)
        tp = cast_floating(p32, torch.bfloat16)
        jlogits = _jax_prefill_logits(jdec, cfg, jprefix)
        before = fp.LAUNCHES
        with torch.no_grad():
            prefix = tmellow.encode_and_prefix(tp, TCFG, *args)
            dec, tcfg = tp["decoder"], TCFG.decoder
            cache = tgpt2.GPT2Cache.create(tcfg, 2, prefix.shape[1], "cpu", torch.bfloat16)
            logits = tgpt2.logits_from_hidden(dec, tcfg, tgpt2.prefill(dec, tcfg, prefix, cache))
        tokens = tmellow.generate_tokens(tp, TCFG, *args, max_len=MAX_LEN, stop_token_id=-1).tokens
        assert fp.LAUNCHES == before  # CPU tensors: the plain version, no launch
        assert prefix.dtype == logits.dtype == cache.k.dtype == torch.bfloat16
        runs[mode] = [(ours.float().numpy(), np.asarray(theirs.astype(jnp.float32)))
                      for ours, theirs in ((prefix, jprefix), (logits, jlogits))]
        runs[mode].append(tokens.numpy())
    return runs


@pytest.mark.parametrize("mode", ["bf16-weights", "int8-weights"])
def test_prefix_and_prefill_logits_match_jax_bf16(bf16_runs, mode):
    (prefix, jprefix), (logits, jlogits), _ = bf16_runs[mode]
    assert prefix.shape == jprefix.shape == (2, TINY_GPT2.prefix_length, TINY_GPT2.decoder.hidden_size)
    assert logits.shape == jlogits.shape == (2, TINY_GPT2.decoder.vocab_size)
    assert np.isfinite(prefix).all() and np.isfinite(logits).all()
    np.testing.assert_allclose(prefix, jprefix, atol=3e-2 * np.abs(jprefix).max(), rtol=0)
    np.testing.assert_allclose(logits, jlogits, atol=5e-2 * np.abs(jlogits).max(), rtol=0)


@pytest.mark.parametrize("mode", ["bf16-weights", "int8-weights"])
def test_first_greedy_token_matches_jax_bf16(bf16_runs, mode):
    _, (logits, jlogits), tokens = bf16_runs[mode]
    assert tokens.shape == (2, MAX_LEN) and len(set(tokens[0].tolist())) > 1
    np.testing.assert_array_equal(tokens[:, 0], logits.argmax(-1))
    np.testing.assert_array_equal(tokens[:, 0], jlogits.argmax(-1))
