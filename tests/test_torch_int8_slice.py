"""The port's int8 perf mode against the JAX package's, on the CPU at the
tiny configuration, with the same weights (``quantize_decoder``, bit-equal
on both sides, ``tests/test_torch_int8.py``) and the JAX package's packed
int8 decode forced on in interpret mode (``MELLOW_TPU_FORCE_FUSED_DECODE=
interpret``, as its own tests set it).

Llama level, with bf16 weights or int8 weights and an int8 KV cache:

* one decode step from the same int8 cache (the port's prefill, laid out
  packed for the JAX side) against ``llama.decode_step_packed`` at a flush
  window of 1 and the ``flush_packed`` that follows it: the hidden within
  5e-2 x max|ref| (read: <= 2.3 %), the new cache row at layer 0 within
  one int8 level, and every layer's new row, dequantized, within 5e-2 x
  max|ref| (the layers' bf16 products round in another order and the
  tiny decoder's x10 weights amplify that layer by layer; read: <= 3.2 %);
* one decode sub-step of a flush window with 3 pending bf16 rows (the
  port's own first three steps, handed to both sides) plus the current
  one, against ``decode_step_packed(..., n_extra=3)``: the hidden and the
  new bf16 row within 5e-2 x max|ref|;
* the prefill logits, and ``generate`` against ``gen.generate(
  cache_dtype="int8", fused_decode=True, flush_window=1)`` and at both
  sides' default window (W = 8 at ``max_len`` 12: one flush, then a
  partial window): the first greedy token of each row identical, the
  later ones agreeing at least as often as a floor just under what was
  read;
* the port's copy of the window rule (``generate.effective_window``)
  against the JAX package's over a grid of windows, lengths and batches.

On the CPU the JAX package's bf16 prefill runs its XLA formulation
(``llama.prefill`` gates its kernels on the TPU): int8 weights enter as
``(x @ q) * scale`` there, dequantized into the fused blocks here (as the
JAX package's TPU path does), and the JAX package's two formulations differ
by 7 % of max|logits| at this configuration on their own; nor does its CPU
prefill run W8A8. So the prefill logits are held within 6e-2 x max|ref|
with bf16 weights (read: 4.6 %), 0.15 with int8 weights (read: 10.3 %) and
0.2 with the W8A8 blocks (read: 12.9 %), and the token floors are 11 of 14
with bf16 weights (read: 12) and 1 of 14 with int8 weights (read: 2) at a
window of 1, 15 of 22 (read: 16) and 1 of 22 (read: 2) at the default
window; one flipped near-tie changes every later token. The sub-step with
pending rows read 2.4 % (hidden) and 1.7 % (row) with bf16 weights, 1.5 %
and 1.1 % with int8 weights. ROADMAP Queue 3 records the difference.

Whole slice: the two wrappers at ``compute_dtype="bfloat16",
weight_dtype="int8-w8a8"`` with ``kv_cache_dtype="int8"`` on the same clips
(the JAX wrapper's CPU prefill as above; both at their default flush
window): the first greedy token of each row identical and the later ones
agreeing at least ``FLOOR_W8A8`` times."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mellow_tpu.models import generate as jgen
from mellow_tpu.models import llama as jllama
from mellow_tpu.models import mellow as jmellow
from mellow_tpu.ops.pallas_decode_attention import lane_pad
from mellow_tpu.wrapper import MellowWrapper as JaxWrapper
from mellow_tpu_torch.models import generate as tgen
from mellow_tpu_torch.models import llama as tllama
from mellow_tpu_torch.models import mellow as tmellow
from mellow_tpu_torch.models.params import cast_floating, params_from_jax
from mellow_tpu_torch.ops import attn_block, attn_block_w8a8, decode_attention_int8, mlp_block_w8a8
from mellow_tpu_torch.wrapper import MellowWrapper as TorchWrapper
from tests.test_torch_e2e import _DistinctTokenizer, _write_wav
from tests.torch_port_common import TINY, jax_params_np, waves

DEC = TINY.decoder
B, P, MAX_LEN = 2, 24, 8
MAX_LEN_WINDOW = 12  # the default window (8) flushes once, then runs partial
L, KV, HD = DEC.num_layers, DEC.num_kv_heads, DEC.head_dim
KL = KV * HD
FLOOR_W8A8 = 7  # read: 8 of 14


def _bf16_tree(tree):
    return jax.tree.map(
        lambda a: a.astype(jnp.bfloat16) if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def _decoders(int8_weights: bool):
    """(JAX decoder tree, port decoder tree), both bf16, int8 or not."""
    jd = jax.tree.map(jnp.asarray, jax_params_np()["decoder"])
    td = params_from_jax(jax_params_np(), "cpu")["decoder"]
    if int8_weights:
        jd = jllama.quantize_decoder(jd, DEC)
        td = tllama.quantize_decoder(td, DEC)
    return _bf16_tree(jd), cast_floating(td, torch.bfloat16)


def _prefix():
    rng = np.random.RandomState(3)
    return (rng.randn(B, P, DEC.hidden_size)).astype(np.float32)


def _packed_cache(cache: tllama.KVCache, n: int) -> jllama.PackedKVCache:
    """The port's int8 cache, positions [0, n), in the JAX packed layout."""
    S8 = -(-(n + 1) // 8) * 8
    SP = lane_pad(S8)
    kv = np.zeros((L, B, S8, 2 * KL), np.int8)
    kv[:, :, :n, :KL] = cache.k[:, :, :n].reshape(L, B, n, KL).numpy()
    kv[:, :, :n, KL:] = cache.v[:, :, :n].reshape(L, B, n, KL).numpy()
    sc = np.zeros((L, B, 2 * SP), np.float32)
    sc[:, :, :n] = cache.k_scale[:, :, :n].numpy()
    sc[:, :, SP:SP + n] = cache.v_scale[:, :, :n].numpy()
    return jllama.PackedKVCache(kv=jnp.asarray(kv), length=jnp.asarray(n, jnp.int32),
                                scale=jnp.asarray(sc))


@pytest.fixture(scope="module", params=["bf16-weights", "int8-weights"])
def llama_runs(request):
    """One JAX and one port run of each kind per weight mode."""
    int8_weights = request.param == "int8-weights"
    jd, td = _decoders(int8_weights)
    prefix = _prefix()
    tprefix = torch.from_numpy(prefix).bfloat16()
    mp = pytest.MonkeyPatch()
    mp.setenv("MELLOW_TPU_FORCE_FUSED_DECODE", "interpret")
    try:
        # One decode step from the port's prefill cache.
        cache = tllama.KVCache.create(DEC, B, P + 1, "cpu", torch.int8)
        tllama.prefill(td, DEC, tprefix, cache)
        packed = _packed_cache(cache, P)
        emb = td["embed"][torch.tensor([5, 300])]
        cos, sin = tllama.rope_device_tables(DEC, P + 1, torch.bfloat16, "cpu")
        hidden = tllama.decode_step(td, DEC, emb, cache, P, cos, sin,
                                    tllama.FlushWindow(DEC, B, 1, P, "cpu", torch.bfloat16))
        step_cache = cache
        jcos, jsin = jllama.rope_tables(DEC, packed.kv.shape[2], jnp.bfloat16)
        jhidden, extras = jllama.decode_step_packed(
            jd, DEC, jnp.asarray(emb.float().numpy(), jnp.bfloat16), packed, jnp.asarray(jcos),
            jnp.asarray(jsin), jnp.zeros((L, B, 1, 2 * KL), jnp.bfloat16), 0, interpret=True)
        flushed = jllama.flush_packed(DEC, packed, extras, 1)
        # A sub-step with 3 pending rows: the port's first three steps of a
        # window of 4 from the same prefill cache, then the fourth.
        cache = tllama.KVCache.create(DEC, B, P + 4, "cpu", torch.int8)
        tllama.prefill(td, DEC, tprefix, cache)
        packed = _packed_cache(cache, P)
        window = tllama.FlushWindow(DEC, B, 4, P, "cpu", torch.bfloat16)
        cos, sin = tllama.rope_device_tables(DEC, P + 4, torch.bfloat16, "cpu")
        ids = ([5, 300], [17, 41], [260, 3], [99, 8])
        for i, tok in enumerate(ids[:3]):
            tllama.decode_step(td, DEC, td["embed"][torch.tensor(tok)], cache, P + i, cos, sin, window)
        pending = np.zeros((L, B, 4, 2 * KL), np.float32)
        pending[:, :, :3, :KL] = window.k[:, :, :3].float().reshape(L, B, 3, KL).numpy()
        pending[:, :, :3, KL:] = window.v[:, :, :3].float().reshape(L, B, 3, KL).numpy()
        emb = td["embed"][torch.tensor(ids[3])]
        sub_hidden = tllama.decode_step(td, DEC, emb, cache, P + 3, cos, sin, window)
        jcos, jsin = jllama.rope_tables(DEC, packed.kv.shape[2], jnp.bfloat16)
        jsub, jextras = jllama.decode_step_packed(
            jd, DEC, jnp.asarray(emb.float().numpy(), jnp.bfloat16), packed, jnp.asarray(jcos),
            jnp.asarray(jsin), jnp.asarray(pending, jnp.bfloat16), 3, interpret=True)
        # The window was full after the fourth step, so the port flushed it.
        new_row = np.concatenate([cache.k[:, :, P + 3].reshape(L, B, KL).float().numpy()
                                  * cache.k_scale[:, :, P + 3, None].numpy(),
                                  cache.v[:, :, P + 3].reshape(L, B, KL).float().numpy()
                                  * cache.v_scale[:, :, P + 3, None].numpy()], axis=-1)
        # Prefill logits and greedy tokens.
        jcache = jllama.KVCache.create(DEC, B, P, jnp.int8)
        jh, _ = jllama.prefill(jd, DEC, jnp.asarray(prefix, jnp.bfloat16), jcache)
        jlogits = jllama.logits_from_hidden(jd, DEC, jh)
        tcache = tllama.KVCache.create(DEC, B, P, "cpu", torch.int8)
        tlogits = tllama.logits_from_hidden(td, DEC, tllama.prefill(td, DEC, tprefix, tcache))
        # The W8A8 blocks (int8 weights only); the JAX package's CPU prefill
        # is the same with or without w8a8.
        w8a8_logits = None
        if int8_weights:
            tcache = tllama.KVCache.create(DEC, B, P, "cpu", torch.int8)
            w8a8_logits = tllama.logits_from_hidden(
                td, DEC, tllama.prefill(td, DEC, tprefix, tcache, w8a8=True)).float().numpy()
        jtok = jgen.generate(jd, DEC, jnp.asarray(prefix, jnp.bfloat16), max_len=MAX_LEN,
                             stop_token_id=-1, cache_dtype="int8", fused_decode=True,
                             flush_window=1).tokens
        ttok = tgen.generate(td, DEC, tprefix, max_len=MAX_LEN, stop_token_id=-1,
                             kv_cache_dtype="int8", flush_window=1).tokens
        jtok_w = jgen.generate(jd, DEC, jnp.asarray(prefix, jnp.bfloat16), max_len=MAX_LEN_WINDOW,
                               stop_token_id=-1, cache_dtype="int8", fused_decode=True).tokens
        ttok_w = tgen.generate(td, DEC, tprefix, max_len=MAX_LEN_WINDOW, stop_token_id=-1,
                               kv_cache_dtype="int8").tokens
    finally:
        mp.undo()
    return {
        "mode": request.param,
        "step": (hidden, np.asarray(jhidden.astype(jnp.float32)), step_cache, flushed),
        "substep": (sub_hidden, np.asarray(jsub.astype(jnp.float32)), new_row,
                    np.asarray(jextras[:, :, 3].astype(jnp.float32))),
        "logits": (tlogits.float().numpy(), np.asarray(jlogits.astype(jnp.float32))),
        "w8a8_logits": w8a8_logits,
        "tokens": (ttok.numpy(), np.asarray(jtok)),
        "window_tokens": (ttok_w.numpy(), np.asarray(jtok_w)),
    }


def test_decode_step_matches_jax_packed_decode(llama_runs):
    hidden, jhidden, cache, flushed = llama_runs["step"]
    assert hidden.shape == (B, DEC.hidden_size) and torch.isfinite(hidden.float()).all()
    np.testing.assert_allclose(hidden.float().numpy(), jhidden, atol=5e-2 * np.abs(jhidden).max(), rtol=0)
    SP = flushed.scale.shape[-1] // 2
    row = np.asarray(flushed.kv)[:, :, P]  # (L, B, 2*KL) this step's quantized row
    jsc = np.asarray(flushed.scale)
    for i, (vals, scales, jrow, jscale) in enumerate(
            ((cache.k, cache.k_scale, row[..., :KL], jsc[:, :, P]),
             (cache.v, cache.v_scale, row[..., KL:], jsc[:, :, SP + P]))):
        ours = vals[:, :, P].reshape(L, B, KL).numpy().astype(int)
        assert np.abs(ours[0] - jrow[0].astype(int)).max() <= 1, "layer 0 int8 row"
        deq = ours * scales[:, :, P].numpy()[..., None]
        jdeq = jrow.astype(np.float32) * jscale[..., None]
        np.testing.assert_allclose(deq, jdeq, atol=5e-2 * np.abs(jdeq).max(), rtol=0)


def test_decode_substep_with_pending_rows_matches_jax(llama_runs):
    hidden, jhidden, new_row, jrow = llama_runs["substep"]
    assert hidden.shape == (B, DEC.hidden_size) and torch.isfinite(hidden.float()).all()
    np.testing.assert_allclose(hidden.float().numpy(), jhidden, atol=5e-2 * np.abs(jhidden).max(), rtol=0)
    # This step's bf16 row (JAX's extras row 3), as the port flushed it.
    np.testing.assert_allclose(new_row, jrow, atol=5e-2 * np.abs(jrow).max(), rtol=0)


def test_prefill_logits_match_jax(llama_runs):
    ours, theirs = llama_runs["logits"]
    tol = 6e-2 if llama_runs["mode"] == "bf16-weights" else 0.15
    assert ours.shape == theirs.shape == (B, DEC.vocab_size)
    np.testing.assert_allclose(ours, theirs, atol=tol * np.abs(theirs).max(), rtol=0)
    if llama_runs["w8a8_logits"] is not None:  # int8 weights: the W8A8 blocks too
        w8 = llama_runs["w8a8_logits"]
        assert w8.shape == theirs.shape and np.isfinite(w8).all()
        np.testing.assert_allclose(w8, theirs, atol=0.2 * np.abs(theirs).max(), rtol=0)


def test_generate_tokens_against_jax(llama_runs):
    ours, theirs = llama_runs["tokens"]
    assert ours.shape == theirs.shape == (B, MAX_LEN)
    np.testing.assert_array_equal(ours[:, 0], theirs[:, 0])
    same = int((ours[:, 1:] == theirs[:, 1:]).sum())
    print(f"{llama_runs['mode']}: int8-cache greedy agreement after the first token "
          f"{same}/{ours[:, 1:].size}")
    assert same >= (11 if llama_runs["mode"] == "bf16-weights" else 1)


def test_generate_default_window_tokens_against_jax(llama_runs):
    ours, theirs = llama_runs["window_tokens"]
    assert ours.shape == theirs.shape == (B, MAX_LEN_WINDOW)
    np.testing.assert_array_equal(ours[:, 0], theirs[:, 0])
    same = int((ours[:, 1:] == theirs[:, 1:]).sum())
    print(f"{llama_runs['mode']}: default-window int8-cache greedy agreement after the first token "
          f"{same}/{ours[:, 1:].size}")
    assert same >= (15 if llama_runs["mode"] == "bf16-weights" else 1)


@pytest.mark.parametrize("flush_window", [None, 1, 3, 8, 16])
def test_effective_window_matches_jax(flush_window):
    for max_len in (1, 2, 5, 8, 12, 32):
        for batch in (1, 4, 128, 129, 256):
            assert tgen.effective_window(flush_window, max_len, batch) == \
                jgen._effective_window(flush_window, max_len, True, batch)


# ---------------------------------------------------------------------------
# the whole slice: W8A8 weights and an int8 cache through both wrappers
# ---------------------------------------------------------------------------

def test_w8a8_int8_cache_wrapper_against_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("MELLOW_TPU_FORCE_FUSED_DECODE", "interpret")
    short = _write_wav(tmp_path / "short.wav", 7.0, 5)
    long = _write_wav(tmp_path / "long.wav", 11.0, 6)
    examples = [[short, long, "caption the audio."], [long, short, "what changed?"]]
    tok = _DistinctTokenizer()
    never = chr(tok.BASE + DEC.vocab_size)  # no row stops early
    kw = dict(tokenizer=tok, compute_dtype="bfloat16", weight_dtype="int8-w8a8", use_native_audio=False)
    tw = TorchWrapper(TINY.name, "v0", "cpu", params=jax_params_np(), **kw)
    mods = (attn_block, attn_block_w8a8, decode_attention_int8, mlp_block_w8a8)
    counts = [(m.LAUNCHES, getattr(m, "LAUNCHES_KV_QUANT", 0)) for m in mods]
    ours = tw.generate(examples, max_len=MAX_LEN, crop_start=0, stop_token=never, kv_cache_dtype="int8")
    # On the CPU every kernel is its plain version: no launch is counted.
    assert [(m.LAUNCHES, getattr(m, "LAUNCHES_KV_QUANT", 0)) for m in mods] == counts
    jw = JaxWrapper(TINY.name, "v0", 0, params=jax.tree.map(jnp.asarray, jax_params_np()), **kw)
    theirs = jw.generate(examples, max_len=MAX_LEN, crop_start=0, stop_token=never, kv_cache_dtype="int8")
    assert [len(s) for s in ours] == [len(s) for s in theirs] == [MAX_LEN, MAX_LEN]
    assert [s[0] for s in ours] == [s[0] for s in theirs]
    same = sum(a == b for o, t in zip(ours, theirs) for a, b in zip(o[1:], t[1:]))
    total = sum(len(o) - 1 for o in ours)
    print(f"W8A8 + int8-cache greedy agreement after the first token: {same}/{total}")
    assert same >= FLOOR_W8A8
