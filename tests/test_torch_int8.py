"""The port's int8 quantizers and int8 parameter trees against the JAX
package's, on the CPU.

Held bit-equal (no tolerance: the same fp32 operations, and ``torch.round``
rounds half to even as ``jnp.round`` does):

* ``quantize_kv``, ``quantize_weight`` and ``quantize_decoder`` (``lm_head_q``
  included), both before and after the cast of every floating leaf to
  bf16, which is the JAX wrapper's order (quantize the fp32 weights, then
  cast);
* the int8 tree through ``params_from_jax``: int8 leaves stay int8, the
  scales take the compute dtype;
* ``MellowWrapper(..., weight_dtype=...)``'s decoder tree against the JAX
  wrapper's.

Also: every combination of the int8 options the JAX wrapper accepts under
bf16 runs through the port's wrapper, and what it still refuses on the int8
surface raises."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mellow_tpu.models import llama as jllama
from mellow_tpu.wrapper import MellowWrapper as JaxWrapper
from mellow_tpu_torch.io.tokenizer import ByteTokenizer
from mellow_tpu_torch.models import llama as tllama
from mellow_tpu_torch.models.params import cast_floating, params_from_jax
from mellow_tpu_torch.ops import attn_block_w8a8, decode_attention_int8, mlp_block_w8a8
from mellow_tpu_torch.wrapper import MellowWrapper as TorchWrapper
from tests.test_torch_e2e import _write_wav
from tests.torch_port_common import TINY, jax_params_np

DEC = TINY.decoder


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jnp(a):
    a = jnp.asarray(a)
    return np.asarray(a.astype(jnp.float32)) if a.dtype == jnp.bfloat16 else np.asarray(a)


def _assert_bit_equal(ours, theirs):
    """Same leaves, dtypes (bf16 / int8 / fp32) and values."""
    names = {torch.bfloat16: "bfloat16", torch.int8: "int8", torch.float32: "float32"}
    assert names[ours.dtype] == jnp.asarray(theirs).dtype.name
    np.testing.assert_array_equal(_np(ours), _jnp(theirs))


def test_quantize_kv_bit_equal():
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 5, 2 * 32) * rng.rand(3, 5, 1) * 4).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero row takes the 1e-8 floor
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        q, s = tllama.quantize_kv(torch.from_numpy(x).to(dt))
        jq, js = jllama.quantize_kv(jnp.asarray(x, jdt))
        _assert_bit_equal(q, jq)
        _assert_bit_equal(s, js)


def test_quantize_weight_bit_equal():
    rng = np.random.RandomState(1)
    w = (rng.randn(3, 48, 40) * 0.2).astype(np.float32)
    w[1, :, 7] = 0.0  # an all-zero column takes the 1e-12 floor
    q = tllama.quantize_weight(torch.from_numpy(w))
    jq = jllama.quantize_weight(jnp.asarray(w))
    assert q["q"].shape == (3, 48, 40) and q["scale"].shape == (3, 40)
    _assert_bit_equal(q["q"], jq["q"])
    _assert_bit_equal(q["scale"], jq["scale"])


def _jax_quantized_bf16():
    """The JAX wrapper's int8 decoder: quantize_decoder on the fp32 tree,
    then every floating leaf cast to bf16."""
    jq = jllama.quantize_decoder(jax.tree.map(jnp.asarray, jax_params_np()["decoder"]), DEC)
    return jax.tree.map(
        lambda a: a.astype(jnp.bfloat16) if jnp.issubdtype(a.dtype, jnp.floating) else a, jq)


def _per_layer(jtree, i):
    return jax.tree.map(lambda a: a[i], jtree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_decoder_bit_equal(dtype):
    ours = tllama.quantize_decoder(params_from_jax(jax_params_np(), "cpu")["decoder"], DEC)
    theirs = jllama.quantize_decoder(jax.tree.map(jnp.asarray, jax_params_np()["decoder"]), DEC)
    if dtype == "bfloat16":
        ours = cast_floating(ours, torch.bfloat16)
        theirs = _jax_quantized_bf16()
    assert set(ours) == set(theirs) == {"embed", "layers", "norm_f", "lm_head_q"}
    assert ours["lm_head_q"]["q"].shape == (DEC.hidden_size, DEC.vocab_size)
    for a, b in zip(jax.tree.leaves(ours["lm_head_q"]), jax.tree.leaves(theirs["lm_head_q"])):
        _assert_bit_equal(a, b)
    for i, lp in enumerate(ours["layers"]):
        jlp = _per_layer(theirs["layers"], i)
        assert set(lp) == set(jlp)
        for k in lp:
            for a, b in zip(jax.tree.leaves(lp[k]), jax.tree.leaves(jlp[k])):
                _assert_bit_equal(a, b)
    _assert_bit_equal(ours["embed"], theirs["embed"])


def test_params_from_jax_keeps_int8_leaves():
    """A JAX-quantized tree (as numpy) reaches the device with int8 values
    as torch.int8 and the scales in the compute dtype."""
    tree = dict(jax_params_np())
    tree["decoder"] = jax.tree.map(np.asarray, _jax_quantized_bf16())
    ours = params_from_jax(tree, "cpu", torch.bfloat16)
    lp = ours["decoder"]["layers"][1]
    assert lp["wq"]["q"].dtype == torch.int8 and lp["wq"]["scale"].dtype == torch.bfloat16
    assert ours["decoder"]["lm_head_q"]["q"].dtype == torch.int8
    _assert_bit_equal(lp["w_down"]["q"], tree["decoder"]["layers"]["w_down"]["q"][1])
    _assert_bit_equal(lp["w_down"]["scale"], tree["decoder"]["layers"]["w_down"]["scale"][1])


@pytest.mark.parametrize("weight_dtype", ["int8", "int8-w8a8"])
def test_wrapper_int8_tree_matches_jax_wrapper(weight_dtype):
    tw = TorchWrapper(TINY.name, "v0", "cpu", params=jax_params_np(), tokenizer=ByteTokenizer(),
                      compute_dtype="bfloat16", weight_dtype=weight_dtype, use_native_audio=False)
    jw = JaxWrapper(TINY.name, "v0", 0, params=jax.tree.map(jnp.asarray, jax_params_np()),
                    tokenizer=ByteTokenizer(), compute_dtype="bfloat16", weight_dtype=weight_dtype,
                    use_native_audio=False)
    assert tw._w8a8 == jw._w8a8 == (weight_dtype == "int8-w8a8")
    ours = tw.params["decoder"]
    # The JAX wrapper keeps fp32 and casts per call; its quantized tree
    # cast as it casts it.
    theirs = jax.tree.map(
        lambda a: a.astype(jnp.bfloat16) if jnp.issubdtype(a.dtype, jnp.floating) else a,
        jw.params["decoder"])
    lp, jlp = ours["layers"][0], _per_layer(theirs["layers"], 0)
    assert lp["w_gate"]["q"].dtype == torch.int8 and lp["w_gate"]["scale"].dtype == torch.bfloat16
    for k in ("wq", "wo", "w_gate", "w_down"):
        _assert_bit_equal(lp[k]["q"], jlp[k]["q"])
        _assert_bit_equal(lp[k]["scale"], jlp[k]["scale"])
    _assert_bit_equal(ours["lm_head_q"]["scale"], theirs["lm_head_q"]["scale"])
    assert tw.params["encoder"]["norm"]["scale"].dtype == torch.bfloat16


# The W8A8 + int8-cache combination is driven against the JAX wrapper in
# tests/test_torch_int8_slice.py, bf16 alone in tests/test_torch_bf16.py.
@pytest.mark.parametrize("weight_dtype, kv_cache_dtype",
                         [("int8", None), ("int8-w8a8", None), (None, "int8"), ("int8", "int8")])
def test_wrapper_runs_every_accepted_int8_combination(tmp_path, weight_dtype, kv_cache_dtype):
    """The other combinations the JAX wrapper accepts under bf16 answer, with
    the plain versions on the CPU (no launch counted)."""
    wav = _write_wav(tmp_path / "a.wav", 2.0, 7)
    tw = TorchWrapper(TINY.name, "v0", "cpu", params=jax_params_np(), tokenizer=ByteTokenizer(),
                      compute_dtype="bfloat16", weight_dtype=weight_dtype, use_native_audio=False)
    mods = (attn_block_w8a8, decode_attention_int8, mlp_block_w8a8)
    before = [m.LAUNCHES for m in mods]
    out = tw.generate([[wav, wav, "x"]], max_len=3, crop_start=0, kv_cache_dtype=kv_cache_dtype)
    assert len(out) == 1 and isinstance(out[0], str)
    assert [m.LAUNCHES for m in mods] == before


# An int8 cache or int8 weights under fp32 and an fp16 cache are served since
# the dtype surface (tests/test_torch_dtype_surface.py): what is left to refuse.
@pytest.mark.parametrize(
    "ctor, call, error",
    [({"compute_dtype": "bfloat16", "weight_dtype": "int4"}, {}, ValueError),
     ({"compute_dtype": "bfloat16", "weight_dtype": "int8"}, {"kv_cache_dtype": "float64"},
      NotImplementedError)],
    ids=["int4-weights", "fp64-cache"],
)
def test_wrapper_refuses_the_rest_of_the_int8_surface(ctor, call, error):
    with pytest.raises(error):
        tw = TorchWrapper(TINY.name, "v0", "cpu", params=jax_params_np(), tokenizer=ByteTokenizer(),
                          use_native_audio=False, **ctor)
        tw.generate([["a.wav", "b.wav", "x"]], max_len=2, **call)
