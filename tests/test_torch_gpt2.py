"""The port's GPT-2 decoder family against the JAX package's, at the tiny
configuration on the CPU (``tests/torch_port_common.py``): the model
(prefill hidden, logits, decode steps at fp32 within 1e-5 / rtol 1e-4;
greedy tokens identical to ``gen.generate(..., family="gpt2")``), the
parameter trees (init, int8 quantization, the HF converter, the JAX tree's
conversion: bit-equal), the plain version of TPU kernel #10 against the
Pallas kernel in interpret mode, the YAML loader, and the refusals."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mellow_tpu import config_yaml as jconfig_yaml
from mellow_tpu.models import generate as jgen
from mellow_tpu.models import gpt2 as jgpt2
from mellow_tpu.ops.pallas_attention import flash_gqa_prefill as pallas_prefill
from mellow_tpu_torch import config_yaml as tconfig_yaml
from mellow_tpu_torch.models import generate as tgen
from mellow_tpu_torch.models import gpt2 as tgpt2
from mellow_tpu_torch.models import mellow as tmellow
from mellow_tpu_torch.models.decoders import get_decoder_ops
from mellow_tpu_torch.models.params import params_from_jax
from mellow_tpu_torch.ops import flash_gqa_prefill as fp
from mellow_tpu_torch.wrapper import MellowWrapper as TorchWrapper
from tests.test_config_yaml import V0_YAML
from tests.torch_port_common import GPT2_DEC, TINY_GPT2, gpt2_params_np

JCFG = TINY_GPT2.decoder
TCFG = tgpt2.GPT2Config(**GPT2_DEC)
B, P, STEPS = 2, 20, 3


def _tree_equal(ours, theirs) -> None:
    """Two trees of the same keys, every leaf equal in value and type."""
    assert jax.tree.structure(ours) == jax.tree.structure(theirs)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _unstack(tree: dict) -> dict:
    """A JAX-layout decoder tree with its stacked layers split per layer, as
    numpy (the port's layout)."""
    out = {k: jax.tree.map(np.asarray, v) for k, v in tree.items() if k != "layers"}
    n = len(np.asarray(tree["layers"]["ln1_g"]))
    out["layers"] = [jax.tree.map(lambda a: np.asarray(a)[i], tree["layers"]) for i in range(n)]
    return out


@pytest.fixture(scope="module")
def decoder_run():
    """Prefill hidden, prefill logits and STEPS decode steps' hidden and
    logits from both packages, on the same prefix and the same tokens. The
    weights are not scaled up: 10x matrices amplify fp32 rounding to ~3e-5
    by the third step, where these read ~1e-6."""
    dec = gpt2_params_np(scaled=False)["decoder"]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, P, TCFG.hidden_size)).astype(np.float32)
    tokens = rng.integers(0, TCFG.vocab_size, size=(STEPS, B))
    jp = jax.tree.map(jnp.asarray, dec)
    cache = jgpt2.GPT2Cache.create(JCFG, B, P + STEPS)
    h, cache = jgpt2.prefill(jp, JCFG, jnp.asarray(x), cache)
    theirs = [h, jgpt2.logits_from_hidden(jp, JCFG, h)]
    for tok in tokens:
        # A flush after every step, as the port writes its cache: each step
        # traces the same program.
        h, cache, pending = jgpt2.decode_step(jp, JCFG, jp["wte"][tok], cache)
        cache = jgpt2.flush_pending(JCFG, cache, pending)
        theirs += [h, jgpt2.logits_from_hidden(jp, JCFG, h)]
    tp = params_from_jax({"decoder": dec}, "cpu")["decoder"]
    tcache = tgpt2.GPT2Cache.create(TCFG, B, P + STEPS, "cpu")
    with torch.no_grad():
        h = tgpt2.prefill(tp, TCFG, torch.from_numpy(x), tcache)
        ours = [h, tgpt2.logits_from_hidden(tp, TCFG, h)]
        for t, tok in enumerate(tokens):
            h = tgpt2.decode_step(tp, TCFG, tp["wte"][torch.from_numpy(tok)], tcache, P + t)
            ours += [h, tgpt2.logits_from_hidden(tp, TCFG, h)]
    return [o.numpy() for o in ours], [np.asarray(t) for t in theirs]


@pytest.mark.parametrize("step", range(STEPS + 1), ids=["prefill"] + [f"step{i}" for i in range(STEPS)])
def test_hidden_and_logits_match_jax_fp32(decoder_run, step):
    ours, theirs = decoder_run
    for i in (2 * step, 2 * step + 1):  # the hidden, then its logits
        assert ours[i].shape == theirs[i].shape
        np.testing.assert_allclose(ours[i], theirs[i], atol=1e-5, rtol=1e-4)


def test_greedy_generate_matches_jax_fp32():
    dec = gpt2_params_np()["decoder"]
    x = np.random.default_rng(6).standard_normal((B, P, TCFG.hidden_size)).astype(np.float32)
    theirs = jgen.generate(jax.tree.map(jnp.asarray, dec), JCFG, jnp.asarray(x), max_len=12,
                           stop_token_id=-1, greedy=True, family="gpt2")
    ours = tgen.generate(params_from_jax({"decoder": dec}, "cpu")["decoder"], TCFG, torch.from_numpy(x),
                         max_len=12, stop_token_id=-1, family="gpt2")
    assert ours.num_steps == 12
    assert len(set(ours.tokens[0].tolist())) > 3 and not torch.equal(ours.tokens[0], ours.tokens[1])
    np.testing.assert_array_equal(ours.tokens.numpy(), np.asarray(theirs.tokens)[:, :12])


def test_init_params_bit_equal_to_jax():
    _tree_equal(tgpt2.init_params(TCFG, 3), jgpt2.init_params(jax.random.PRNGKey(3), JCFG))
    # The whole model: the JAX package's tree, the gpt2 decoder drawn by
    # gpt2.init_params from the same seed.
    ours = tmellow.init_params(TINY_GPT2, 0)
    assert jax.tree.map(np.shape, ours) == jax.tree.map(np.shape, gpt2_params_np())
    _tree_equal(ours["decoder"], tgpt2.init_params(TCFG, 0))


def test_quantize_gpt2_and_params_from_jax_bit_equal():
    dec = gpt2_params_np()["decoder"]
    tp = params_from_jax({"decoder": dec}, "cpu")["decoder"]
    _tree_equal(jax.tree.map(lambda t: t.numpy(), tp), _unstack(dec))
    theirs = jgpt2.quantize_gpt2(jax.tree.map(jnp.asarray, dec), JCFG)
    ours = tgpt2.quantize_gpt2(tp, TCFG)
    _tree_equal(jax.tree.map(lambda t: t.numpy(), ours), _unstack(theirs))
    # The JAX package's quantized tree converts to the same tree, int8 kept,
    # and every floating leaf cast, the scales included.
    converted = params_from_jax({"decoder": jax.tree.map(np.asarray, theirs)}, "cpu")["decoder"]
    _tree_equal(jax.tree.map(lambda t: t.numpy(), converted), jax.tree.map(lambda t: t.numpy(), ours))
    assert converted["wte_head_q"]["q"].dtype == converted["layers"][0]["w_qkv"]["q"].dtype == torch.int8
    bf = params_from_jax({"decoder": jax.tree.map(np.asarray, theirs)}, "cpu", torch.bfloat16)["decoder"]
    assert bf["layers"][0]["w_o"]["scale"].dtype == bf["wte"].dtype == torch.bfloat16
    assert bf["layers"][0]["w_o"]["q"].dtype == torch.int8


def test_convert_hf_gpt2_bit_equal_to_jax():
    rng = np.random.default_rng(7)
    L, D, V, Pn = 2, 8, 11, 5
    shapes = {"ln_1.weight": (D,), "ln_1.bias": (D,), "ln_2.weight": (D,), "ln_2.bias": (D,),
              "attn.c_attn.weight": (D, 3 * D), "attn.c_attn.bias": (3 * D,),
              "attn.c_proj.weight": (D, D), "attn.c_proj.bias": (D,),
              "mlp.c_fc.weight": (D, 4 * D), "mlp.c_fc.bias": (4 * D,),
              "mlp.c_proj.weight": (4 * D, D), "mlp.c_proj.bias": (D,)}
    sd = {f"model.transformer.h.{i}.{k}": torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          for i in range(L) for k, s in shapes.items()}
    for k, s in {"wte.weight": (V, D), "wpe.weight": (Pn, D), "ln_f.weight": (D,), "ln_f.bias": (D,)}.items():
        sd[f"model.transformer.{k}"] = torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    _tree_equal(tgpt2.convert_hf_gpt2(sd, L, prefix="model."), jgpt2.convert_hf_gpt2(sd, L, prefix="model."))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B_, S, H, KV, hd", [(2, 45, 4, 4, 16), (1, 77, 6, 2, 64)], ids=["mha", "gqa"])
def test_flash_gqa_prefill_plain_matches_pallas(dtype, B_, S, H, KV, hd):
    """#10's plain version against the TPU kernel in interpret mode, at
    KV == H (GPT-2) and a GQA geometry, S not a multiple of 32: fp32 within
    1e-5 (the same fp32 math, sums in another order); bf16 within
    3e-2 x max|ref| (an output, or an exp before the PV product, may round
    to the neighbouring bf16 value)."""
    rng = np.random.default_rng(S)
    qkv = [rng.standard_normal((B_, S, n * hd)).astype(np.float32) * 0.5 for n in (H, KV, KV)]
    kw = dict(num_heads=H, num_kv_heads=KV, head_dim=hd)
    ref = pallas_prefill(*(jnp.asarray(a, dtype) for a in qkv), **kw, interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    tdt = getattr(torch, dtype)
    before = fp.LAUNCHES
    ours = fp.flash_gqa_prefill(*(torch.from_numpy(a).to(tdt) for a in qkv), **kw)
    assert fp.LAUNCHES == before  # a CPU tensor takes the plain version
    assert ours.dtype == tdt and ours.shape == (B_, S, H * hd)
    tol = 1e-5 if dtype == "float32" else 3e-2 * np.abs(ref).max()
    np.testing.assert_allclose(ours.float().numpy(), ref, atol=tol, rtol=0)


def _yaml_gpt2(tmp_path) -> str:
    """The GPT-2 YAML of tests/test_config_yaml.py::test_yaml_gpt2_family."""
    p = tmp_path / "g.yaml"
    p.write_text(
        "data: {text_tokenization_len: 129}\n"
        "model:\n"
        "  encoder: {audioenc_name: HTSAT, d_proj: 768}\n"
        "  decoder: {text_decoder: gpt2, prefix_length: 389}\n"
        "decoder_arch: {hidden_size: 768, num_layers: 12, num_heads: 12}\n"
    )
    return str(p)


def test_load_yaml_config_matches_jax_and_the_smoke(tmp_path):
    import chip_smoke

    path = _yaml_gpt2(tmp_path)
    for p in (path, V0_YAML):
        ours = tconfig_yaml.load_yaml_config(p, "y")
        assert dataclasses.asdict(ours) == dataclasses.asdict(jconfig_yaml.load_yaml_config(p, "y"))
    ours = tconfig_yaml.load_yaml_config(path, chip_smoke.GPT2_CONFIG)
    assert isinstance(ours.decoder, tgpt2.GPT2Config)
    assert ours == chip_smoke.gpt2_config()


def test_refusals():
    dec = gpt2_params_np()["decoder"]
    tp = params_from_jax({"decoder": dec}, "cpu")["decoder"]
    x = torch.zeros((1, P, TCFG.hidden_size))
    with pytest.raises(ValueError, match="llama-family only"):
        tgen.generate(tp, TCFG, x, max_len=4, stop_token_id=-1, family="gpt2", w8a8=True)
    with pytest.raises(ValueError, match="requires a floating dtype"):
        tgen.generate(tp, TCFG, x.bfloat16(), max_len=4, stop_token_id=-1, family="gpt2",
                      kv_cache_dtype="int8")
    # 20 + 281 positions > 300: JAX would clamp the learned positions.
    with pytest.raises(ValueError, match="exceeds the decoder's 300 positions"):
        tgen.generate(tp, TCFG, x, max_len=281, stop_token_id=-1, family="gpt2")
    with pytest.raises(ValueError, match="llama-family only"):
        TorchWrapper(TINY_GPT2.name, "v0", "cpu", params=gpt2_params_np(), compute_dtype="bfloat16",
                     weight_dtype="int8-w8a8")
    with pytest.raises(ValueError, match="unknown decoder family"):
        get_decoder_ops("t5")
