"""Shared set-up for the port-vs-JAX tests (tests/test_torch_*.py): the tiny
configuration of tests/test_e2e.py, its GPT-2-family twin, an
HTSAT-large-shaped twin at reduced width and depth, and one set of weights
for both sides.

The weights are ``mellow_tpu.models.mellow.init_params`` with seeded noise
added to every leaf: the plain init has zero biases and identity norms,
which would hide a bias or norm the port forgot."""

import dataclasses
import functools
import os

import numpy as np
import jax
import torch

from mellow_tpu.config import HTSATConfig, LlamaConfig, MellowConfig, register_config
from mellow_tpu.models import mellow as jmellow
from mellow_tpu.models.gpt2 import GPT2Config
from mellow_tpu_torch import config as tconfig
from mellow_tpu_torch.models import gpt2 as tgpt2
from mellow_tpu_torch.models import mellow as tmellow

# Under pytest-xdist each worker's torch would start a thread per core, and
# the workers' threads then contend for the same cores: six of the port's
# test files run at once on eight cores took 257-314 s each, and 27-69 s with
# one torch thread each (alone: 32-54 s). So the cores are split among the
# workers; alone (no worker count) torch keeps all of them.
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

DEC = LlamaConfig(
    vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=4,
    num_heads=4, num_kv_heads=2, head_dim=16,
)
ENC = HTSATConfig(embed_dim=24, out_emb=192)
TINY = MellowConfig(
    name="test_torch_tiny", encoder=ENC, decoder=DEC, d_proj=64,
    text_tokenization_len=8, prefix_length=268,
).validate()
register_config(TINY.name, TINY)
# The port keeps its own config classes and registry: the same tiny config
# there, so that the port's wrappers find it by name.
tconfig.register_config(TINY.name, tconfig.MellowConfig(
    name=TINY.name,
    encoder=tconfig.HTSATConfig(embed_dim=24, out_emb=192),
    decoder=tconfig.LlamaConfig(
        vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=4,
        num_heads=4, num_kv_heads=2, head_dim=16,
    ),
    d_proj=64, text_tokenization_len=8, prefix_length=268,
))


# The GPT-2 family at the same tiny size: sep and stop ids inside the tiny
# vocab, and positions for the 268-token prefix plus 32 generated tokens.
GPT2_DEC = dict(vocab_size=512, hidden_size=64, num_layers=3, num_heads=4, max_position_embeddings=300)
GPT2_IDS = dict(decoder_family="gpt2", text_decoder="gpt2", sep_token_id=509, stop_token_id=509)
TINY_GPT2 = MellowConfig(
    name="test_torch_tiny_gpt2", encoder=ENC, decoder=GPT2Config(**GPT2_DEC), d_proj=64,
    text_tokenization_len=8, prefix_length=268, **GPT2_IDS,
).validate()
register_config(TINY_GPT2.name, TINY_GPT2)
tconfig.register_config(TINY_GPT2.name, tconfig.MellowConfig(
    name=TINY_GPT2.name, encoder=tconfig.HTSATConfig(embed_dim=24, out_emb=192),
    decoder=tgpt2.GPT2Config(**GPT2_DEC), d_proj=64, text_tokenization_len=8, prefix_length=268,
    **GPT2_IDS,
))


# HTSAT-large's shape at reduced width and depth: its embed_dim-to-heads
# ratio (256 / 4), so hd = 64 at every stage, behind the tiny decoder.
LARGE_ENC = dict(embed_dim=64, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8), out_emb=512)
TINY_LARGE = MellowConfig(
    name="test_torch_tiny_htsat_large", encoder=HTSATConfig(**LARGE_ENC), decoder=DEC, d_proj=64,
    text_tokenization_len=8, prefix_length=268,
).validate()
register_config(TINY_LARGE.name, TINY_LARGE)
tconfig.register_config(TINY_LARGE.name, tconfig.MellowConfig(
    name=TINY_LARGE.name, encoder=tconfig.HTSATConfig(**LARGE_ENC),
    decoder=tconfig.get_config(TINY.name).decoder, d_proj=64, text_tokenization_len=8,
    prefix_length=268,
))


# Training's comparisons with JAX's gradients: the tiny decoder at two
# layers behind a shallower encoder (one shifted-window block, in stage 1),
# since JAX compiles the whole backward pass for each comparison.
TINY_TRAIN = MellowConfig(
    name="test_torch_tiny_train", encoder=HTSATConfig(embed_dim=24, depths=(2, 1, 1, 1), out_emb=192),
    decoder=dataclasses.replace(DEC, num_layers=2), d_proj=64, text_tokenization_len=8, prefix_length=268,
).validate()
register_config(TINY_TRAIN.name, TINY_TRAIN)
tconfig.register_config(TINY_TRAIN.name, tconfig.MellowConfig(
    name=TINY_TRAIN.name, encoder=tconfig.HTSATConfig(embed_dim=24, depths=(2, 1, 1, 1), out_emb=192),
    decoder=tconfig.LlamaConfig(**dataclasses.asdict(TINY_TRAIN.decoder)), d_proj=64, text_tokenization_len=8,
    prefix_length=268,
))


@functools.lru_cache(maxsize=2)
def _perturbed(cfg, seed: int) -> dict:
    """The JAX package's init of ``cfg`` as numpy, every leaf perturbed.
    Cached: callers copy before they change a leaf."""
    rng = np.random.default_rng(seed + 100)
    tree = jax.tree.map(np.asarray, jmellow.init_params(jax.random.PRNGKey(seed), cfg))
    return jax.tree.map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), tree
    )


def _scale_up(dec: dict, family: str) -> None:
    """At init scale the tiny decoder repeats one token forever; larger
    weights make the greedy tokens vary by step and by row."""
    dec["wte" if family == "gpt2" else "embed"] *= np.float32(3.0)
    keys = (("w_qkv", "w_o", "w_fc", "w_proj") if family == "gpt2"
            else ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"))
    for k in keys:
        dec["layers"][k] *= np.float32(10.0)


@functools.lru_cache(maxsize=2)
def jax_params_np(seed: int = 0, scaled: bool = True) -> dict:
    """The JAX-layout parameter tree as numpy, every leaf perturbed;
    ``scaled=False`` leaves the decoder unscaled (gradient comparisons,
    where the scaled weights amplify rounding)."""
    tree = jax.tree.map(np.copy, _perturbed(TINY, seed))
    if scaled:
        _scale_up(tree["decoder"], "llama")
    return tree


@functools.lru_cache(maxsize=3)
def port_params_np(cfg: MellowConfig, seed: int = 0, scaled: bool = True) -> dict:
    """``jax_params_np``'s recipe (every leaf perturbed, the decoder scaled
    up unless ``scaled=False``) on the port's numpy init of ``cfg``
    (``mellow_tpu_torch.models.mellow.init_params``, the JAX package's tree
    layout), with no JAX init: other values, for tests that only need one
    set of weights on both sides. Cached: callers copy before they change a
    leaf."""
    rng = np.random.default_rng(seed + 100)
    tree = jax.tree.map(lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
                        tmellow.init_params(cfg, seed))
    if scaled:
        _scale_up(tree["decoder"], cfg.decoder_family)
    return tree


def waves(b: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return (rng.randn(b, TINY.frontend.num_samples) * 0.1).astype(np.float32)


@functools.lru_cache(maxsize=2)
def gpt2_params_np(seed: int = 0, scaled: bool = True) -> dict:
    """``jax_params_np`` for TINY_GPT2, its decoder scaled up likewise;
    ``scaled=False`` leaves the perturbed init as it is (fp32 comparisons
    of hidden states, where the scaled weights amplify rounding)."""
    tree = jax.tree.map(np.copy, _perturbed(TINY_GPT2, seed))
    if scaled:
        _scale_up(tree["decoder"], "gpt2")
    return tree


def train_params_np(seed: int = 0) -> dict:
    """``port_params_np`` for TINY_TRAIN, the decoder unscaled (gradient
    comparisons, where scaled weights amplify rounding)."""
    return port_params_np(TINY_TRAIN, seed, scaled=False)


def train_batch(B: int = 4, T: int = 6, seed: int = 0) -> dict:
    """A seeded batch with ragged answer masks (3 to 6 tokens a row)."""
    rng = np.random.RandomState(seed)
    lens = [T, T - 1, T - 3, T - 2][:B]
    return {
        "audio1": waves(B, seed + 1), "audio2": waves(B, seed + 2),
        "text_ids": rng.randint(0, 512, (B, TINY_TRAIN.text_tokenization_len)).astype(np.int32),
        "answer_ids": rng.randint(0, 512, (B, T)).astype(np.int32),
        "answer_mask": np.array([[1.0] * n + [0.0] * (T - n) for n in lens], np.float32),
    }


# The multi-device dry run's tiny configuration (``mellow_tpu_torch.parallel.
# dryrun.DRYRUN``, which the port registers itself so its CPU ranks need no
# JAX), registered in the JAX package too.
from mellow_tpu_torch.parallel.dryrun import DRYRUN as _DRYRUN  # noqa: E402

DRYRUN_JAX = MellowConfig(
    name=_DRYRUN.name, encoder=HTSATConfig(embed_dim=8, out_emb=64),
    decoder=LlamaConfig(**dataclasses.asdict(_DRYRUN.decoder)), d_proj=96, text_tokenization_len=8,
    prefix_length=268,
).validate()
register_config(DRYRUN_JAX.name, DRYRUN_JAX)
assert dataclasses.asdict(DRYRUN_JAX) == dataclasses.asdict(_DRYRUN)
