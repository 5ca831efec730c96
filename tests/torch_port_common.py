"""Shared set-up for the port-vs-JAX tests (tests/test_torch_*.py): the tiny
configuration of tests/test_e2e.py, and one set of weights for both sides.

The weights are ``mellow_tpu.models.mellow.init_params`` with seeded noise
added to every leaf: the plain init has zero biases and identity norms,
which would hide a bias or norm the port forgot."""

import functools

import numpy as np
import jax

from mellow_tpu.config import HTSATConfig, LlamaConfig, MellowConfig, register_config
from mellow_tpu.models import mellow as jmellow

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


@functools.lru_cache(maxsize=1)
def jax_params_np(seed: int = 0) -> dict:
    """The JAX-layout parameter tree as numpy, every leaf perturbed."""
    rng = np.random.default_rng(seed + 100)
    tree = jax.tree.map(np.asarray, jmellow.init_params(jax.random.PRNGKey(seed), TINY))
    tree = jax.tree.map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), tree
    )
    # At init scale the tiny decoder repeats one token forever; larger
    # weights make the greedy tokens vary by step and by row.
    dec = tree["decoder"]
    dec["embed"] = dec["embed"] * np.float32(3.0)
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        dec["layers"][k] = dec["layers"][k] * np.float32(10.0)
    return tree


def waves(b: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return (rng.randn(b, TINY.frontend.num_samples) * 0.1).astype(np.float32)
