"""Training in the port against the JAX package on the CPU, at
``TINY_TRAIN`` of ``tests/torch_port_common.py``: the teacher-forced
decoders (``llama.forward``, ``gpt2.forward``), ``mellow.forward_train``'s
loss, metrics and every gradient leaf against ``jax.value_and_grad``
(plain and with mixup), remat, and one optimizer update against optax.
``tests/test_torch_train_steps.py`` holds the rest of ``train/``."""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mellow_tpu.models import gpt2 as jgpt2
from mellow_tpu.models import llama as jllama
from mellow_tpu.models import mellow as jmellow
from mellow_tpu.train import step as jstep
from mellow_tpu_torch import config as tconfig
from mellow_tpu_torch.models import gpt2 as tgpt2
from mellow_tpu_torch.models import llama as tllama
from mellow_tpu_torch.models import mellow as tmellow
from mellow_tpu_torch.models.params import flatten, params_from_jax, tree_leaves
from mellow_tpu_torch.models.registry import get_model
from mellow_tpu_torch.train import step as tstep
from tests.torch_port_common import TINY_GPT2, TINY_TRAIN, port_params_np, train_batch, train_params_np

TCFG = tconfig.get_config(TINY_TRAIN.name)
# The training tests run at TINY_TRAIN (a shallower tiny encoder, two decoder
# layers) on its unscaled perturbed weights. Loss: the same fp32 math with
# sums in another order. Gradients: each leaf within GRAD_TOL x max|JAX
# leaf|; at the tiny configuration's depth the largest error read was 7.1e-6
# and the median over the leaves 8.5e-7 (with the decoder scaled up 10x, as
# the decoding tests scale it, rounding grows to 3.7e-4).
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
# Optimizer: one update on the same gradients, parameters and moments.
OPT_RTOL = 1e-6


@functools.lru_cache(maxsize=2)
def _jax_loss_and_grads(mixup: bool):
    """JAX's ``forward_train`` loss, metrics and gradients on ``train_batch()``,
    ``rng=None``, as numpy; the gradients in the port's tree layout."""
    b = {k: jnp.asarray(v) for k, v in train_batch().items()}
    lam = jnp.asarray([0.7, 0.3, 0.2, 0.8]) if mixup else None

    def loss_fn(params):
        return jmellow.forward_train(params, TINY_TRAIN, b["audio1"], b["audio2"], b["text_ids"], b["answer_ids"],
                                     b["answer_mask"], mixup_lambda=lam)

    (loss, m), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, train_params_np()))
    grads = flatten(params_from_jax(jax.tree.map(np.asarray, g), "cpu"))
    return float(loss), {k: float(v) for k, v in m.items()}, grads


@functools.lru_cache(maxsize=3)
def _port_loss_and_grads(mixup: bool, remat: bool = False):
    p = tstep.init_train_state(params_from_jax(train_params_np(), "cpu"), tstep.make_optimizer()).params
    b = {k: torch.from_numpy(v) for k, v in train_batch().items()}
    lam = torch.tensor([0.7, 0.3, 0.2, 0.8]) if mixup else None
    loss, m = tmellow.forward_train(p, TCFG, b["audio1"], b["audio2"], b["text_ids"], b["answer_ids"],
                                    b["answer_mask"], mixup_lambda=lam, remat=remat)
    grads = torch.autograd.grad(loss, tree_leaves(p), allow_unused=True)
    flat = {k: torch.zeros_like(t) if g is None else g for (k, t), g in zip(flatten(p).items(), grads)}
    return loss.item(), {k: v.item() for k, v in m.items()}, flat


def test_decoder_forward_matches_jax():
    """``llama.forward`` (with an attention mask) and ``gpt2.forward`` (at a
    position offset) against JAX's logits in fp32, and the registry's
    bundles expose them."""
    x = (np.random.RandomState(3).randn(2, 12, 64) * 0.5).astype(np.float32)
    am = np.ones((2, 12), np.float32)
    am[1, 9:] = 0.0
    dec = train_params_np()["decoder"]
    ours = tllama.forward(params_from_jax({"decoder": dec}, "cpu")["decoder"], TINY_TRAIN.decoder,
                          torch.from_numpy(x), attention_mask=torch.from_numpy(am))
    theirs = np.asarray(jax.jit(functools.partial(jllama.forward, cfg=TINY_TRAIN.decoder))(
        jax.tree.map(jnp.asarray, dec), inputs_embeds=jnp.asarray(x), attention_mask=jnp.asarray(am)))
    np.testing.assert_allclose(ours.detach().numpy(), theirs, rtol=1e-4, atol=1e-4 * np.abs(theirs).max())

    gdec = port_params_np(TINY_GPT2, scaled=False)["decoder"]
    ours = tgpt2.forward(params_from_jax({"decoder": gdec}, "cpu")["decoder"], TINY_GPT2.decoder,
                         torch.from_numpy(x), position_offset=5)
    theirs = np.asarray(jax.jit(functools.partial(jgpt2.forward, cfg=TINY_GPT2.decoder, position_offset=5))(
        jax.tree.map(jnp.asarray, gdec), inputs_embeds=jnp.asarray(x)))
    np.testing.assert_allclose(ours.detach().numpy(), theirs, rtol=1e-4, atol=1e-4 * np.abs(theirs).max())
    assert get_model().forward_train is tmellow.forward_train


@pytest.mark.parametrize("mixup", [False, True], ids=["plain", "mixup"])
def test_forward_train_loss_and_grads_match_jax(mixup):
    """Loss, metrics and every gradient leaf against ``jax.value_and_grad``
    of the JAX package's ``forward_train`` on the same batch and weights,
    ``rng=None``; with a given ``mixup_lambda`` the batch halves."""
    loss_j, m_j, g_j = _jax_loss_and_grads(mixup)
    loss_t, m_t, g_t = _port_loss_and_grads(mixup)
    assert abs(loss_t - loss_j) <= LOSS_RTOL * abs(loss_j), (loss_t, loss_j)
    assert m_t["num_answer_tokens"] == pytest.approx(m_j["num_answer_tokens"], rel=1e-6)
    assert m_t["accuracy"] == pytest.approx(m_j["accuracy"], abs=1e-6)
    assert sorted(g_t) == sorted(g_j)
    worst = 0.0
    for k, want in g_j.items():
        scale = want.abs().max().item()
        err = (g_t[k] - want).abs().max().item()
        worst = max(worst, err / max(scale, 1e-30))
        assert err <= GRAD_TOL * scale or (scale == 0.0 and err == 0.0), (k, err, scale)
    print(f"loss {loss_t:.6f} vs {loss_j:.6f}; worst gradient leaf {worst:.2e} x max|leaf|")


def test_remat_gives_the_same_loss_and_grads():
    loss_a, _, g_a = _port_loss_and_grads(False)
    loss_b, _, g_b = _port_loss_and_grads(False, remat=True)
    assert loss_a == loss_b
    for k in g_a:
        torch.testing.assert_close(g_b[k], g_a[k], rtol=1e-6, atol=1e-7)


def test_optimizer_update_matches_optax():
    """Three updates of a small tree against optax's through the JAX
    package's ``make_optimizer`` (warmup 2, so update 0 has a learning rate
    of 0), the gradients of update 1 clipped (norm 40 > 1), the others not;
    parameters and both moments within 1e-6 relative."""
    rng = np.random.RandomState(0)
    tree = {"a": rng.randn(5, 3).astype(np.float32), "b": rng.randn(7).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * s).astype(np.float32) for k, v in tree.items()} for s in (0.05, 10.0, 0.1)]
    kw = dict(learning_rate=1e-2, weight_decay=0.1, warmup_steps=2, total_steps=6)
    jopt = jstep.make_optimizer(**kw)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    topt = tstep.make_optimizer(**kw)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    tstate = topt.init(tparams)
    jupdate = jax.jit(jopt.update)
    for i, g in enumerate(grads):
        updates, jstate = jupdate(jax.tree.map(jnp.asarray, g), jstate, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        before = {k: v.clone() for k, v in tparams.items()}
        tstate = topt.apply(tparams, [torch.from_numpy(g[k]) for k in sorted(g)], tstate)
        if i == 0:
            assert all(torch.equal(before[k], tparams[k]) for k in tree)  # learning rate 0
        adam = jstate[1][0]
        for name, ours, theirs in (("params", tparams, jparams), ("mu", tstate.mu, adam.mu),
                                   ("nu", tstate.nu, adam.nu)):
            for k in tree:
                np.testing.assert_allclose(ours[k].numpy(), np.asarray(theirs[k]), rtol=OPT_RTOL, atol=1e-12,
                                           err_msg=f"update {i} {name}/{k}")
    assert tstate.count == 3
