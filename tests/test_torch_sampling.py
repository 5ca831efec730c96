"""The port's token choice against the JAX package's, on the CPU at the tiny
configuration (``tests/torch_port_common.py``):

* ``warp_logits`` on seeded logits with planted ties, over top_p x top_k x
  temperature x repetition penalty: the same -inf mask, the kept values
  within 1e-6;
* sampled draws land in that kept set, and 20,000 draws of one row fit its
  filtered softmax (chi-square); the sampler's streams differ from the JAX
  package's by design (its own generator), so draws are held in
  distribution;
* one seed repeats its tokens end to end, and top_k=1 or top_p=1e-6
  sampling is greedy;
* greedy with ``repetition_penalty=1.3``, its mask seeded from the prompt's
  non-pad ids, token for token and step for step the JAX package's
  ``generate`` on the same prefix (what its ``generate_tokens`` runs after
  the encoder, given the same ids); the port's ``generate_tokens`` seeds
  its mask so."""

import itertools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from scipy import stats

from mellow_tpu.models import generate as jgen
from mellow_tpu_torch.models import generate as tgen
from mellow_tpu_torch.models import mellow as tmellow
from mellow_tpu_torch.models.params import params_from_jax
from tests.torch_port_common import TINY, port_params_np

B, V = 4, 300
MAX_LEN = 12
GRID = list(itertools.product((0.3, 0.8, 0.95, 1.0), (0, 1, 10, V + 5), (0.5, 1.0, 2.0), (1.0, 1.3)))


@pytest.fixture(scope="module")
def logits_and_seen():
    """(B, V) fp32 logits with ties planted where the kept set's edges fall:
    row 0 at its top value, row 1 at its 10th largest, row 2 on a grid of
    0.5 (ties everywhere); row 3 as drawn. A random seen mask."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((B, V)) * 2.0).astype(np.float32)
    top = np.argsort(-x[0])
    x[0, top[1:4]] = x[0, top[0]]
    tenth = np.argsort(-x[1])
    x[1, tenth[10:14]] = x[1, tenth[9]]
    x[2] = np.round(x[2] * 2.0) / 2.0
    return x, rng.random((B, V)) < 0.2


@pytest.mark.parametrize("top_p, top_k, temperature, penalty", GRID)
def test_warp_logits_matches_jax(logits_and_seen, top_p, top_k, temperature, penalty):
    x, seen = logits_and_seen
    kw = dict(top_p=top_p, top_k=top_k, temperature=temperature, repetition_penalty=penalty)
    theirs = np.asarray(jgen.warp_logits(jnp.asarray(x), seen=jnp.asarray(seen), **kw))
    ours = tgen.warp_logits(torch.from_numpy(x), seen=torch.from_numpy(seen), **kw).numpy()
    removed = np.isneginf(theirs)
    np.testing.assert_array_equal(np.isneginf(ours), removed)
    np.testing.assert_allclose(ours[~removed], theirs[~removed], rtol=0, atol=1e-6)
    assert (~removed).any(axis=1).all()


def _draws(x, seen, n, seed, **kw):
    """``n`` draws from each row of ``x`` (rows repeated), one generator."""
    rng = torch.Generator()
    rng.manual_seed(seed)
    logits = torch.from_numpy(x).repeat_interleave(n, 0)
    seen_t = None if seen is None else torch.from_numpy(seen).repeat_interleave(n, 0)
    return tgen._sample_token(logits, greedy=False, rng=rng, seen=seen_t, **kw).reshape(len(x), n)


@pytest.mark.parametrize("top_p, top_k, temperature, penalty", [(0.8, 0, 1.0, 1.0), (0.95, 10, 2.0, 1.3),
                                                                 (0.3, V + 5, 0.5, 1.3), (1.0, 1, 1.0, 1.0)])
def test_draws_stay_in_the_kept_set(logits_and_seen, top_p, top_k, temperature, penalty):
    x, seen = logits_and_seen
    kw = dict(top_p=top_p, top_k=top_k, temperature=temperature, repetition_penalty=penalty)
    kept = ~np.isneginf(tgen.warp_logits(torch.from_numpy(x), seen=torch.from_numpy(seen), **kw).numpy())
    draws = _draws(x, seen, 500, 0, **kw).numpy()
    assert all(kept[r, draws[r]].all() for r in range(B))
    # Every row draws more than one token where it keeps more than one.
    assert all(len(set(draws[r])) > 1 for r in range(B) if kept[r].sum() > 4)


def test_draws_fit_the_filtered_softmax(logits_and_seen):
    x, _ = logits_and_seen
    row = x[3:4] / 2.0  # a flatter row: a kept set of dozens of tokens
    kw = dict(top_p=0.9, top_k=0, temperature=1.0, repetition_penalty=1.0)
    p = torch.softmax(tgen.warp_logits(torch.from_numpy(row), **kw), -1)[0].double().numpy()
    counts = np.bincount(_draws(row, None, 20000, 7, **kw)[0].numpy(), minlength=V)
    kept = p > 0
    assert counts[~kept].sum() == 0 and kept.sum() > 20
    expected = p[kept] * 20000
    # Tokens expected fewer than 5 times share one bin, as the test asks.
    small = expected < 5
    obs, exp = counts[kept][~small], expected[~small]
    if small.any():
        obs, exp = np.append(obs, counts[kept][small].sum()), np.append(exp, expected[small].sum())
    chi2 = ((obs - exp) ** 2 / exp).sum()
    assert stats.chi2.sf(chi2, len(obs) - 1) > 1e-3, chi2


@pytest.fixture(scope="module")
def prompt_run():
    """The port's params, a seeded B=2 prefix (P = 20) and a prompt with
    pad ids in it. Decoder level: the encoder, slow on a loaded CPU, adds
    nothing to what these tests hold."""
    tp = params_from_jax(port_params_np(TINY), "cpu")
    rng = np.random.default_rng(4)
    prefix = torch.from_numpy(rng.standard_normal((2, 20, TINY.decoder.hidden_size)).astype(np.float32))
    text = rng.integers(2, 500, size=(2, TINY.text_tokenization_len)).astype(np.int32)
    text[:, -3:] = TINY.pad_token_id
    return tp, prefix, torch.from_numpy(text)


def test_sampling_repeats_under_one_seed(prompt_run):
    tp, prefix, _ = prompt_run

    def run(seed):
        rng = torch.Generator()
        rng.manual_seed(seed)
        return tgen.generate(tp["decoder"], TINY.decoder, prefix, max_len=MAX_LEN, stop_token_id=-1,
                             greedy=False, top_p=0.95, temperature=1.5, rng=rng).tokens

    first = run(3)
    assert torch.equal(first, run(3)) and not torch.equal(first, run(4))


@pytest.mark.parametrize("knobs", [{"top_k": 1}, {"top_p": 1e-6}], ids=["top_k=1", "top_p=1e-6"])
def test_sampling_at_one_token_is_greedy(prompt_run, knobs):
    tp, prefix, _ = prompt_run
    kw = dict(max_len=MAX_LEN, stop_token_id=-1)
    greedy = tgen.generate(tp["decoder"], TINY.decoder, prefix, **kw)
    sampled = tgen.generate(tp["decoder"], TINY.decoder, prefix, greedy=False, temperature=2.0,
                            **{"top_p": 1.0, **knobs}, **kw)
    assert torch.equal(sampled.tokens, greedy.tokens)


def test_greedy_repetition_penalty_matches_jax(prompt_run, monkeypatch):
    """At a flush window of 4 (three windows in 12 steps; the JAX package
    compiles it in half the time of 8), and the port's ``generate_tokens``
    (its encoder patched to return the prefix) equal to the port's
    ``generate`` given the prompt's non-pad ids."""
    tp, prefix, text = prompt_run
    dec, mask = tp["decoder"], text != TINY.pad_token_id
    free = tgen.generate(dec, TINY.decoder, prefix, max_len=MAX_LEN, stop_token_id=-1, repetition_penalty=1.3,
                         prompt_tokens=text, prompt_mask=mask)
    plain = tgen.generate(dec, TINY.decoder, prefix, max_len=MAX_LEN, stop_token_id=-1)
    assert not torch.equal(free.tokens, plain.tokens)
    stop = int(free.tokens[1, 2])  # row 1 stops in the first window
    kw = dict(max_len=MAX_LEN, stop_token_id=stop, repetition_penalty=1.3)
    monkeypatch.setattr(tmellow, "encode_and_prefix", lambda *args, **kw: prefix)
    whole = tmellow.generate_tokens(tp, TINY, None, None, text, **kw)
    direct = tgen.generate(dec, TINY.decoder, prefix, prompt_tokens=text, prompt_mask=mask, **kw)
    assert torch.equal(whole.tokens, direct.tokens) and whole.num_steps == direct.num_steps
    # Row 0 starts done, so the loop ends with the window where row 1 stops.
    kw.update(flush_window=4, initial_done=torch.tensor([True, False]))
    ours = tgen.generate(dec, TINY.decoder, prefix, prompt_tokens=text, prompt_mask=mask, **kw)
    jd = jax.tree.map(jnp.asarray, port_params_np(TINY)["decoder"])
    ids = jnp.asarray(text.numpy())
    theirs = jgen.generate(jd, TINY.decoder, jnp.asarray(prefix.numpy()), prompt_tokens=ids,
                           prompt_mask=ids != TINY.pad_token_id, **dict(kw, initial_done=jnp.asarray([True, False])))
    np.testing.assert_array_equal(ours.tokens.numpy(), np.asarray(theirs.tokens))
    assert ours.num_steps == int(theirs.num_steps) == 4
