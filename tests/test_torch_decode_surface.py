"""The port's streaming and cascade decoding against the JAX package's, on
the CPU at the tiny configuration (``tests/torch_port_common.py``), on a
seeded prefix of four rows [a, b, c, a], a stop token that row a emits in
the first flush window and rows b and c never do, and a flush window of 4
steps (the default of 8 is held against the JAX package in
``tests/test_torch_e2e.py``; 4 gives three windows in 12 steps and halves
the JAX package's compile time here):

* every ``generate_stream`` yield equals the JAX package's, and the last
  one equals ``generate``;
* ``generate_cascade`` at ``min_batch=1`` equals the JAX package's and the
  port's ``generate`` after the stop trim, with its step count: with a
  compaction mid-decode (rows a finish in the first window), for llama in
  fp32 and GPT-2, and with planted ``initial_done`` rows (a compaction
  before the first window, then one mid-decode) for llama; for llama in
  bf16 with an int8 cache, planted rows and the default window of 8,
  against the port's static path (the JAX package's CPU path
  differs there by design, ROADMAP Queue 3). The compactions are counted;
* the wrapper serves the options it once refused (``sample``,
  ``dynamic_batch``, ``repetition_penalty``): the greedy ones with the JAX
  wrapper's strings, sampling repeating under one seed. These run the
  encoder, slow on a loaded CPU: five port wrapper calls in all."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mellow_tpu.models import generate as jgen
from mellow_tpu.wrapper import MellowWrapper as JaxWrapper
from mellow_tpu_torch.models import generate as tgen
from mellow_tpu_torch.models.params import cast_floating, params_from_jax
from mellow_tpu_torch.wrapper import MellowWrapper as TorchWrapper
from tests.test_torch_e2e import _DistinctTokenizer, _write_wav
from tests.torch_port_common import TINY, TINY_GPT2, jax_params_np, port_params_np

P, MAX_LEN, W = 20, 12, 4
PLANTED = np.array([False, True, False, True])  # rows b and a start done


def _stop(free: torch.Tensor, window: int) -> int:
    """Row a's first token in steps 1 to ``window - 1`` that rows b and c
    never emit."""
    others = set(free[1:3].flatten().tolist())
    return next(int(v) for v in free[0, 1:window] if int(v) not in others)


def _setup(tree, cfg, family, seed):
    """(port params, JAX params, prefix [a, b, c, a], stop token) for one
    decoder."""
    tp = params_from_jax({"decoder": tree}, "cpu")["decoder"]
    jp = jax.tree.map(jnp.asarray, tree)
    x = np.random.default_rng(seed).standard_normal((3, P, cfg.hidden_size)).astype(np.float32)
    prefix = torch.from_numpy(x[[0, 1, 2, 0]])
    free = tgen.generate(tp, cfg, prefix, max_len=MAX_LEN, stop_token_id=-1, family=family).tokens
    return tp, jp, prefix, _stop(free, W)


@pytest.fixture(scope="module")
def llama_setup():
    return _setup(port_params_np(TINY)["decoder"], TINY.decoder, "llama", 1)


@pytest.fixture(scope="module")
def gpt2_setup():
    return _setup(port_params_np(TINY_GPT2)["decoder"], TINY_GPT2.decoder, "gpt2", 2)


@pytest.fixture
def compactions(monkeypatch):
    """(t, batch before, batch after) of every compaction."""
    seen, compact = [], tgen._compact_state

    def counted(state, perm):
        seen.append((state.t, state.tokens.shape[0], len(perm)))
        return compact(state, perm)

    monkeypatch.setattr(tgen, "_compact_state", counted)
    return seen


def test_stream_yields_match_jax_and_end_with_generate(llama_setup):
    tp, jp, prefix, stop = llama_setup
    ours = list(tgen.generate_stream(tp, TINY.decoder, prefix, max_len=MAX_LEN, stop_token_id=stop,
                                     flush_window=W))
    theirs = list(jgen.generate_stream(jp, TINY.decoder, jnp.asarray(prefix.numpy()), max_len=MAX_LEN,
                                       stop_token_id=stop, flush_window=W))
    assert [r.num_steps for r in ours] == [int(r.num_steps) for r in theirs] == [4, 8, 12]
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.tokens.numpy(), np.asarray(b.tokens))
    whole = tgen.generate(tp, TINY.decoder, prefix, max_len=MAX_LEN, stop_token_id=stop, flush_window=W)
    assert torch.equal(ours[-1].tokens, whole.tokens) and ours[-1].num_steps == whole.num_steps


def _hold_cascade(setup, cfg, family, initial_done, compactions):
    tp, jp, prefix, stop = setup
    done = None if initial_done is None else torch.from_numpy(initial_done)
    ours = tgen.generate_cascade(tp, cfg, prefix, max_len=MAX_LEN, stop_token_id=stop, family=family,
                                 flush_window=W, min_batch=1, initial_done=done)
    theirs = jgen.generate_cascade(jp, cfg, jnp.asarray(prefix.numpy()), max_len=MAX_LEN, stop_token_id=stop,
                                   family=family, flush_window=W, min_batch=1,
                                   initial_done=None if done is None else jnp.asarray(initial_done))
    trimmed = tgen.tokens_to_lists(ours, stop)
    assert trimmed == jgen.tokens_to_lists(theirs, stop)
    assert ours.num_steps == int(theirs.num_steps) == MAX_LEN
    static = tgen.tokens_to_lists(tgen.generate(tp, cfg, prefix, max_len=MAX_LEN, stop_token_id=stop,
                                                family=family, flush_window=W), stop)
    live = range(4) if initial_done is None else np.nonzero(~initial_done)[0]
    assert [trimmed[r] for r in live] == [static[r] for r in live]
    # Rows a stop in the first window; rows b and c run to max_len.
    assert [len(trimmed[r]) for r in live] == [len(static[0]) if r in (0, 3) else MAX_LEN for r in live]
    assert len(static[0]) < W
    return list(compactions)


@pytest.mark.parametrize("planted", [False, True], ids=["mid_decode", "initial_done"])
def test_cascade_matches_jax_and_generate_llama(llama_setup, compactions, planted):
    got = _hold_cascade(llama_setup, TINY.decoder, "llama", PLANTED if planted else None, compactions)
    # Mid-decode: rows a finish in the first window. Planted: rows b and a
    # start done, then row a finishes in the first window.
    assert got == ([(0, 4, 2), (W, 2, 1)] if planted else [(W, 4, 2)])


def test_cascade_matches_jax_and_generate_gpt2(gpt2_setup, compactions):
    assert _hold_cascade(gpt2_setup, TINY_GPT2.decoder, "gpt2", None, compactions) == [(W, 4, 2)]


def test_cascade_int8_cache_matches_the_static_path(llama_setup, compactions):
    """bf16 weights with an int8 cache: the cache's scales and the flush
    window's rows are gathered at a window boundary (compaction before the
    first window and after a full window of W = 8)."""
    tp, _, prefix, _ = llama_setup
    tp16, x16 = cast_floating(tp, torch.bfloat16), prefix.bfloat16()
    kw = dict(max_len=MAX_LEN, kv_cache_dtype="int8")
    stop = _stop(tgen.generate(tp16, TINY.decoder, x16, stop_token_id=-1, **kw).tokens, 8)
    ours = tgen.generate_cascade(tp16, TINY.decoder, x16, stop_token_id=stop, min_batch=1,
                                 initial_done=torch.from_numpy(PLANTED), **kw)
    static = tgen.generate(tp16, TINY.decoder, x16, stop_token_id=stop, **kw)
    trimmed, want = tgen.tokens_to_lists(ours, stop), tgen.tokens_to_lists(static, stop)
    assert [trimmed[r] for r in (0, 2)] == [want[r] for r in (0, 2)] and len(trimmed[2]) == MAX_LEN
    assert compactions == [(0, 4, 2), (8, 2, 1)]


@pytest.fixture(scope="module")
def wrappers(tmp_path_factory):
    """Both wrappers on ``jax_params_np``'s weights (on which the penalty
    moves these answers), two examples, a stop token from the port's free
    run (row 0, step 4) and the port's greedy strings."""
    tmp = tmp_path_factory.mktemp("wavs")
    short = _write_wav(tmp / "short.wav", 7.0, 1)
    long = _write_wav(tmp / "long.wav", 11.0, 2)
    examples = [[short, long, "caption the audio."], [long, short, "what changed?"]]
    tok = _DistinctTokenizer()
    params = jax_params_np()
    tw = TorchWrapper(TINY.name, "v0", "cpu", params=params, tokenizer=tok, use_native_audio=False)
    jw = JaxWrapper(TINY.name, "v0", 0, params=jax.tree.map(jnp.asarray, params), tokenizer=tok,
                    use_native_audio=False)
    never = chr(tok.BASE + TINY.decoder.vocab_size)  # an id no row can emit
    free = tw.generate(examples, max_len=MAX_LEN, crop_start=0, stop_token=never)
    # Greedy tokens do not depend on the stop: its answers are the free
    # run's, cut at the stop.
    stop = free[0][4]
    return tw, jw, examples, stop, [s.split(stop)[0] for s in free]


@pytest.mark.parametrize(
    "kwargs", [{"sample": True, "top_k": 20}, {"dynamic_batch": True}, {"repetition_penalty": 1.3}],
    ids=["sample", "dynamic_batch", "repetition_penalty"],
)
def test_wrapper_serves_what_is_now_ported(wrappers, kwargs):
    """The options ``tests/test_torch_e2e.py::test_wrapper_refuses_what_is_not_ported``
    once held refused. The JAX wrapper runs its cascade path for both
    greedy cases (one compile of its encoder for the two; a batch under its
    ``min_batch`` decodes in one stage, its static path)."""
    tw, jw, examples, stop, greedy = wrappers
    ours = tw.generate(examples, max_len=MAX_LEN, crop_start=0, stop_token=stop, **kwargs)
    assert len(ours) == 2 and all(isinstance(s, str) for s in ours)
    if kwargs.get("sample"):
        # Another seed moves the draws: tests/test_torch_sampling.py.
        assert ours == tw.generate(examples, max_len=MAX_LEN, crop_start=0, stop_token=stop, **kwargs)
        return
    theirs = jw.generate(examples, max_len=MAX_LEN, crop_start=0, stop_token=stop,
                         **{"dynamic_batch": True, **kwargs})
    assert ours == theirs
    assert (ours == greedy) == ("dynamic_batch" in kwargs)
