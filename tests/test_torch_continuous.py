"""Continuous batching in the port (``mellow_tpu_torch/models/continuous.py``,
``serving.ContinuousBatchingEngine``) on the CPU, at the tiny configuration's
decoder (``tests/torch_port_common.py``) with short prefixes.

* One test against the JAX package's ``ContinuousScheduler`` (fp32, W=4):
  staggered admission, a stop token, two window rolls and a capacity
  reset; every request's tokens identical, and ``rolls``, ``resets`` and
  ``clock`` equal. It is the only test here that compiles JAX programs.
* Port-only: rows equal to the port's solo ``generate``; ``roll_window``'s
  state invariants; int8-cache slots under bf16 and fp32 equal to solo
  ``generate`` with the same cache; per-request knobs (greedy rows take
  the argmax, sampled rows stay in their kept set, a seed repeats);
  ``submit``'s refusals; the engine, with ``encode_and_prefix`` patched to
  a seeded prefix per prompt, answering as the port wrapper does for the
  same prefix, and failing a request whose wavs cannot be read, alone and
  at once, and a batch whose encoder raises, whole.

No test runs the port's encoder. Every future is waited on for 60 s at
most."""

import time
import wave

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mellow_tpu.models import continuous as jcb
from mellow_tpu_torch.io.tokenizer import ByteTokenizer
from mellow_tpu_torch.models import continuous as cb
from mellow_tpu_torch.models import generate as gen
from mellow_tpu_torch.models import mellow as tmellow
from mellow_tpu_torch.models.params import params_from_jax
from mellow_tpu_torch.serving import ContinuousBatchingEngine
from mellow_tpu_torch.wrapper import MellowWrapper as TorchWrapper
from tests.torch_port_common import TINY, port_params_np

CFG = TINY.decoder
P = 8  # the scheduler tests' prefix length
W = 4
RESULT_S = 60  # the longest wait on a future


@pytest.fixture(scope="module")
def dec():
    return params_from_jax({"decoder": port_params_np(TINY)["decoder"]}, "cpu")["decoder"]


def _prefixes(n, seed=1):
    return (np.random.RandomState(seed).randn(n, P, CFG.hidden_size) * 0.5).astype(np.float32)


def _solo(dec, prefix_row, max_new, stop, **kw):
    res = gen.generate(dec, CFG, torch.as_tensor(prefix_row)[None], max_len=max_new, stop_token_id=stop,
                       flush_window=W, **kw)
    return gen.tokens_to_lists(res, stop)[0]


def _scheduler(dec, **kw):
    return cb.ContinuousScheduler(dec, CFG, **{"slots": 2, "prefix_len": P, "horizon": 16, "stop_token_id": -1,
                                               "W": W, "device": "cpu", **kw})


def test_scheduler_matches_jax(dec):
    """Six requests through 2 slots and a 16-step window: a long row
    admitted mid-flight forces two rolls, the last request (the whole
    window) a reset, and request 0 ends at a stop token."""
    prefixes = _prefixes(6)
    budgets = [4, 4, 12, 8, 8, 16]
    stop = _solo(dec, prefixes[0], 8, -1)[2]
    ours = _scheduler(dec, stop_token_id=stop)
    rids = [ours.submit(p, b) for p, b in zip(prefixes, budgets)]
    got = ours.run_to_completion()
    theirs = jcb.ContinuousScheduler(jax.tree.map(jnp.asarray, port_params_np(TINY)["decoder"]), CFG, slots=2,
                                     prefix_len=P, horizon=16, stop_token_id=stop, W=W)
    jrids = [theirs.submit(p, b) for p, b in zip(prefixes, budgets)]
    want = theirs.run_to_completion()
    assert rids == jrids and got == want
    assert len(got[rids[0]]) < budgets[0] and all(len(got[r]) == b for r, b in zip(rids[1:], budgets[1:]))
    assert (ours.rolls, ours.resets, ours.clock) == (theirs.rolls, theirs.resets, theirs.clock)
    assert ours.rolls >= 1 and ours.resets >= 1


def test_rows_equal_solo_generate(dec):
    """Six requests through 4 slots: the last two are admitted into freed
    slots mid-flight (ragged rows) and still match their solo runs."""
    prefixes = _prefixes(6, seed=2)
    budgets = [6, 3, 9, 4, 7, 5]
    sched = _scheduler(dec, slots=4, horizon=32)
    rids = [sched.submit(torch.from_numpy(p), b) for p, b in zip(prefixes, budgets)]
    got = sched.run_to_completion()
    assert [got[r] for r in rids] == [_solo(dec, p, b, -1) for p, b in zip(prefixes, budgets)]
    assert sched.resets == 0 and sched.idle


def test_roll_window_state_invariants(dec):
    """``roll_window`` shifts the cache columns, the token columns, ``t``, the
    write column, the live rows' start and every deadline together, and
    pins the done rows' start to the new write column; a row rolled
    mid-life decodes on to its solo tokens."""
    prefixes = torch.from_numpy(_prefixes(2, seed=6))
    st = cb.empty_state(CFG, 2, P, 16, device="cpu", W=W)
    kw = dict(horizon=16, stop_token_id=-1, W=W)
    st, t0 = cb.admit(dec, CFG, st, torch.tensor([0]), prefixes[:1], torch.tensor([4]))
    st = cb.decode_stage(dec, CFG, st, 2, **kw)  # slot 0 is done at t = 4
    st, t1 = cb.admit(dec, CFG, st, torch.tensor([1]), prefixes[1:], torch.tensor([8]))
    assert (t0, t1) == (0, 4) and st.done.tolist() == [True, False] and st.start.tolist() == [0, 4]
    delta = 4
    rolled = cb.roll_window(st, delta)
    assert rolled.t == st.t - delta == 0
    torch.testing.assert_close(rolled.tokens[:, : 16 - delta], st.tokens[:, delta:], rtol=0, atol=0)
    S = st.cache.k.shape[2]
    for a, b in ((rolled.cache.k, st.cache.k), (rolled.cache.v, st.cache.v)):
        torch.testing.assert_close(a[:, :, : S - delta], b[:, :, delta:], rtol=0, atol=0)
    assert rolled.start.tolist() == [P, 0] and rolled.start.dtype == torch.int32
    assert torch.equal(rolled.deadline, st.deadline - delta)
    final = cb.decode_stage(dec, CFG, rolled, 3, **kw)
    assert final.tokens[1, :8].tolist() == _solo(dec, prefixes[1], 8, -1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_int8_cache_slots(dec, dtype):
    """An int8 cache (under bf16 the #3 route's plain version, under fp32
    the plain formulation): admission splices the quantized rows and
    scales, and each request's tokens are its solo ``generate``'s with
    the same cache."""
    d = {k: v for k, v in dec.items()}
    d = {k: ([{n: t.to(dtype) for n, t in lp.items()} for lp in v] if k == "layers" else v.to(dtype))
         for k, v in d.items()}
    prefixes = _prefixes(3, seed=4)
    budgets = [6, 8, 5]
    sched = _scheduler(d, cache_dtype="int8", dtype=dtype)
    assert sched.state.window is not None and sched.state.cache.quantized
    rids = [sched.submit(p, b) for p, b in zip(prefixes, budgets)]
    got = sched.run_to_completion()
    want = [_solo(d, torch.from_numpy(p).to(dtype), b, -1, kv_cache_dtype="int8") for p, b in zip(prefixes, budgets)]
    assert [got[r] for r in rids] == want


def test_per_request_knobs(dec, monkeypatch):
    """Greedy rows take the argmax (their solo greedy tokens), sampled rows
    draw inside their own kept set (``warp_logits`` with the row's
    temperature and top_p), and one seed repeats every row."""
    draws = []
    sample = gen._sample_token

    def recorded(logits, **kw):
        tok = sample(logits, **kw)
        if not kw["greedy"]:
            draws.append((logits.clone(), kw["top_p"].clone(), kw["temperature"].clone(), tok.clone()))
        return tok

    monkeypatch.setattr(gen, "_sample_token", recorded)
    prefixes = _prefixes(3, seed=7)

    def run(seed):
        rng = torch.Generator()
        rng.manual_seed(seed)
        sched = _scheduler(dec, horizon=32, greedy=False, top_p=0.9, per_request=True, rng=rng)
        rids = [sched.submit(prefixes[0], 6, greedy=True), sched.submit(prefixes[1], 6, temperature=1.5, top_p=0.8),
                sched.submit(prefixes[2], 6)]
        got = sched.run_to_completion()
        return [got[r] for r in rids]

    first = run(3)
    assert first[0] == _solo(dec, prefixes[0], 6, -1)
    assert all(len(r) == 6 for r in first)
    assert draws
    for logits, top_p, temperature, tok in draws:
        kept = gen.warp_logits(logits.float(), top_p=top_p, temperature=temperature)
        assert bool(torch.isfinite(kept.gather(1, tok[:, None])).all())
    assert run(3) == first
    assert run(4)[1:] != first[1:]


def test_submit_refusals(dec):
    sched = _scheduler(dec)
    with pytest.raises(ValueError, match="exceeds horizon"):
        sched.submit(_prefixes(1)[0], 17)
    with pytest.raises(ValueError, match="per_request=True"):
        sched.submit(_prefixes(1)[0], 4, temperature=2.0)
    with pytest.raises(ValueError, match=r"prefix_embeds must be \(8, 64\)"):
        sched.submit(np.zeros((P + 1, CFG.hidden_size), np.float32), 4)
    knobs = _scheduler(dec, greedy=False, per_request=True)
    with pytest.raises(ValueError, match="below the supported"):
        knobs.submit(_prefixes(1)[0], 4, top_p=0.1)
    knobs.submit(_prefixes(1)[0], 4, top_p=0.1, greedy=True)  # a greedy row ignores top_p
    with pytest.raises(ValueError, match="no per-row top_k"):
        _scheduler(dec, per_request=True, top_k=5)
    with pytest.raises(ValueError, match="multiple of W"):
        _scheduler(dec, horizon=18)


def _write_wav(path, seed):
    """One second of noise at the front-end's rate (repeat-padded to the
    segment, no resampling)."""
    x = np.random.RandomState(seed).randn(TINY.frontend.sample_rate) * 0.1
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(TINY.frontend.sample_rate)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())
    return str(path)


@pytest.fixture
def engine_setup(tmp_path, monkeypatch):
    """The wrapper, two wavs, and ``encode_and_prefix`` patched to a seeded
    prefix chosen by each prompt's first id (so a row's prefix does not
    depend on its batch)."""
    bank = torch.from_numpy((np.random.RandomState(9).randn(4, TINY.prefix_length, CFG.hidden_size) * 0.5)
                            .astype(np.float32))
    monkeypatch.setattr(tmellow, "encode_and_prefix", lambda params, cfg, a1, a2, ids, **kw: bank[ids[:, 0] % 4])
    tw = TorchWrapper(TINY.name, "v0", "cpu", params=port_params_np(TINY), tokenizer=ByteTokenizer(),
                      use_native_audio=False)
    wavs = [_write_wav(tmp_path / f"{i}.wav", i) for i in range(2)]
    return tw, wavs


def test_engine_answers_as_the_wrapper(engine_setup):
    tw, (a, b) = engine_setup
    prompts = ["a caption", "b what changed?", "c speech?"]  # first ids 97, 98, 99: three prefixes
    lens = [6, 3, 9]
    want = [tw.generate([[a, b, p]], max_len=n, crop_start=0)[0] for p, n in zip(prompts, lens)]
    engine = ContinuousBatchingEngine(tw, slots=2, horizon=16, flush_window=W)
    try:
        futures = [engine.submit(a, b, p, max_len=n) for p, n in zip(prompts, lens)]
        got = [f.result(timeout=RESULT_S) for f in futures]
    finally:
        engine.shutdown()
    assert got == want
    assert all(len(s) > 0 for s in got)


def test_engine_fails_bad_requests_alone_and_at_once(engine_setup, monkeypatch):
    tw, (a, b) = engine_setup
    engine = ContinuousBatchingEngine(tw, slots=2, horizon=16, flush_window=W, per_request=True, seed=1)
    try:
        with pytest.raises(ValueError, match="outside"):
            engine.submit(a, b, "a", max_len=17)
        with pytest.raises(ValueError, match="top_p"):
            engine.submit(a, b, "a", max_len=4, sample=True, top_p=0.1)
        t = time.monotonic()
        bad = engine.submit(a, "missing.wav", "a x", max_len=4)
        good = [engine.submit(a, b, "a x", max_len=4), engine.submit(b, a, "b y", max_len=5, sample=True)]
        with pytest.raises(FileNotFoundError):
            bad.result(timeout=RESULT_S)
        assert [len(f.result(timeout=RESULT_S)) for f in good] == [4, 5]
        assert time.monotonic() - t < RESULT_S

        def broken(*args):
            raise RuntimeError("encoder failed")

        monkeypatch.setattr(tmellow, "encode_and_prefix", broken)
        batch = [engine.submit(a, b, p, max_len=4) for p in ("a", "b")]
        for f in batch:
            with pytest.raises(RuntimeError, match="encoder failed"):
                f.result(timeout=RESULT_S)
    finally:
        engine.shutdown()
