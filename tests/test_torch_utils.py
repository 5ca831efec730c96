"""The port's utilities against the JAX package's, on the CPU at the tiny
configuration: ``utils/roofline.py`` (the counts equal, the attention
FLOPs on the head dimension; the H100 peaks), ``utils/profiling.py``
(``trace``, ``annotate`` and the generate path's spans), ``utils/debug.py`` (the NaN/Inf tripwires),
``entry.py`` (the example arguments bit for bit; ``fn`` against JAX's),
and where the port builds its native libraries and which files its
package ships."""

import copy
import fnmatch
import json
import os
import re
import threading
import tomllib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import __graft_entry__ as jentry
from mellow_tpu import config as jconfig
from mellow_tpu.models import mellow as jmellow
from mellow_tpu.utils import roofline as jroof
from mellow_tpu_torch import config as tconfig
from mellow_tpu_torch import entry as tentry
from mellow_tpu_torch.models import generate as tgen
from mellow_tpu_torch.models import mellow as tmellow
from mellow_tpu_torch.models.params import params_from_jax
from mellow_tpu_torch.native import binding
from mellow_tpu_torch.ops import _build
from mellow_tpu_torch.serving import BatchingEngine
from mellow_tpu_torch.utils import debug, profiling
from mellow_tpu_torch.utils import roofline as troof
from mellow_tpu_torch.utils.build_dir import build_dir
from mellow_tpu_torch.wrapper import MellowWrapper
from tests.test_torch_e2e import _DistinctTokenizer, _write_wav
from tests.torch_port_common import TINY, port_params_np, waves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "mellow_tpu_torch")
DTYPES = ("float32", "bfloat16", "int8")


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["v0", "v0_s", TINY.name])
def test_roofline_counts_match_jax(name):
    """The matmul weights and the encoder's FLOPs equal JAX's; a decode
    step's bytes equal JAX's packed-cache (``fused_decode=True``) count for
    every (cache, weight) dtype pair; its FLOPs equal JAX's with the
    attention term on ``head_dim`` in place of the 128-lane padded KV row."""
    jc, tc = jconfig.get_config(name), tconfig.get_config(name)
    assert troof.decoder_matmul_params(tc.decoder) == jroof.decoder_matmul_params(jc.decoder)
    assert troof.encoder_flops(tc) == jroof.encoder_flops(jc)
    d = jc.decoder
    S = jc.prefix_length + 32
    for B in (1, 4):
        for cache in DTYPES:
            for weight in DTYPES:
                assert troof.decode_step_bytes(tc.decoder, B, S, cache, weight) == jroof.decode_step_bytes(
                    d, B, S, cache, weight, fused_decode=True), (B, cache, weight)
        padded = -(-d.num_kv_heads * d.head_dim // 128) * 128
        attn = 2 * 2 * d.num_layers * B * d.num_heads * S
        want = jroof.decode_step_flops(d, B, S) - attn * padded + attn * d.head_dim
        assert troof.decode_step_flops(tc.decoder, B, S) == want


def test_roofline_peaks_are_the_h100s():
    assert (troof.PEAK_BF16_FLOPS, troof.PEAK_INT8_OPS, troof.PEAK_FP32_FLOPS,
            troof.PEAK_HBM_BYTES) == (989e12, 1979e12, 67e12, 3.35e12)
    assert troof.pct(0.1234) == jroof.pct(0.1234) == "12.3%"


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

def _tiny_decode(max_len=3):
    params = params_from_jax(port_params_np(TINY), "cpu")
    prefix = torch.from_numpy(np.random.RandomState(3).randn(1, 6, TINY.decoder.hidden_size).astype(np.float32))
    return lambda: tgen.generate(params["decoder"], TINY.decoder, prefix, max_len=max_len, stop_token_id=-1)


def test_trace_writes_one_chrome_trace_with_annotations(tmp_path, monkeypatch):
    monkeypatch.delenv(profiling.ENV_VAR, raising=False)
    run = _tiny_decode()
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("x"):
            run()
    files = os.listdir(tmp_path)
    assert len(files) == 1 and re.fullmatch(rf"mellow_torch_{os.getpid()}_\d+\.json", files[0]), files
    with open(tmp_path / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "x" for e in events)
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_trace_from_the_environment_one_file_per_generate(tmp_path, monkeypatch):
    """``MELLOW_TORCH_PROFILE`` traces every ``MellowWrapper.generate``, each
    call into a file of its own."""
    monkeypatch.setenv(profiling.ENV_VAR, str(tmp_path / "traces"))
    a = _write_wav(tmp_path / "a.wav", 1.0, 1)
    w = MellowWrapper(TINY.name, "v0", "cpu", params=port_params_np(TINY), tokenizer=_DistinctTokenizer(),
                      use_native_audio=False)
    for _ in range(2):
        w.generate([[a, a, "x"]], max_len=2)
    files = sorted(os.listdir(tmp_path / "traces"))
    assert len(files) == 2 and files[0] != files[1]
    for name in files:
        with open(tmp_path / "traces" / name) as f:
            assert json.load(f)["traceEvents"]


def test_trace_without_a_directory_makes_no_profiler(tmp_path, monkeypatch):
    monkeypatch.delenv(profiling.ENV_VAR, raising=False)
    monkeypatch.chdir(tmp_path)

    def refuse(*args, **kwargs):
        raise AssertionError("a profiler was created")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    with profiling.trace():
        _tiny_decode()()
    assert os.listdir(tmp_path) == []


def test_trace_inside_another_profiler_raises(tmp_path, monkeypatch):
    monkeypatch.delenv(profiling.ENV_VAR, raising=False)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as outer:
        with pytest.raises(RuntimeError, match="another torch.profiler session"):
            with profiling.trace(str(tmp_path)):
                pass
        torch.ones(4).sum()
    assert os.listdir(tmp_path) == []
    assert any(e.name == "aten::sum" for e in outer.events())


SPANS = {"mellow.generate_tokens": 1, "mellow.encode": 2, "mellow.prefix": 1, "mellow.prefill": 1,
         "mellow.decode_window": 1, "mellow.token_choice": 4, "mellow.decode_step": 3}


@pytest.fixture(scope="module")
def tiny_call():
    """One B=1 ``generate_tokens`` call at ``max_len`` 4 (one window of 4
    token choices and 3 decode steps) on the tiny config, made under a CPU
    ``torch.profiler`` session -> (the call, its result, its ``mellow.*``
    spans as (name, start ns, end ns))."""
    params = params_from_jax(port_params_np(TINY), "cpu")
    cfg = tconfig.get_config(TINY.name)
    a1, a2 = torch.from_numpy(waves(1, 11)), torch.from_numpy(waves(1, 12))
    ids = torch.tensor([[5, 9, 17, 3, 1, 1, 1, 1]])
    call = lambda: tmellow.generate_tokens(params, cfg, a1, a2, ids, max_len=4)  # noqa: E731
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        result = call()
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events() if e.name().startswith("mellow.")]
    return call, result, spans


def test_generate_tokens_records_its_spans_under_a_profiler(tiny_call):
    """Under a CPU ``torch.profiler`` session the call records each span of
    the generate path once per layer boundary crossed, and at least one
    host sync, every one inside the call's root span."""
    _, _, spans = tiny_call
    names = [n for n, _, _ in spans]
    assert {n: names.count(n) for n in SPANS} == SPANS
    assert names.count("mellow.host_sync") >= 1
    (root,) = [(s, e) for n, s, e in spans if n == "mellow.generate_tokens"]
    assert all(root[0] <= s <= e <= root[1] for _, s, e in spans)


def test_spans_build_no_record_function_without_a_profiler(tiny_call, monkeypatch):
    """With no profiler session ``annotate`` hands back a null context: no
    range (``record_function`` or the function range a span is) is built,
    and the tokens are the profiled call's."""
    call, want, _ = tiny_call

    def refuse(*args, **kwargs):
        raise AssertionError("a profiler range was built")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_RANGE", refuse)
    got = call()
    assert torch.equal(got.tokens, want.tokens) and got.num_steps == want.num_steps == 4
    with profiling.annotate("mellow.x") as ctx:
        assert ctx is None


# ---------------------------------------------------------------------------
# debug
# ---------------------------------------------------------------------------

@pytest.fixture
def tripwire():
    """Leaves the tripwires off whatever the test did."""
    yield debug
    debug.disable_debug()


def _overflow_wrapper(dtype):
    """The tiny wrapper with stage 1's first qkv kernel at +-1e38: the
    block's first product reading it overflows."""
    tree = copy.deepcopy(port_params_np(TINY))
    qkv = tree["encoder"]["stages"][0]["blocks"][0]["qkv"]
    qkv["kernel"] = np.sign(qkv["kernel"]) * np.float32(1e38)
    return MellowWrapper(TINY.name, "v0", "cpu", params=tree, tokenizer=_DistinctTokenizer(),
                         use_native_audio=False, compute_dtype=dtype)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_tripwire_names_the_overflowing_product(tmp_path, tripwire, dtype):
    """With both tripwires on, the qkv product (``aten.mm``) raises for its
    Inf; with ``infs=False`` it goes through and the first NaN that follows
    from it raises instead; after ``disable_debug`` the call returns."""
    a = _write_wav(tmp_path / "a.wav", 1.0, 1)
    w = _overflow_wrapper(dtype)
    tripwire.enable_debug()
    with pytest.raises(FloatingPointError, match=r"^aten\.mm\.default produced Inf$"):
        w.generate([[a, a, "x"]], max_len=2)
    tripwire.enable_debug(infs=False)
    with pytest.raises(FloatingPointError, match=r"produced NaN$") as err:
        w.generate([[a, a, "x"]], max_len=2)
    assert not str(err.value).startswith("aten.mm.")
    tripwire.disable_debug()
    assert len(w.generate([[a, a, "x"]], max_len=2)) == 1


def test_tripwire_raises_at_the_first_op_reading_a_nan(tripwire):
    """A NaN planted in a clip: the first operation that reads it (the
    log-mel's reflect padding) raises; with ``nans=False`` the call
    returns. A direct model call is checked inside ``debug.checking()``."""
    params = params_from_jax(port_params_np(TINY), "cpu")
    a1, a2 = torch.from_numpy(waves(1, 1)), torch.from_numpy(waves(1, 2))
    a1[0, 1000] = float("nan")
    ids = torch.from_numpy(np.random.RandomState(4).randint(2, 500, (1, TINY.text_tokenization_len)))

    def call():
        with debug.checking():
            return tmellow.generate_tokens(params, TINY, a1, a2, ids, max_len=2)

    tripwire.enable_debug()
    with pytest.raises(FloatingPointError, match=r"^aten\.reflection_pad1d\.default produced NaN$"):
        call()
    tripwire.enable_debug(nans=False)
    assert call().tokens.shape == (1, 2)


def test_tripwire_kinds_and_handed_infs(tripwire):
    """Inf from finite values and NaN raise, each only while its tripwire
    is on; an Inf handed in (a -inf mask fill) or carried from an input
    does not; a kernel wrapper's output check names the wrapper."""
    big = torch.tensor([3e38, 1.0])
    mask = torch.tensor([True, False])
    tripwire.enable_debug()
    with debug.checking():
        with pytest.raises(FloatingPointError, match="aten.mul.Tensor produced Inf"):
            big * 2
        with pytest.raises(FloatingPointError, match="aten.div.Tensor produced NaN"):
            torch.zeros(2) / torch.zeros(2)
        masked = torch.zeros(2).masked_fill(mask, float("-inf"))
        assert torch.isinf(masked + 1).any()
    with pytest.raises(FloatingPointError, match="^swin_block_cuda: the kernel's output holds NaN$"):
        debug.check_outputs("swin_block_cuda", torch.tensor([float("nan")]))
    tripwire.enable_debug(infs=False)
    with debug.checking():
        assert torch.isinf(big * 2).any()
    tripwire.enable_debug(nans=False)
    with debug.checking():
        assert torch.isnan(torch.zeros(2) / torch.zeros(2)).all()
    debug.check_outputs("swin_block_cuda", torch.tensor([float("nan")]))
    tripwire.disable_debug()
    with debug.checking():
        big * 2
    debug.check_outputs("swin_block_cuda", torch.tensor([float("inf")]))


def test_tripwire_covers_the_batching_engines_worker_thread(tmp_path, tripwire):
    """The switch is process-wide: a request through ``BatchingEngine`` (its
    worker thread runs ``generate``) raises for the overflow; a thread
    outside the port's entry points and ``checking()`` is not checked."""
    a = _write_wav(tmp_path / "a.wav", 1.0, 1)
    w = _overflow_wrapper(None)
    tripwire.enable_debug()
    engine = BatchingEngine(w, dynamic_batch=False)
    try:
        future = engine.submit(a, a, "x", max_len=2)
        with pytest.raises(FloatingPointError, match=r"^aten\.mm\.default produced Inf$"):
            future.result(timeout=60)
    finally:
        engine.shutdown()
    out = []
    t = threading.Thread(target=lambda: out.append(torch.tensor([3e38]) * 2))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and torch.isinf(out[0]).all()


def test_tripwire_passes_a_clean_bf16_request(tmp_path, tripwire):
    a = _write_wav(tmp_path / "a.wav", 1.0, 1)
    b = _write_wav(tmp_path / "b.wav", 2.0, 2)
    w = MellowWrapper(TINY.name, "v0", "cpu", params=port_params_np(TINY), tokenizer=_DistinctTokenizer(),
                      use_native_audio=False, compute_dtype="bfloat16")
    plain = w.generate([[a, b, "x"]], max_len=4)
    tripwire.enable_debug()
    assert w.generate([[a, b, "x"]], max_len=4) == plain


# ---------------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------------

def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == jnp.bfloat16 else x


def test_entry_example_args_equal_jax_bit_for_bit(monkeypatch):
    """v0's example arguments (two bf16 clips, 129 text ids, 16 answer
    ids) equal the JAX entry's bit for bit. Both inits are stubbed: the
    arguments do not depend on the weights."""
    tiny = port_params_np(TINY)
    monkeypatch.setattr(jmellow, "init_params", lambda *a, **k: None)
    monkeypatch.setattr(tmellow, "init_params", lambda cfg, seed: tiny)
    _, jargs = jentry.entry()
    _, targs = tentry.entry("cpu")
    assert [tuple(t.shape) for t in targs[1:]] == [(1, 320000), (1, 320000), (1, 129), (1, 16)]
    assert [t.dtype for t in targs[1:]] == [torch.bfloat16, torch.bfloat16, torch.int64, torch.int64]
    for j, t in zip(jargs[1:], targs[1:]):
        np.testing.assert_array_equal(_bits(t), _bits(j))


def test_entry_fn_matches_jax_at_tiny(monkeypatch):
    """``fn`` at the tiny config against the JAX entry's ``fn`` on the same
    bf16 weights, clips and ids (drawn below the tiny vocabulary): the
    logits (1, 268 + 16, 512) within 5e-2 x max|JAX|, the bf16 prefill
    logits' tolerance of tests/test_torch_bf16.py. The decoder is left at
    its init scale: with test_torch_bf16's 10x decoder both packages' bf16
    forwards lie 0.24-0.28 x max from JAX's fp32 one."""
    tree = port_params_np(TINY, scaled=False)
    tiny = tconfig.get_config(TINY.name)
    monkeypatch.setattr(jconfig, "get_config", lambda name: TINY)
    monkeypatch.setattr(jmellow, "init_params", lambda *a, **k: None)
    monkeypatch.setattr(tconfig, "get_config", lambda name: tiny)
    jfn, jargs = jentry.entry()
    tfn, targs = tentry.entry("cpu")
    rng = np.random.RandomState(5)
    text = rng.randint(2, TINY.decoder.vocab_size, (1, TINY.text_tokenization_len))
    answers = rng.randint(2, TINY.decoder.vocab_size, (1, tentry.ANSWER_LEN))
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    theirs = jax.jit(jfn)(jp, jargs[1], jargs[2], jnp.asarray(text, jnp.int32), jnp.asarray(answers, jnp.int32))
    theirs = np.asarray(theirs.astype(jnp.float32))
    ours = tfn(params_from_jax(tree, "cpu", torch.bfloat16), targs[1], targs[2], torch.from_numpy(text),
               torch.from_numpy(answers))
    assert ours.dtype == torch.bfloat16
    ours = ours.float().numpy()
    assert ours.shape == theirs.shape == (1, TINY.prefix_length + 16, TINY.decoder.vocab_size)
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, theirs, atol=5e-2 * np.abs(theirs).max(), rtol=0)


def test_entry_reexports_the_dry_run():
    from mellow_tpu_torch.parallel.dryrun import dryrun_multichip

    assert tentry.dryrun_multichip is dryrun_multichip


# ---------------------------------------------------------------------------
# build directory and package data
# ---------------------------------------------------------------------------

def test_build_dir_in_a_checkout_and_installed(tmp_path, monkeypatch):
    """A checkout builds into its git-ignored ``build/mellow_tpu_torch``; a
    package laid out elsewhere into ``$XDG_CACHE_HOME/mellow_tpu_torch``,
    else ``~/.cache/mellow_tpu_torch``. Both libraries use the same one."""
    here = os.path.join(REPO, "build", "mellow_tpu_torch")
    assert build_dir() == _build.BUILD_DIR == binding._BUILD_DIR == here
    assert os.path.dirname(_build.LIB_PATH) == os.path.dirname(binding._LIB_PATH) == here
    pkg = tmp_path / "site-packages" / "mellow_tpu_torch"
    pkg.mkdir(parents=True)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert build_dir(str(pkg)) == str(tmp_path / "cache" / "mellow_tpu_torch")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    for unset in ("", "relative/cache"):
        monkeypatch.setenv("XDG_CACHE_HOME", unset)
        assert build_dir(str(pkg)) == str(tmp_path / "home" / ".cache" / "mellow_tpu_torch")


def test_package_data_ships_every_build_input():
    """Every source ``ops/_build.py`` compiles, every header those include,
    the audio runtime's source and the shipped config match a package-data
    glob of pyproject.toml."""
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"]["mellow_tpu_torch"]
    sources, headers = _build._sources(), _build._headers()
    assert len(sources) == 10 and headers
    included = set()
    for path in sources + headers:
        with open(path) as f:
            included |= set(re.findall(r'^\s*#include\s+"([^"]+)"', f.read(), re.M))
    assert included and {os.path.join(_build.CSRC_DIR, h) for h in included} <= set(headers)
    shipped = sources + headers + [os.path.join(PKG, "native", "src", "audio.cc"),
                                   os.path.join(PKG, "configs", "v0.yaml")]
    for path in shipped:
        assert os.path.exists(path), path
        rel = os.path.relpath(path, PKG)
        assert any(fnmatch.fnmatch(rel, g) for g in globs), rel
