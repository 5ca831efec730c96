"""The bf16 decode step as a CUDA graph (``llama.DecodeWorkspace``).

On the CPU (fast, no JAX): which steps take the graph and which stay eager,
counted by ``utils.metrics.GLOBAL``'s ``decode_graph_captures``,
``decode_graph_replays`` and ``decode_eager_steps``; and a rehearsal of the
graph path itself, with ``llama.on_card`` true for CPU tensors, #2's
device-length launch by its plain version, and a "capture" that runs the
captured body eagerly at each replay, held against the eager step.

On the card (marker ``cuda``, skipped here): the captured graph at v0's
decoder widths against the eager step on a fresh cache (bit for bit where
#2 splits as the host length does; elsewhere, at the port's init scale,
within #2's tolerance), against its own body run eagerly, its reuse across
calls, a workspace left full of NaN between calls, and a second weight set.

    python -m pytest --noconftest -o addopts="" tests/test_torch_decode_graph.py
"""

import inspect
from collections import OrderedDict

import pytest
import torch
import torch.distributed as dist

from mellow_tpu_torch.config import LlamaConfig
from mellow_tpu_torch.models import generate as gen
from mellow_tpu_torch.models import gpt2, llama
from mellow_tpu_torch.models.params import params_from_jax
from mellow_tpu_torch.ops import decode_attention as da
from mellow_tpu_torch.parallel import tensor as tpar
from mellow_tpu_torch.utils.metrics import GLOBAL as metrics

COUNTERS = ("decode_graph_captures", "decode_graph_replays", "decode_eager_steps")
TINY = LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
                   num_kv_heads=2, head_dim=16)
BF16 = torch.bfloat16


def _decoder(cfg: LlamaConfig, seed: int, device="cpu", dtype=BF16) -> dict:
    """Seeded llama weights: layer kernels N(0, 2 / sqrt(D)), norms 1 + N(0,
    2 / sqrt(D)), the (tied) embedding N(0, 1): the greedy tokens change from
    step to step (with smaller kernels each row repeats its token)."""
    g = torch.Generator(device=device).manual_seed(seed)
    D, I, H, KV, hd = cfg.hidden_size, cfg.intermediate_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    scale = 2 / D ** 0.5

    def w(*shape, std=scale, mean=0.0):
        return (torch.randn(*shape, generator=g, device=device) * std + mean).to(dtype)

    shapes = {"wq": (D, H * hd), "wk": (D, KV * hd), "wv": (D, KV * hd), "wo": (H * hd, D),
              "w_gate": (D, I), "w_up": (D, I), "w_down": (I, D)}
    layers = [{"ln_attn": w(D, mean=1.0), "ln_mlp": w(D, mean=1.0), **{k: w(*s) for k, s in shapes.items()}}
              for _ in range(cfg.num_layers)]
    return {"embed": w(cfg.vocab_size, D, std=1.0), "layers": layers, "norm_f": w(D, mean=1.0)}


def _prefix(B: int, P: int, D: int, seed: int, device="cpu", dtype=BF16) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(B, P, D, generator=g, device=device).to(dtype)


def _counts() -> dict:
    return {c: metrics.counters.get(c, 0.0) for c in COUNTERS}


def _delta(before: dict) -> dict:
    now = _counts()
    return {c: now[c] - before[c] for c in COUNTERS}


def _generate(monkeypatch, params, cfg, prefix, max_len: int, **kw):
    """greedy ``generate`` with no stop token -> (tokens, the cache its decode
    steps were handed, the counters' change)."""
    seen = {}
    step = llama.decode_step

    def recorded(params, cfg, token_embed, cache, *args, **kwargs):
        seen["cache"] = cache
        return step(params, cfg, token_embed, cache, *args, **kwargs)

    monkeypatch.setattr(llama, "decode_step", recorded)
    before = _counts()
    try:
        res = gen.generate(params, cfg, prefix, max_len=max_len, stop_token_id=-1, **kw)
    finally:
        monkeypatch.setattr(llama, "decode_step", step)
    return res.tokens, seen.get("cache"), _delta(before)


def _held(params, cfg, prefix, max_len: int):
    """The workspace of ``generate``'s call on ``prefix`` held by another
    call: inside it ``generate`` decodes eagerly on a fresh cache."""
    B, P, _ = prefix.shape
    W = gen.effective_window(None, max_len, B)
    return llama.decode_workspace(params, cfg, B, P + -(-max_len // W) * W, prefix.device, prefix.dtype)


# ---------------------------------------------------------------------------
# the CPU: eligibility and a rehearsal of the graph path
# ---------------------------------------------------------------------------


class _EagerGraph:
    """A stand-in for a captured graph: each replay runs the body again."""

    def __init__(self, ws, params):
        self.ws, self.params = ws, params

    def replay(self):
        self.ws.out.copy_(self.ws._body(self.params))


@pytest.fixture
def workspaces(monkeypatch):
    """An empty workspace table for the test."""
    monkeypatch.setattr(llama, "_WORKSPACES", OrderedDict())
    return llama._WORKSPACES


@pytest.fixture
def rehearsal(monkeypatch, workspaces):
    monkeypatch.setattr(llama, "on_card", lambda t: True)
    monkeypatch.setattr(llama, "decode_attention_cuda_at",
                        lambda q, k, v, n: da.decode_attention_plain(q, k, v, int(n)))
    monkeypatch.setattr(llama.DecodeWorkspace, "_warm_up", lambda ws, params: ws._body(params))
    monkeypatch.setattr(llama.DecodeWorkspace, "_record",
                        lambda ws, params: (_EagerGraph(ws, params), ws._body(params)))
    return workspaces


def test_decode_step_keeps_its_signature():
    assert {"pos", "cache", "window"} <= set(inspect.signature(llama.decode_step).parameters)


def test_rehearsed_graph_gives_the_eager_tokens_and_cache(monkeypatch, rehearsal):
    """9 steps over two flush windows (8 and 2 tokens) of 3 rows in the
    workspace of 4 (``batch_bucket``): the rehearsed graph path's tokens
    and written cache rows equal the eager step's on a fresh cache bit for
    bit; one capture, then only replays, also in a second call."""
    params, prefix = _decoder(TINY, 0), _prefix(3, 5, TINY.hidden_size, 1)
    tokens, cache, first = _generate(monkeypatch, params, TINY, prefix, 10)
    assert first == {"decode_graph_captures": 1, "decode_graph_replays": 9, "decode_eager_steps": 0}
    ws = next(iter(rehearsal.values()))
    assert ws.x.shape[0] == 4 and cache.k.shape[1] == 3
    assert cache is ws.cache and ws.owner is None
    with _held(params, TINY, prefix, 10) as held:
        assert held is ws
        ref_tokens, ref_cache, eager = _generate(monkeypatch, params, TINY, prefix, 10)
    assert eager == {"decode_graph_captures": 0, "decode_graph_replays": 0, "decode_eager_steps": 9}
    assert ref_cache is not ws.cache
    assert torch.equal(tokens, ref_tokens) and len(set(tokens[0].tolist())) > 1
    written = 5 + 9
    assert torch.equal(cache.k[:, :, :written], ref_cache.k[:, :, :written])
    assert torch.equal(cache.v[:, :, :written], ref_cache.v[:, :, :written])
    again, _, second = _generate(monkeypatch, params, TINY, prefix, 10)
    assert second == {"decode_graph_captures": 0, "decode_graph_replays": 9, "decode_eager_steps": 0}
    assert torch.equal(again, tokens)


def test_rehearsed_batches_of_one_bucket_share_a_capture(monkeypatch, rehearsal):
    """Batches of 5 to 8 rows decode in one workspace of 8, captured once."""
    params = _decoder(TINY, 0)
    counts = [_generate(monkeypatch, params, TINY, _prefix(B, 4, TINY.hidden_size, B), 3)[2] for B in (5, 8, 6)]
    assert [c["decode_graph_captures"] for c in counts] == [1, 0, 0]
    assert all(c["decode_graph_replays"] == 2 for c in counts)
    assert [k[1] for k in rehearsal] == [8]


def test_rehearsed_workspace_full_of_nan_gives_the_same_tokens(monkeypatch, rehearsal):
    """The workspace is never zeroed: the prefill writes [0, P) and each step
    its position before #2 reads it."""
    params, prefix = _decoder(TINY, 0), _prefix(2, 6, TINY.hidden_size, 2)
    tokens, cache, _ = _generate(monkeypatch, params, TINY, prefix, 7)
    cache.k.fill_(float("nan"))
    cache.v.fill_(float("nan"))
    again, _, counts = _generate(monkeypatch, params, TINY, prefix, 7)
    assert counts["decode_graph_replays"] == 6 and torch.equal(again, tokens)


def test_rehearsed_second_weight_set_gets_its_own_capture(monkeypatch, rehearsal):
    prefix = _prefix(2, 4, TINY.hidden_size, 3)
    _, _, first = _generate(monkeypatch, _decoder(TINY, 0), TINY, prefix, 3)
    _, _, other = _generate(monkeypatch, _decoder(TINY, 1), TINY, prefix, 3)
    assert first["decode_graph_captures"] == other["decode_graph_captures"] == 1
    assert len(rehearsal) == 2


def _keyed_call(monkeypatch, params) -> dict:
    """One decode step of 2 rows on ``params``, whose weights key the
    workspace: the counters' change."""
    return _generate(monkeypatch, params, TINY, _prefix(2, 3, TINY.hidden_size, 6), 2)[2]


def _key_weights(params) -> tuple:
    return tuple(t.data_ptr() for t in llama._step_weights(params))


def test_workspaces_kept_are_bounded(monkeypatch, rehearsal):
    """Past ``WORKSPACES`` keys, a new key decodes eagerly while every kept
    workspace was used in the last ``IDLE_CALLS`` calls: cycling more keys
    than that captures each kept key once, not at every call. A workspace
    unused for longer makes room for the next new key."""
    sets = [_decoder(TINY, i) for i in range(llama.WORKSPACES + 3)]
    cycled = sets[:-1]  # WORKSPACES + 2 weight sets
    for round_ in range(2):
        counts = [_keyed_call(monkeypatch, p) for p in cycled]
        assert [c["decode_graph_replays"] for c in counts] == [1] * llama.WORKSPACES + [0] * 2
        assert [c["decode_eager_steps"] for c in counts] == [0] * llama.WORKSPACES + [1] * 2
        assert sum(c["decode_graph_captures"] for c in counts) == (llama.WORKSPACES if round_ == 0 else 0)
    assert len(rehearsal) == llama.WORKSPACES
    monkeypatch.setattr(llama, "IDLE_CALLS", 2)
    for _ in range(3):
        _keyed_call(monkeypatch, sets[1])
    new = _keyed_call(monkeypatch, sets[-1])
    assert new["decode_graph_captures"] == 1 and len(rehearsal) == llama.WORKSPACES
    kept = {k[5] for k in rehearsal}
    # the least recently used, set 0, went
    assert _key_weights(sets[0]) not in kept and {_key_weights(sets[1]), _key_weights(sets[-1])} <= kept


class _Refused(RuntimeError):
    """A CUDA error as torch raises it (``AcceleratorError``): the capture
    invalidated."""
    error_code = 901


@pytest.mark.parametrize("error", ["refused", "other"])
def test_only_a_refused_capture_leaves_the_workspace_eager(monkeypatch, rehearsal, error):
    """CUDA's refusal of the capture (``llama.CAPTURE_REFUSED``) leaves the
    workspace's steps eager, with a warning and the eager tokens; any other
    error in the capture raises."""
    params, prefix = _decoder(TINY, 0), _prefix(2, 4, TINY.hidden_size, 5)

    def record(ws, params):
        raise _Refused("operation failed due to a previous error during capture") if error == "refused" \
            else RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(llama.DecodeWorkspace, "_record", record)
    if error == "other":
        with pytest.raises(RuntimeError, match="illegal memory access"):
            _generate(monkeypatch, params, TINY, prefix, 4)
        return
    with pytest.warns(RuntimeWarning, match="not captured"):
        tokens, _, counts = _generate(monkeypatch, params, TINY, prefix, 4)
    assert counts == {"decode_graph_captures": 0, "decode_graph_replays": 0, "decode_eager_steps": 3}
    assert next(iter(rehearsal.values())).eager
    with _held(params, TINY, prefix, 4):
        ref = _generate(monkeypatch, params, TINY, prefix, 4)[0]
    assert torch.equal(tokens, ref)


def _tp_world(tmp_path):
    """A one-rank gloo group (a file rendezvous): the TP forms at size 1."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", world_size=1, rank=0)
    return tpar.TP(group=dist.group.WORLD, size=1, rank=0, heads=True)


CASES = ("cpu", "fp32", "int8_cache", "fp16_cache", "start", "tp", "gpt2", "compacted")


@pytest.mark.parametrize("case", CASES)
def test_ineligible_steps_run_eager(monkeypatch, workspaces, tmp_path, case):
    """Each of these decodes every step eagerly, counted in
    ``decode_eager_steps``: CPU tensors (``on_card`` as it is); under the
    rehearsal's ``on_card``, fp32, an int8 cache, a float cache in another
    dtype, a ``start``, ``tp``, the gpt2 family, and a cascade stage after a
    compaction."""
    if case != "cpu":
        monkeypatch.setattr(llama, "on_card", lambda t: True)
    params, prefix = _decoder(TINY, 0), _prefix(4, 4, TINY.hidden_size, 4)
    before = _counts()
    steps = 5
    if case in ("cpu", "fp32", "int8_cache", "fp16_cache"):
        kw = {"int8_cache": {"kv_cache_dtype": "int8"}, "fp16_cache": {"kv_cache_dtype": "float16"}}.get(case, {})
        if case == "fp32":
            params, prefix = _decoder(TINY, 0, dtype=torch.float32), prefix.float()
        gen.generate(params, TINY, prefix, max_len=steps + 1, stop_token_id=-1, **kw)
    elif case == "start":
        with llama.decode_workspace(params, TINY, 4, 4 + steps, "cpu", BF16) as ws:
            start = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
            for pos in range(4, 4 + steps):
                llama.decode_step(params, TINY, params["embed"][:4], ws.cache, pos, ws.cos, ws.sin, start=start)
    elif case == "tp":
        tp = _tp_world(tmp_path)
        try:
            with gen._workspace(params, TINY, prefix, max_len=steps + 1, W=8, kv_cache_dtype=None,
                                family="llama", tp=tp) as ws:
                assert ws is None
            gen.generate(params, TINY, prefix, max_len=steps + 1, stop_token_id=-1, tp=tp)
        finally:
            dist.destroy_process_group()
    elif case == "gpt2":
        cfg = gpt2.GPT2Config(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4, max_position_embeddings=64)
        p = params_from_jax({"decoder": gpt2.init_params(cfg, 0)}, "cpu", BF16)["decoder"]
        gen.generate(p, cfg, prefix, max_len=steps + 1, stop_token_id=-1, family="gpt2")
    else:  # three of four rows start done: the cascade compacts to one row before its first window
        res = gen.generate_cascade(params, TINY, prefix, max_len=steps + 1, stop_token_id=-1, min_batch=1,
                                   initial_done=torch.tensor([False, True, True, True]))
        assert res.num_steps == steps + 1
    assert _delta(before) == {"decode_graph_captures": 0, "decode_graph_replays": 0, "decode_eager_steps": steps}
    if case in ("cpu", "fp32", "int8_cache", "fp16_cache", "tp", "gpt2"):
        assert not workspaces


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

V0 = LlamaConfig()  # SmolLM2-135M: v0's decoder widths
P0 = 389  # v0's prefix


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(a, b, tol: float = 2e-2):
    """Within #2's stated tolerance: 2e-2 x max|b|."""
    err = (a.float() - b.float()).abs().max().item()
    assert err <= tol * b.float().abs().max().item(), err


@pytest.mark.cuda
def test_graph_step_matches_the_eager_step(monkeypatch, device):
    """B = 128 at max_len 4 (S_max 393, where #2's split is 9 blocks of 44
    positions either way): the graph's tokens and written cache rows equal
    the eager step's on a fresh cache bit for bit."""
    B, max_len = 128, 4
    params = _decoder(V0, 0, device)
    prefix = _prefix(B, P0, V0.hidden_size, 1, device)
    tokens, cache, counts = _generate(monkeypatch, params, V0, prefix, max_len)
    steps = max_len - 1
    assert counts["decode_graph_replays"] == steps and counts["decode_eager_steps"] == 0
    with _held(params, V0, prefix, max_len) as held:
        assert held is not None and cache is held.cache
        ref_tokens, ref_cache, eager = _generate(monkeypatch, params, V0, prefix, max_len)
    assert eager["decode_eager_steps"] == steps and eager["decode_graph_replays"] == 0
    assert torch.equal(tokens, ref_tokens)
    written = P0 + steps
    assert torch.equal(cache.k[:, :, :written], ref_cache.k[:, :, :written])
    assert torch.equal(cache.v[:, :, :written], ref_cache.v[:, :, :written])


def _init_decoder(cfg: LlamaConfig, seed: int, device) -> dict:
    """bf16 llama weights at the port's init scale (``models/mellow.init_params``):
    kernels and the (tied) embedding N(0, 0.02), norms one."""
    params = _decoder(cfg, seed, device)
    g = torch.Generator(device=device).manual_seed(seed)
    for leaf in [params["embed"], params["norm_f"]] + [w for lp in params["layers"] for w in lp.values()]:
        if leaf.ndim == 1:
            leaf.fill_(1.0)
        else:
            leaf.copy_(torch.randn(leaf.shape, generator=g, device=device) * 0.02)
    return params


@pytest.mark.cuda
@pytest.mark.parametrize("B", [8, 5])
def test_graph_step_holds_the_host_length_step_where_the_split_differs(device, B):
    """19 steps at S_max 413 (max_len 20: three flush windows of 8), where
    #2's split of 413 positions differs from the host length's, at the
    port's init scale: each replayed step's hidden and logits stay within
    #2's tolerance of the eager step (#2 with its length on the host), both
    fed the eager path's greedy tokens and starting from the same cache (the
    eager step's row copied into the workspace after each step, so each
    comparison is one step's, not the drift of two caches). The workspace
    starts full of NaN: a read past what the prefill and the steps wrote
    would show. B = 5 decodes in the first 5 rows of the workspace of 8."""
    max_len = 20
    W = gen.effective_window(None, max_len, B)
    S = P0 + -(-max_len // W) * W
    assert S == 413
    params = _init_decoder(V0, 0, device)
    prefix = _prefix(B, P0, V0.hidden_size, 1, device) * 0.02
    cache = llama.KVCache.create(V0, B, S, device, BF16)
    cos, sin = llama.rope_device_tables(V0, S, BF16, device)
    before = _counts()
    with torch.no_grad(), llama.decode_workspace(params, V0, B, S, device, BF16) as ws:
        assert ws.x.shape[0] == 8
        ws.kv.k.fill_(float("nan"))
        ws.kv.v.fill_(float("nan"))
        h = llama.prefill(params, V0, prefix, cache)
        assert torch.equal(h, llama.prefill(params, V0, prefix, ws.cache))
        for t in range(max_len - 1):
            emb = params["embed"][llama.logits_from_hidden(params, V0, h).argmax(-1)]
            h = llama.decode_step(params, V0, emb, cache, P0 + t, cos, sin)
            g = llama.decode_step(params, V0, emb, ws.cache, P0 + t, ws.cos, ws.sin)
            assert torch.isfinite(g).all(), t
            _close(g, h)
            _close(llama.logits_from_hidden(params, V0, g), llama.logits_from_hidden(params, V0, h))
            ws.cache.k[:, :, P0 + t].copy_(cache.k[:, :, P0 + t])
            ws.cache.v[:, :, P0 + t].copy_(cache.v[:, :, P0 + t])
    counts = _delta(before)
    assert counts["decode_graph_replays"] == max_len - 1 and counts["decode_eager_steps"] == max_len - 1


@pytest.mark.cuda
def test_graph_replays_its_body_where_the_split_differs(device):
    """B = 8, 19 steps through one graph at S_max 413 (max_len 20: three
    flush windows of 8), where #2's split of 413 positions differs from the
    host length's: each replay equals the same body run eagerly on a second
    workspace bit for bit, both fed the graph's greedy tokens, and so do the
    cache rows. #2 at such a split is held within its tolerance of the host
    length by ``tests/test_torch_kernels.py``; the whole step is not held to
    the host-length step: at these random weights one bf16 ulp of noise in
    #2's output grows to several percent of the logits over 30 layers."""
    B, max_len = 8, 20
    W = gen.effective_window(None, max_len, B)
    S = P0 + -(-max_len // W) * W
    assert S == 413
    params = _decoder(V0, 0, device)
    prefix = _prefix(B, P0, V0.hidden_size, 1, device)
    twin = llama.DecodeWorkspace(V0, B, S, device, BF16)
    before = _counts()
    with torch.no_grad(), llama.decode_workspace(params, V0, B, S, device, BF16) as ws:
        h = llama.prefill(params, V0, prefix, ws.cache)
        assert torch.equal(h, llama.prefill(params, V0, prefix, twin.cache))
        for t in range(max_len - 1):
            emb = params["embed"][llama.logits_from_hidden(params, V0, h).argmax(-1)]
            h = llama.decode_step(params, V0, emb, ws.cache, P0 + t, ws.cos, ws.sin)
            twin.x.copy_(emb)
            twin.pos.fill_(P0 + t)
            assert torch.equal(h, twin._body(params)), t
        written = P0 + max_len - 1
        assert torch.equal(ws.cache.k[:, :, :written], twin.cache.k[:, :, :written])
        assert torch.equal(ws.cache.v[:, :, :written], twin.cache.v[:, :, :written])
    counts = _delta(before)
    assert counts["decode_graph_replays"] == max_len - 1 and counts["decode_eager_steps"] == 0


@pytest.mark.cuda
def test_graph_is_captured_once_and_survives_nan(monkeypatch, device):
    """A second call replays without a new capture; a workspace filled with
    NaN between calls gives the same tokens."""
    params = _decoder(V0, 0, device)
    prefix = _prefix(16, P0, V0.hidden_size, 2, device)
    tokens, cache, _ = _generate(monkeypatch, params, V0, prefix, 6)
    again, _, second = _generate(monkeypatch, params, V0, prefix, 6)
    assert second == {"decode_graph_captures": 0, "decode_graph_replays": 5, "decode_eager_steps": 0}
    assert torch.equal(again, tokens)
    cache.k.fill_(float("nan"))
    cache.v.fill_(float("nan"))
    third, _, _ = _generate(monkeypatch, params, V0, prefix, 6)
    assert torch.equal(third, tokens)


@pytest.mark.cuda
def test_second_weight_set_gets_its_own_capture(monkeypatch, device):
    prefix = _prefix(4, P0, V0.hidden_size, 3, device)
    first = _generate(monkeypatch, _decoder(V0, 0, device), V0, prefix, 3)[2]
    other = _generate(monkeypatch, _decoder(V0, 1, device), V0, prefix, 3)[2]
    assert other["decode_graph_captures"] == 1 and other["decode_graph_replays"] == 2
    assert first["decode_graph_captures"] <= 1
