"""One run of one cell: load it by name, make the weights and the inputs from
the seed, warm up, measure for the window, then (traced runs) profile a few
steady calls, check the window's answers against the plain reference, and
return the result line.

The timed call is the model entry that ``MellowWrapper.generate``,
``BatchingEngine`` and ``eval.run_eval`` call after host preprocessing:
the host arrays are copied to the card and cast to the compute dtype (as
the wrapper's ``_device_inputs``, from pageable memory),
``models.mellow.generate_tokens`` runs greedily to the batch's
``max_len`` with the configuration's ``serve`` options, and the call ends
when the tokens are on the host.
"""

from __future__ import annotations

import functools
import gc
import importlib
import inspect
import json
import subprocess
import sys
import time
from contextlib import ExitStack, nullcontext
from typing import NamedTuple

import numpy as np
import torch

from port_bench import check, generator, spec, trace, weights

BLOCKED = ("jax", "jaxlib", "flax", "mellow_tpu")
WARMUP_CALLS = 2
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# The options of a configuration's "serve" key, as ``MellowWrapper`` takes
# them: the decoder's weights (None: the compute dtype; "int8"; "int8-w8a8")
# and the KV cache (None: the compute dtype; "int8").
SERVE = {"weight_dtype": None, "kv_cache_dtype": None}


class Run(NamedTuple):
    """What a metric reader may read of the run besides the trace."""
    cfg: dict
    mix: dict
    served: list  # check.Served of every call the window completed
    latencies: list  # each call's seconds, host arrays to tokens on the host
    window_s: float
    setup_s: float

    @property
    def calls(self) -> int:
        return len(self.served)


def blocked_modules() -> list:
    """The blocked top-level names among the modules loaded in this process."""
    return sorted({m.split(".")[0] for m, mod in list(sys.modules.items())
                   if mod is not None and m.split(".")[0] in BLOCKED})


def family_module(cfg: dict):
    """The program's module of the configuration's decoder family."""
    return importlib.import_module(f"mellow_tpu_torch.models.{cfg['decoder_family']}")


def program_config(cfg: dict):
    """The program's configuration object for a configuration file."""
    from mellow_tpu_torch.config import FrontendConfig, HTSATConfig, LlamaConfig, MellowConfig

    decoder = LlamaConfig if cfg["decoder_family"] == "llama" else family_module(cfg).GPT2Config
    enc = dict(cfg["encoder"], depths=tuple(cfg["encoder"]["depths"]),
               num_heads=tuple(cfg["encoder"]["num_heads"]))
    top = {k: cfg[k] for k in ("decoder_family", "d_proj", "text_tokenization_len", "prefix_length",
                               "sep_token_id", "stop_token_id", "pad_token_id", "compute_dtype")}
    return MellowConfig(name=cfg["name"], frontend=FrontendConfig(**cfg["frontend"]), encoder=HTSATConfig(**enc),
                        decoder=decoder(**cfg["decoder"]), **top).validate()


def serve_options(cfg: dict) -> dict:
    unknown = set(cfg.get("serve", {})) - set(SERVE)
    if unknown:
        raise SystemExit(f"configuration {cfg['name']!r}: serve options {sorted(unknown)} are not known")
    return dict(SERVE, **cfg.get("serve", {}))


def program_params(cfg: dict, params: dict, dtype: torch.dtype) -> dict:
    """The weights as the program serves them: with int8 decoder weights,
    quantized from float32 by the family's own quantizer and every floating
    leaf then cast to the compute dtype, as ``MellowWrapper`` does."""
    if serve_options(cfg)["weight_dtype"] is None:
        return params
    from mellow_tpu_torch.models.params import cast_floating, tree_map

    fam = family_module(cfg)
    quantize = fam.quantize_decoder if cfg["decoder_family"] == "llama" else fam.quantize_gpt2
    dec32 = tree_map(lambda t: t.float(), params["decoder"])
    return dict(params, decoder=cast_floating(quantize(dec32, program_config(cfg).decoder), dtype))


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "not read"
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def seeds(seed: int) -> dict:
    state = np.random.SeedSequence(seed).generate_state(3, dtype=np.uint64)
    return {k: int(v) & (2 ** 63 - 1) for k, v in zip(("weights", "inputs", "check"), state)}


class Model:
    """The program under test, driven as one client drives it."""

    def __init__(self, cfg: dict, mix: dict, params: dict, device):
        from mellow_tpu_torch.models import mellow

        self.mellow = mellow
        self.cfg, self.pcfg = cfg, program_config(cfg)
        self.dtype = DTYPES[cfg["compute_dtype"]]
        opts = serve_options(cfg)
        self.kw = dict(kv_cache_dtype=opts["kv_cache_dtype"], w8a8=opts["weight_dtype"] == "int8-w8a8")
        self.mix, self.device = mix, torch.device(device)
        self.params = program_params(cfg, params, self.dtype)

    def call(self, batch: generator.Batch, ranges: bool = False, tap=None):
        """One batch -> (tokens (B, max_len) numpy, steps run). With ``tap``
        (a ``Tap``), what the program made for the tap's rows is kept."""
        from torch.profiler import record_function

        dev, dt = self.device, self.dtype
        with record_function(trace.PREFIX + "h2d") if ranges else nullcontext():
            a1 = torch.from_numpy(batch.wave1).to(device=dev, dtype=dt)
            a2 = torch.from_numpy(batch.wave2).to(device=dev, dtype=dt)
            ids = torch.from_numpy(batch.text_ids).to(dev)
        with tap if tap is not None else nullcontext():
            res = self.generate(a1, a2, ids, batch.max_len)
        with record_function(trace.PREFIX + "d2h") if ranges else nullcontext():
            tokens = res.tokens.cpu().numpy()
        return tokens, res.num_steps

    def generate(self, a1, a2, ids, max_len: int):
        return self.mellow.generate_tokens(self.params, self.pcfg, a1, a2, ids, max_len=max_len,
                                           greedy=self.mix["greedy"], **self.kw)


def _patch(stack: ExitStack, module, attr: str, make):
    """``module.attr`` replaced by ``make(original)`` until ``stack`` closes."""
    orig = getattr(module, attr)
    setattr(module, attr, make(orig))
    stack.callback(setattr, module, attr, orig)


class Tap:
    """Keeps, for the batch rows ``rows`` of one call, what the program made
    on the way to its tokens, where the program makes it:

      prefix     the decoder's input prefix (``models.mellow.encode_and_prefix``'s
                 output), (r, P, D);
      logits     the logits each token is chosen from (the family's
                 ``logits_from_hidden``, which the decode window looks up at
                 each token), (r, tokens, V);
      kv_decode  the keys and values the decode steps left in the cache at
                 the positions they wrote, every layer: (k, v), each (L, r,
                 steps, ...);
      kv_first   the first layer's keys and values at every position the
                 call wrote, the prefill's and the decode steps': (k, v),
                 each (1, r, P + steps, ...).

    The cache is read where the family's ``decode_step`` was handed it, once
    the call is done: from its flush window at a position not yet flushed,
    scaled back where it is int8. Device copies of those rows only, taken
    while the tap is entered."""

    def __init__(self, rows: list, cfg: dict, device):
        self.rows = torch.tensor(rows, dtype=torch.long, device=device)
        self.cfg = cfg
        self.kept, self.prefix_rows, self.kv_decode, self.kv_first = [], None, None, None
        self._stack = self._seen = None

    def __enter__(self):
        from mellow_tpu_torch.models import mellow

        fam = family_module(self.cfg)
        rows, seen = self.rows, {"positions": []}
        self._seen = seen
        stack = self._stack = ExitStack()

        def on_prefix(orig):
            @functools.wraps(orig)
            def tapped(*args, **kwargs):
                out = orig(*args, **kwargs)
                self.prefix_rows = out.index_select(0, rows)
                return out
            return tapped

        def on_logits(orig):
            @functools.wraps(orig)
            def tapped(*args, **kwargs):
                out = orig(*args, **kwargs)
                self.kept.append(out.index_select(0, rows))
                return out
            return tapped

        def on_step(orig):
            sig = inspect.signature(orig)

            @functools.wraps(orig)
            def tapped(*args, **kwargs):
                a = sig.bind(*args, **kwargs).arguments
                seen["positions"].append(int(a["pos"]))
                seen["cache"], seen["window"] = a["cache"], a.get("window")
                return orig(*args, **kwargs)
            return tapped

        _patch(stack, mellow, "encode_and_prefix", on_prefix)
        _patch(stack, fam, "logits_from_hidden", on_logits)
        _patch(stack, fam, "decode_step", on_step)
        return self

    def __exit__(self, *exc):
        self._stack.close()
        seen, self._seen = self._seen, None
        pos = seen["positions"]
        if pos:
            cache, window = seen["cache"], seen["window"]
            self.kv_decode = tuple(_kv_rows(cache, window, self.rows, pos, w, slice(None)) for w in "kv")
            self.kv_first = tuple(_kv_rows(cache, window, self.rows, list(range(pos[0])) + pos, w, slice(0, 1))
                                  for w in "kv")
        return False


def _kv_rows(cache, window, rows, positions: list, which: str, layers: slice) -> torch.Tensor:
    """The cache's ``which`` ("k" or "v") of ``layers`` at ``positions``
    (ascending) for ``rows``, (L', r, len(positions), ...) float32: from
    ``window`` at a position it holds unflushed, else from the cache,
    times its per-position scale where it is int8."""
    flushed = window.flushed if window is not None else float("inf")
    dev = rows.device
    parts = []
    cached = torch.tensor([p for p in positions if p < flushed], dtype=torch.long, device=dev)
    if len(cached):
        x = getattr(cache, which)[layers].index_select(1, rows).index_select(2, cached).float()
        scale = getattr(cache, which + "_scale", None)
        if scale is not None:
            s = scale[layers].index_select(1, rows).index_select(2, cached)
            x = x * s.reshape(s.shape + (1,) * (x.dim() - s.dim()))
        parts.append(x)
    pending = torch.tensor([p - flushed for p in positions if p >= flushed], dtype=torch.long, device=dev)
    if len(pending):
        parts.append(getattr(window, which)[layers].index_select(1, rows).index_select(2, pending).float())
    return torch.cat(parts, 2)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _ranged(label: str):
    """A wrapper factory: the function inside a ``record_function`` range."""
    from torch.profiler import record_function

    def make(orig):
        @functools.wraps(orig)
        def wrapped(*args, **kwargs):
            with record_function(trace.PREFIX + label):
                return orig(*args, **kwargs)
        return wrapped
    return make


def _op_ranged(name: str, describe):
    """A wrapper factory: each call in an op range ``op.<name>:<JSON of
    describe(bound arguments)>`` (``trace.py``)."""
    from torch.profiler import record_function

    def make(orig):
        sig = inspect.signature(orig)

        @functools.wraps(orig)
        def wrapped(*args, **kwargs):
            shapes = json.dumps(describe(sig.bind(*args, **kwargs).arguments), separators=(",", ":"))
            with record_function(f"{trace.PREFIX}{trace.OP}{name}:{shapes}"):
                return orig(*args, **kwargs)
        return wrapped
    return make


def profile_calls(model: Model, pool: list, first: int, calls: int, device, spans: dict):
    """``calls`` steady calls under torch.profiler (after one warm-up step
    whose events are dropped), inside the harness's ranges and the op
    ranges ``spans`` {name: (module, attribute, describe)} -> TraceView."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule
    from mellow_tpu_torch.models import generate as gen_module

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.device(device).type == "cuda" else [])
    with ExitStack() as stack:
        _patch(stack, model.mellow, "encode_and_prefix", _ranged("encoder"))
        _patch(stack, gen_module, "generate", _ranged("decoder"))
        for name, (module, attr, describe) in spans.items():
            _patch(stack, importlib.import_module(module), attr, _op_ranged(name, describe))
        with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=calls, repeat=1)) as prof:
            for j in range(1 + calls):
                with record_function(trace.PREFIX + "call"):
                    model.call(pool[(first + j) % len(pool)], ranges=True)
                _sync(device)
                prof.step()
    return trace.read(prof, calls)


def closed_loop(model: Model, pool: list, seconds: float, taps: dict):
    """One client hands the pool's batches back to back, at least one pass
    over the pool and until ``seconds`` have passed; the first pass's calls
    on the pool indexes in ``taps`` are tapped. -> (served, latencies,
    start, end) on ``time.perf_counter``'s clock."""
    served, lat = [], []
    start = end = time.perf_counter()
    deadline, i = start + seconds, 0
    while i < len(pool) or end < deadline:
        batch = pool[i % len(pool)]
        t = time.perf_counter()
        tokens, steps = model.call(batch, tap=taps.get(i) if i < len(pool) else None)
        end = time.perf_counter()
        lat.append(end - t)
        served.append(check.Served(i % len(pool), tokens, steps, batch.max_len))
        i += 1
    return served, lat, start, end


def warm_up(model: Model, pool: list, taps: dict) -> None:
    """``WARMUP_CALLS`` calls, and one on each batch whose ``max_len`` no
    earlier call had: every shape the window will use. The first is tapped
    as a window's tapped call is (a throwaway ``Tap`` on the same rows), so
    the tap's kernels are loaded before the window too."""
    lens = set()
    for j, batch in enumerate(pool):
        if j < WARMUP_CALLS or batch.max_len not in lens:
            p = min(taps) if j == 0 and taps else None
            model.call(batch, tap=None if p is None else Tap(taps[p].rows.tolist(), model.cfg, model.device))
            lens.add(batch.max_len)


def run_cell(root: str, workload: str, seed: int, seconds: float, traced: bool, device, t0: float) -> dict:
    """The result line's dict of one run (``t0``: the process's start on
    ``time.perf_counter``'s clock)."""
    cell = spec.load(root, workload)
    cfg, mix = cell.cfg, cell.mix
    ref = spec.reference(root, cfg)
    s = seeds(seed)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False  # as the program's wrapper sets it
        torch.backends.cudnn.allow_tf32 = False
    params = weights.make(ref.leaves(cfg), s["weights"], dev, DTYPES[cfg["compute_dtype"]])
    pool = getattr(cell.traffic, "make_pool", generator.make_pool)(mix, cfg, s["inputs"], dev)
    model = Model(cfg, mix, params, dev)
    taps = {p: Tap(rows, cfg, dev) for p, rows in check.sample(pool, mix, s["check"]).items()}
    warm_up(model, pool, taps)
    _sync(dev)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    limit = power_limit() if dev.type == "cuda" else "cpu"

    drive = getattr(cell.traffic, "drive", closed_loop)
    served, lat, start, end = drive(model, pool, seconds, taps)
    setup_s, window_s = start - t0, end - start
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    run = Run(cfg, mix, served, lat, window_s, setup_s)
    result = {"correct": False, "attempted": sum(len(pool[x.pool_index].text_ids) for x in served), "failed": 0, "metrics": {}}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
                   "count": 1, "memory_peak_bytes": int(peak)}
    view = op_view = None
    if traced:
        # Two profiled passes over the same steady calls: the first as the
        # window runs them, for the device's busy and idle time and every
        # reader without SPANS; the second with the op ranges those readers
        # ask for, whose host cost stays out of the first's idle share.
        readers = {m["name"]: spec.metric(root, m["name"]) for m in cell.per_layer}
        spans = {k: v for r in readers.values() for k, v in getattr(r, "SPANS", {}).items()}
        view = profile_calls(model, pool, len(served), mix["trace_calls"], dev, {})
        op_view = profile_calls(model, pool, len(served), mix["trace_calls"], dev, spans) if spans else view
        device_info.update(busy_s=view.busy_s, window_s=view.window_s)
        result["breakdown"] = trace.breakdown(view)
        print(f"traced {view.calls} calls: {len(view.kernels)} kernels, "
              f"{sum(o.label == 'unattributed' for o in view.kernels)} unattributed", file=sys.stderr)
    else:
        readers = {m["name"]: spec.metric(root, m["name"]) for m in cell.end_to_end}
    units = {m["name"]: m["unit"] for m in cell.per_layer + cell.end_to_end}
    for name, reader in readers.items():
        value = reader.read(op_view if getattr(reader, "SPANS", None) else view, run)
        if value is not None:
            result["metrics"][name] = {"value": value, "unit": units[name]}
    result["device"] = device_info

    del model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    correct, checks = check.run(ref, params, cfg, mix, cell.limits, pool, served, taps, dev)
    result["correct"] = correct
    result["failed"] = checks["answers_missing"]["value"]
    result["power_limit"] = limit
    lat_ms = np.asarray(lat) * 1e3
    result["window"] = {"calls": len(served), "seconds": window_s, "setup_s": setup_s,
                        "call_ms": [float(np.quantile(lat_ms, q)) for q in (0.0, 0.25, 0.5, 0.75, 1.0)],
                        "first_calls_ms": [float(x) for x in lat_ms[:2 * len(pool)]]}
    result["checks"] = checks
    return result
