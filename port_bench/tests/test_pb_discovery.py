"""A configuration (int8 weights and cache), a traffic mix (``max_len``
drawn per call, with a module of its own), a limit and a per-layer metric
added as new files in a copy of the benchmark are found by name, and no
file the benchmark had is edited; a mix key that nothing reads is
refused."""

import hashlib
import json
import os
import time

import pytest

import pb_tiny
from port_bench import harness, spec

NEW_METRIC = '''"""tiny_calls: the calls the timed window completed."""


def read(trace, run):
    return float(run.calls)
'''
NEW_MIX = dict(pb_tiny.TINY_MIX, max_len=[2, 5], pool_batches=4, note="captions of 2 to 5 tokens")
NEW_MIX_MODULE = '''"""tiny_captions: the general generator, with a note the mix carries, and
the harness's closed loop, noting beside this file the calls it drove."""

import os

from port_bench import harness

KEYS = {"note"}


def drive(model, pool, seconds, taps):
    out = harness.closed_loop(model, pool, seconds, taps)
    with open(os.path.join(os.path.dirname(__file__), "driven.txt"), "w") as f:
        f.write(str(len(out[0])))
    return out
'''
INT8_CFG = dict(pb_tiny.TINY_CFG, name="tiny_int8", serve={"weight_dtype": "int8-w8a8", "kv_cache_dtype": "int8"})
INT8_CELL = "tiny_int8.tiny_captions"
# The int8 path's tiny readings stay within about twice the bf16 ones.
INT8_LIMITS = {"max_logit_gap": 0.1, "logits_rel_err": 0.1, "prefix_rel_err": 0.02, "decoder_rel_err": 0.05,
               "cache_rel_err": 0.05, "first_layer_kv_rel_err": 0.05}


def _digests(top):
    out = {}
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith((".py", ".json", ".md")):
                path = os.path.join(d, f)
                with open(path, "rb") as fh:
                    out[os.path.relpath(path, top)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _write(root, rel, text):
    with open(os.path.join(root, "port_bench", rel), "w") as f:
        f.write(text)


def _add(root):
    """The new files, and their entries in the copy's BENCHMARK.json."""
    _write(root, "metrics/tiny_calls.py", NEW_METRIC)
    _write(root, "traffic/tiny_captions.json", json.dumps(NEW_MIX))
    _write(root, "traffic/tiny_captions.py", NEW_MIX_MODULE)
    _write(root, "configs/tiny_int8.json", json.dumps(INT8_CFG))
    _write(root, f"limits/{INT8_CELL}.json", json.dumps(INT8_LIMITS))
    bench_path = os.path.join(root, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny_int8", "source": INT8_CFG["source"],
                             "file": "port_bench/configs/tiny_int8.json", "reduced": [], "why": "tiny, int8"})
    bench["workloads"].append({"name": INT8_CELL, "config": "tiny_int8", "traffic": "tiny_captions", "chips": 1,
                               "why": "tiny captions"})
    bench["per_layer"].append({"name": "tiny_calls", "unit": "calls", "better": "higher", "source": "host_clock",
                               "layer": "whole call", "moves": "answers_per_s",
                               "workloads": [pb_tiny.CELL, INT8_CELL]})
    with open(bench_path, "w") as f:
        json.dump(bench, f)


def test_new_files_are_found_by_name(tmp_path):
    root = pb_tiny.make_root(str(tmp_path), metrics=("launches_per_call", "mfu"))
    _add(root)
    before = _digests(pb_tiny.PB)
    copied = _digests(os.path.join(root, "port_bench"))
    added = {"configs/tiny_bf16.json", "traffic/tiny_mix.json", f"limits/{pb_tiny.CELL}.json",
             "metrics/tiny_calls.py", "traffic/tiny_captions.json", "traffic/tiny_captions.py",
             "configs/tiny_int8.json", f"limits/{INT8_CELL}.json"}
    assert set(copied) - set(before) == added
    assert all(copied[k] == before[k] for k in copied if k not in added)

    r = harness.run_cell(root, pb_tiny.CELL, 7, 0.5, True, "cpu", time.perf_counter())
    assert r["metrics"]["tiny_calls"]["value"] == r["window"]["calls"] >= pb_tiny.TINY_MIX["pool_batches"]
    assert r["metrics"]["mfu"]["unit"] == "%"
    # No device kernels on the CPU: the kernel metric finds nothing and is left out.
    assert "launches_per_call" not in r["metrics"]
    assert r["correct"] is True


def test_int8_cell_with_per_call_lengths(tmp_path, monkeypatch):
    root = pb_tiny.make_root(str(tmp_path))
    _add(root)
    cell = spec.load(root, INT8_CELL)
    assert cell.traffic.KEYS == {"note"} and cell.cfg["serve"]["kv_cache_dtype"] == "int8"
    seen = []
    orig = harness.Model.generate

    def generate(self, a1, a2, ids, max_len):
        seen.append((max_len, self.kw["w8a8"], self.kw["kv_cache_dtype"]))
        return orig(self, a1, a2, ids, max_len)

    monkeypatch.setattr(harness.Model, "generate", generate)
    r = harness.run_cell(root, INT8_CELL, 11, 0.5, False, "cpu", time.perf_counter())
    assert {m for m, _, _ in seen} == {2, 3, 4, 5}
    with open(os.path.join(root, "port_bench", "traffic", "driven.txt")) as f:
        assert int(f.read()) == r["window"]["calls"]
    assert all(w and kv == "int8" for _, w, kv in seen)
    assert r["correct"] is True, r["checks"]
    assert r["metrics"]["answers_per_s"]["value"] > 0


def test_a_mix_key_nothing_reads_is_refused(tmp_path):
    root = pb_tiny.make_root(str(tmp_path))
    _write(root, "traffic/tiny_mix.json", json.dumps(dict(pb_tiny.TINY_MIX, clients=4)))
    with pytest.raises(SystemExit, match="clients"):
        spec.load(root, pb_tiny.CELL)
