"""Find a cell's pieces by name: ``BENCHMARK.json`` at the checkout's root
names the cell's configuration and traffic mix and the metrics it reports;
each lives in a file of its own under ``port_bench/``:

  configs/<config>.json     the configuration (the file BENCHMARK.json gives)
  reference/<name>.py       its plain reference (the configuration's "reference"),
                            with the leaves of its weight tree
  traffic/<mix>.json        the mix's parameters, read by generator.py
  traffic/<mix>.py          optional: the mix's own make_pool, drive, KEYS
  limits/<workload>.json    the limit of each number the correctness check compares
  metrics/<metric>.py       a metric's reader, end to end or per layer:
                            read(trace, run) -> number or None
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import NamedTuple, Optional

from port_bench import generator


class Cell(NamedTuple):
    workload: dict
    cfg: dict
    mix: dict
    traffic: Optional[object]  # the mix's own module, where it has one
    limits: dict
    end_to_end: list  # metric entries of BENCHMARK.json this cell reports
    per_layer: list


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load(root: str, name: str) -> Cell:
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {[w['name'] for w in bench['workloads']]}")
    w = found[0]
    entry = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    mix = _json(os.path.join(root, "port_bench", "traffic", w["traffic"] + ".json"))
    traffic = _module(root, "traffic", w["traffic"]) if os.path.exists(
        os.path.join(root, "port_bench", "traffic", w["traffic"] + ".py")) else None
    unknown = set(mix) - generator.KEYS - set(getattr(traffic, "KEYS", ()))
    if unknown:
        raise SystemExit(f"traffic {w['traffic']!r} sets {sorted(unknown)}, which nothing reads")
    return Cell(
        workload=w,
        cfg=_json(os.path.join(root, entry["file"])),
        mix=mix,
        traffic=traffic,
        limits=_json(os.path.join(root, "port_bench", "limits", name + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def _module(root: str, folder: str, name: str):
    """``port_bench/<folder>/<name>.py`` under ``root``, loaded by path (a
    file name may hold dots)."""
    path = os.path.join(root, "port_bench", folder, name + ".py")
    spec = importlib.util.spec_from_file_location(f"port_bench.{folder}.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric(root: str, name: str):
    """The module of ``metrics/<name>.py``: its ``read`` and, where it
    reads the work of a program function, its ``SPANS``."""
    return _module(root, "metrics", name)


def reference(root: str, cfg: dict):
    """The configuration's plain reference module."""
    return _module(root, "reference", cfg["reference"])
