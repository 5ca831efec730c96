"""Nothing under port_bench/ imports jax, jaxlib, flax or the JAX package,
compared by each module's whole top-level name (so the port,
``mellow_tpu_torch``, passes)."""

import ast
import os
import subprocess
import sys

import pb_tiny

BLOCKED = ("jax", "jaxlib", "flax", "mellow_tpu")


def _sources():
    for d, _, files in os.walk(pb_tiny.PB):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_names_a_blocked_module():
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names = [node.module]
            assert not [n for n in names if n.split(".")[0] in BLOCKED], (path, names)


def test_every_module_imports_with_the_blocked_ones_absent():
    code = (
        "import importlib.util, os, sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        f"sys.path[:0] = [{pb_tiny.REPO!r}, {pb_tiny.HERE!r}]\n"
        "import mellow_tpu_torch.models.mellow, mellow_tpu_torch.models.generate\n"
        "paths = sys.argv[1:]\n"
        "for i, path in enumerate(paths):\n"
        "    spec = importlib.util.spec_from_file_location(f'pb_mod_{i}', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "from port_bench import harness\n"
        "assert 'mellow_tpu_torch' in sys.modules\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in harness.BLOCKED and sys.modules[m] is not None]\n"
        "print(len(paths), bad, harness.blocked_modules())\n"
    )
    paths = list(_sources())
    proc = subprocess.run([sys.executable, "-c", code, *paths], capture_output=True, text=True, timeout=300,
                          cwd=pb_tiny.REPO)
    assert proc.returncode == 0, proc.stderr
    count, rest = proc.stdout.strip().split(" ", 1)
    assert int(count) == len(paths) >= 20 and rest == "[] []"
