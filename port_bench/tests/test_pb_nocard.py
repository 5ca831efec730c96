"""Without a card the benchmark fails and prints no result: it never falls
back to the CPU."""

import os
import subprocess
import sys
import time

import pytest
import torch

import pb_tiny
from port_bench import harness


def test_run_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "v0_bf16.short_answers", "--seed",
                           str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"], cwd=pb_tiny.REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_the_measurement_path_on_a_missing_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    root = pb_tiny.make_root(str(tmp_path))
    with pytest.raises((RuntimeError, AssertionError)):
        harness.run_cell(root, pb_tiny.CELL, 3, 0.5, False, "cuda", time.perf_counter())
