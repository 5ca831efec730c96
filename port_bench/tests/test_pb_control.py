"""On the card: the control readings at the cell's own size, on three
seeds. The program reads within the cell's limits; its int8 path (the
control), the fp8 reference and each planted fault read above one of them.
Run on the card with

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider port_bench/tests/test_pb_control.py

(``--noconftest`` keeps out ``tests/conftest.py``, which imports JAX; this
folder's conftest is then put on the path by hand, as below)."""

import os
import sys

import pytest
import torch

sys.path[:0] = [os.path.dirname(os.path.abspath(__file__)),
                os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))]

import pb_tiny  # noqa: E402
from port_bench import control, spec  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["v0_bf16.short_answers", "v0_htsat_large_bf16.short_answers"])
def test_control_fails_and_the_program_passes(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seeds = [2 ** 31 + 701, 2 ** 31 + 702, 2 ** 31 + 703]
    out = control.run(pb_tiny.REPO, workload, seeds, seeds, torch.device("cuda:0"))
    limits = spec.load(pb_tiny.REPO, workload).limits

    def fails(r):
        return r["answers_missing"] > 0 or any(r.get(k) is None or r[k] > limit for k, limit in limits.items())

    for seed in seeds:
        assert not fails(out["program"][seed]), out["program"][seed]
        for side in ("control", "fp8_reference", "altered_token", "stale_cache", "skipped_block"):
            r = dict(out[side][seed], answers_missing=out[side][seed].get("answers_missing", 0))
            assert fails(r), (side, r)
