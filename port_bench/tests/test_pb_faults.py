"""A run of the harness with the timed path broken underneath reads
``correct`` false, and a sound run reads it true (the tiny cell on the CPU;
the harness's look for a card is the only step left out). The faults are
``control.py``'s, planted under the program's entry, and two more of the
harness's own: answers that stop short, and half of each batch left out."""

import time

import pytest

import pb_tiny
from port_bench import control, harness


def _run(root):
    return harness.run_cell(root, pb_tiny.CELL, 2 ** 31 + 12345, 0.5, False, "cpu", time.perf_counter())


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return pb_tiny.make_root(str(tmp_path_factory.mktemp("pb")))


def test_sound_run_is_correct(root):
    r = _run(root)
    assert r["correct"] is True
    assert set(r["checks"]) == set(pb_tiny.TINY_LIMITS) | {"answers_missing"}
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())
    assert r["failed"] == 0 and r["attempted"] == r["window"]["calls"] * pb_tiny.TINY_MIX["batch"]


@pytest.mark.parametrize("fault, number", [
    (control.AlteredToken, "max_logit_gap"),  # a token altered where it is chosen (the next id)
    (control.StaleCache, "cache_rel_err"),  # a decode step that returns its cache unchanged
    (control.SkippedBlock, "prefix_rel_err"),  # a Swin block of the encoder's third stage left out
])
def test_planted_fault_is_not_correct(root, monkeypatch, fault, number):
    monkeypatch.setattr(harness, "Model", fault)
    r = _run(root)
    assert r["correct"] is False
    assert r["checks"][number]["value"] > pb_tiny.TINY_LIMITS[number]


def test_missing_answers_are_not_correct(root, monkeypatch):
    """A call that ends before ``max_len`` tokens, no stop token served,
    counts its answers as failed."""
    orig = harness.Model.call

    def short(self, batch, ranges=False, tap=None):
        tokens, steps = orig(self, batch, ranges, tap)
        tokens[tokens == pb_tiny.TINY_CFG["stop_token_id"]] = 2
        return tokens, steps - 1

    monkeypatch.setattr(harness.Model, "call", short)
    r = _run(root)
    assert r["correct"] is False and r["failed"] == r["attempted"]


def test_half_the_batch_left_out_is_not_correct(root, monkeypatch):
    """Each call answers only the first half of its requests."""
    orig = harness.Model.call

    def half(self, batch, ranges=False, tap=None):
        tokens, steps = orig(self, batch, ranges, tap)
        return tokens[: len(tokens) // 2], steps

    monkeypatch.setattr(harness.Model, "call", half)
    r = _run(root)
    assert r["correct"] is False and r["failed"] == r["attempted"] // 2
