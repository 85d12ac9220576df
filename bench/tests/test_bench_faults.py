"""A run with its timed path broken underneath reads ``correct`` false,
once for each fault a cell can have; the same run unbroken reads true.
On the CPU at tiny sizes, with the cells' own limits."""

import time

import pytest

from bench import harness
from bench.tests.tiny import tiny

SEED = 2**31 + 99


def run(name, fault=None):
    cell = tiny(name)
    return harness.driver(cell).run(cell, SEED, 1.0, False, time.perf_counter(), device="cpu", fault=fault)


@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch", "token"])
def test_training_faults(fault):
    out = run("yi6b.train_stream", fault)
    failed = [c.name for c in out["checks"] if not c.ok]
    assert out["correct"] is (fault is None), failed
    want = {"unchanged": "change_gap", "half_batch": "loss_gap", "token": "rows_not_in_corpus"}
    if fault:
        assert want[fault] in failed


@pytest.mark.parametrize("fault", [None, "token"])
def test_serving_faults(fault):
    out = run("yi6b.serve_rate", fault)
    failed = [c.name for c in out["checks"] if not c.ok]
    assert out["correct"] is (fault is None), failed
    if fault:
        assert failed == ["greedy_gap"]
