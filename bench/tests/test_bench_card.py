"""Each cell once on the card, through the benchmark's command
(``bench/run.py``), with a short window: the result line's keys and
``correct``. Skips without a CUDA device; decided in the fixture."""

import json
import subprocess
import sys

import pytest

from bench.tests.conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_cell_on_card(card, name):
    cmd = [sys.executable, "bench/run.py", "--workload", name, "--seed", str(2**31 + 17), "--seconds", "5",
           "--trace", "0"]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert list(out)[-1] == "checks" and out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    want = {m["name"] for m in SPEC["end_to_end"] if "workloads" not in m or name in m["workloads"]}
    assert set(out["metrics"]) == want


def test_no_card_no_result():
    """Without a card (or in a tree without the program) the command
    exits with another code than 0 and prints no result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run([sys.executable, "bench/run.py", "--workload", SPEC["workloads"][0]["name"], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert res.returncode != 0 and res.stdout.strip() == ""
