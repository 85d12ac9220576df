"""The import guard: no run holds JAX or the JAX package, by top-level
name compared whole."""

import json
import subprocess
import sys

import pytest

from bench import harness
from bench.tests.conftest import ROOT

REHEARSAL = """
import json, sys, time
sys.path[:0] = [{root!r}, {src!r}]
from bench import harness
from bench.tests.tiny import tiny
cell = tiny({name!r})
out = harness.driver(cell).run(cell, 2**31 + 7, 1.0, False, time.perf_counter(), device="cpu")
print(json.dumps({{"correct": out["correct"], "held": harness.forbidden_modules()}}))
"""


def test_whole_names():
    mods = {"repro_torch": 1, "repro_torch.models": 1, "reprox": 1, "jaxtyping": 1, "numpy": 1}
    assert harness.forbidden_modules(mods) == []
    assert harness.forbidden_modules({**mods, "repro.core": 1, "jax": 1, "flax.linen": 1}) == [
        "flax.linen", "jax", "repro.core"]


@pytest.mark.parametrize("name", ["yi6b.train_stream", "yi6b.serve_rate"])
def test_rehearsal_loads_no_jax(name):
    code = REHEARSAL.format(root=str(ROOT), src=str(ROOT / "src"), name=name)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["held"] == []
    assert out["correct"] is True
