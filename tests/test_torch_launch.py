"""The port's launchers on the CPU (``repro_torch.launch.serve`` and
``repro_torch.launch.train``, the twins of the JAX package's).

The serve launcher runs in this process with ``--device cpu``. The train
launcher spawns its gloo ranks, so it runs as ``python -m`` in a
subprocess joined with a deadline; its lines are the JAX launcher's.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
DEADLINE_S = 300.0


def test_serve_launcher_serves_every_prompt_once(capsys):
    """Reduced yi-6b behind 2 replicas: every prompt served once, one
    completion each on the output topic (``gen`` int32 tokens inside the
    vocabulary), the JAX launcher's two lines printed."""
    import repro_torch.configs as TC
    from repro_torch.launch import serve

    gen, prompts = 4, 8
    out = serve.main(["--arch", "yi-6b", "--device", "cpu", "--prompts", str(prompts), "--prompt-len", "12",
                      "--gen", str(gen)])
    assert out["served"] == prompts and out["completions"] == prompts
    assert sum(out["replicas"].values()) == prompts and all(n > 0 for n in out["replicas"].values())
    vocab = TC.get_reduced("yi-6b").vocab
    for rec in out["records"]:
        toks = np.frombuffer(rec, np.int32)
        assert toks.shape == (gen,) and ((toks >= 0) & (toks < vocab)).all()
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2].startswith(f"served {prompts} prompts across {{")
    assert lines[-1] == f"{prompts} completions on the output topic"


def test_serve_launcher_refuses_an_encoder():
    """As the JAX launcher: text decoders only."""
    from repro_torch.launch import serve

    with pytest.raises(SystemExit, match="text decoders"):
        serve.main(["--arch", "whisper-tiny", "--device", "cpu"])


def _train(*args: str) -> str:
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "OMP_NUM_THREADS": "1"}
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", "yi-6b", "--device", "cpu",
                        "--ranks", "2", "--batch", "4", "--seq", "16", "--deadline", str(DEADLINE_S), *args],
                       env=env, capture_output=True, text=True, timeout=DEADLINE_S + 30)
    assert p.returncode == 0, p.stdout + p.stderr[-6000:]
    return p.stdout


def test_train_launcher_resumes_from_its_checkpoint_and_losses_fall(tmp_path):
    """Two gloo ranks on a (2,) data mesh: one step and its checkpoint, then
    a run with ``--resume`` that starts after it and takes the steps to
    20; the loss after them is below the first step's."""
    ck = str(tmp_path / "ck")
    first = _train("--steps", "1", "--ckpt-dir", ck)
    assert "arch=yi-6b-smoke params=143,808 mesh={'data': 2}" in first and "done; result registered" in first
    loss1 = float(re.search(r"step 1: loss ([0-9.]+)", first).group(1))
    assert (tmp_path / "ck" / "step_1" / "manifest.json").exists()
    second = _train("--steps", "20", "--ckpt-dir", ck, "--resume")
    assert "resumed from step 1" in second
    losses = {int(s): float(v) for s, v in re.findall(r"step (\d+): loss ([0-9.]+)", second)}
    assert sorted(losses) == [10, 20] and all(np.isfinite(list(losses.values())))
    assert losses[20] < loss1, (loss1, losses)
    assert (tmp_path / "ck" / "step_20" / "manifest.json").exists()


@pytest.mark.parametrize("mesh", ["production", "production-multi"])
def test_train_launcher_refuses_the_production_meshes(mesh):
    """The reference's production meshes are TPU pods; the port's launcher
    raises as ``make_production_mesh`` does."""
    from repro_torch.launch import train

    with pytest.raises(NotImplementedError, match="TPU v5e"):
        train.main(["--arch", "yi-6b", "--device", "cpu", "--mesh", mesh])
