"""The port stands alone: it imports with jax and the JAX package blocked,
and no module of it (nor chip_smoke.py) names either."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_import_with_jax_and_repro_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.')) for k, v in sys.modules.items() if v is not None)\n"
        "print(' '.join(mods))\n"
        "print(len(mods))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert int(lines[-1]) >= 10
    for mod in ("repro_torch.kernels.ssd_scan", "repro_torch.models.ssm", "repro_torch.configs.mamba2_2_7b",
                "repro_torch.kernels.rglru_scan", "repro_torch.models.rglru", "repro_torch.configs.recurrentgemma_9b",
                "repro_torch.core.cluster", "repro_torch.core.consumer", "repro_torch.serve.engine",
                "repro_torch.core.control", "repro_torch.core.registry", "repro_torch.data",
                "repro_torch.data.formats", "repro_torch.data.pipeline", "repro_torch.train",
                "repro_torch.train.optimizer", "repro_torch.train.checkpoint", "repro_torch.train.trainer"):
        assert mod in lines[-2].split(), mod


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_repro_imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}:{node.lineno} imports {n}"
