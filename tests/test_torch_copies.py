"""The copy rule: the port keeps verbatim copies of the JAX package's
jax-free modules it needs, with only their import lines rewritten from
``repro.`` to ``repro_torch.``."""

import re
from pathlib import Path

import pytest

from repro.analysis.lockcheck import scan_paths

REPO = Path(__file__).resolve().parents[1]
COPIES = [
    "core/log.py",
    "core/metrics.py",
    "core/controller.py",
    "core/cluster.py",
    "core/consumer.py",
    "analysis/ranks.py",
    "analysis/witness.py",
]
_IMPORT = re.compile(r"^(\s*)(from|import) repro\.")


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_verbatim_but_its_imports(rel):
    original = (REPO / "src" / "repro" / rel).read_text().splitlines()
    copy = (REPO / "src" / "repro_torch" / rel).read_text().splitlines()
    want = [_IMPORT.sub(r"\1\2 repro_torch.", line) for line in original]
    assert len(copy) == len(want), f"{rel}: {len(copy)} lines, the original has {len(want)}"
    for i, (got, line) in enumerate(zip(copy, want), 1):
        assert got == line, f"{rel}:{i}: {got!r} != {line!r}"


def test_lockcheck_finds_the_same_in_the_copies():
    core = [c for c in COPIES if c.startswith("core/")]
    want, scanned = scan_paths([str(REPO / "src" / "repro" / c) for c in core])
    got, port_scanned = scan_paths([str(REPO / "src" / "repro_torch" / "core")])
    assert set(scanned) <= set(port_scanned)
    assert sorted(f.id for f in got) == sorted(f.id for f in want)
