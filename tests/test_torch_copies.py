"""The copy rule: the port keeps verbatim copies of the JAX package's
jax-free modules it needs, with only their import lines rewritten from
``repro.`` to ``repro_torch.``."""

import ast
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
    "core/control.py",
    "core/registry.py",
    "data/formats.py",
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


# data/pipeline.py: every definition but the mesh's ShardedFeeder and the
# rewritten device_feed is a verbatim copy (the module's imports differ)
PIPELINE_COPIES = [
    "ShortStreamError",
    "PrefetchIterator",
    "prefetch_iter",
    "ingest",
    "TransactionalProcessor",
    "StreamDataset",
    "_window_ranges",
    "StreamingBatchIterator",
    "BatchIterator",
]


def _definitions(path: Path) -> dict[str, str]:
    text = path.read_text()
    tree = ast.parse(text)
    return {
        node.name: ast.get_source_segment(text, node, padded=True)
        for node in tree.body
        if isinstance(node, (ast.FunctionDef, ast.ClassDef))
    }


@pytest.mark.parametrize("name", PIPELINE_COPIES)
def test_pipeline_definition_is_verbatim(name):
    original = _definitions(REPO / "src" / "repro" / "data" / "pipeline.py")
    copy = _definitions(REPO / "src" / "repro_torch" / "data" / "pipeline.py")
    assert copy[name] == original[name]


def test_pipeline_copies_all_but_the_device_code():
    original = set(_definitions(REPO / "src" / "repro" / "data" / "pipeline.py"))
    copy = set(_definitions(REPO / "src" / "repro_torch" / "data" / "pipeline.py"))
    assert original - copy == {"ShardedFeeder"}
    assert copy - original == {"_CudaFeed"}
    assert original - {"ShardedFeeder", "device_feed"} == set(PIPELINE_COPIES)
