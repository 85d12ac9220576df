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
    "core/supervisor.py",
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


# data/pipeline.py: every definition but the rewritten device_feed and
# ShardedFeeder (the port's mesh) is a verbatim copy (the module's imports differ)
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
    """Each top-level function or class: its decorators and its source."""
    text = path.read_text()
    tree = ast.parse(text)
    return {
        node.name: "".join(f"@{ast.unparse(d)}\n" for d in node.decorator_list)
        + ast.get_source_segment(text, node, padded=True)
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
    assert original - copy == set()
    assert copy - original == {"_CudaFeed"}
    assert original - {"ShardedFeeder", "device_feed"} == set(PIPELINE_COPIES)


# serve/engine.py: the publisher, Algorithm 2's deployment and its helpers
# are verbatim; the replica is verbatim but for the line that collects a
# prediction on the host (np.asarray cannot take a CUDA tensor); the serve
# steps are the port's own (the model holds its weights)
ENGINE_COPIES = ["TxnOutputPublisher", "ReplicaStats", "_decode_data", "InferenceDeployment"]
COLLECT = ("            preds = np.asarray(preds)\n", "            preds = _to_numpy(preds)\n")


@pytest.mark.parametrize("name", ENGINE_COPIES)
def test_engine_definition_is_verbatim(name):
    original = _definitions(REPO / "src" / "repro" / "serve" / "engine.py")
    copy = _definitions(REPO / "src" / "repro_torch" / "serve" / "engine.py")
    assert copy[name] == original[name]


def test_engine_replica_is_verbatim_but_its_collect_line():
    original = _definitions(REPO / "src" / "repro" / "serve" / "engine.py")["InferenceReplica"]
    copy = _definitions(REPO / "src" / "repro_torch" / "serve" / "engine.py")["InferenceReplica"]
    assert original.count(COLLECT[0]) == 1 and copy.count(COLLECT[1]) == 1
    assert copy == original.replace(*COLLECT)


def test_engine_defines_what_the_jax_module_does():
    original = set(_definitions(REPO / "src" / "repro" / "serve" / "engine.py"))
    copy = set(_definitions(REPO / "src" / "repro_torch" / "serve" / "engine.py"))
    assert original - copy == set()
    assert copy - original == {"_to_numpy"}
    assert original - {"InferenceReplica", "build_serve_step", "build_prefill_step"} == set(ENGINE_COPIES)


def test_copd_synth_dataset_is_verbatim():
    original = _definitions(REPO / "src" / "repro" / "configs" / "copd_mlp.py")
    copy = _definitions(REPO / "src" / "repro_torch" / "configs" / "copd_mlp.py")
    assert copy["synth_dataset"] == original["synth_dataset"]


# configs/: every architecture the port registers is its original's
# definitions (config, reduced_config) and ID, its imports aside
CONFIG_COPIES = ["yi_6b", "mamba2_2_7b", "recurrentgemma_9b", "gemma2_2b", "qwen2_7b", "mistral_large_123b",
                 "qwen3_moe_30b_a3b", "arctic_480b", "pixtral_12b", "whisper_tiny"]


def _config_id(path: Path) -> str:
    tree = ast.parse(path.read_text())
    ids = [node.value.value for node in tree.body if isinstance(node, ast.Assign)
           and [getattr(t, "id", None) for t in node.targets] == ["ID"]]
    assert len(ids) == 1, path
    return ids[0]


@pytest.mark.parametrize("name", CONFIG_COPIES)
def test_config_copy_matches_its_original(name):
    original = REPO / "src" / "repro" / "configs" / f"{name}.py"
    copy = REPO / "src" / "repro_torch" / "configs" / f"{name}.py"
    assert set(_definitions(copy)) == {"config", "reduced_config"}
    assert _definitions(copy) == _definitions(original)
    assert _config_id(copy) == _config_id(original)


def test_config_copies_are_the_registered_architectures():
    import repro_torch.configs as TC

    assert sorted(m.__name__.rsplit(".", 1)[1] for m in TC._MODULES) == sorted(CONFIG_COPIES)


# models/moe.py: the MoE's dataclass and its capacity rule are verbatim
# (the dispatch and the FFN are the port's own; the mesh's are not ported)
MOE_COPIES = ["MoEParams", "_capacity"]


@pytest.mark.parametrize("name", MOE_COPIES)
def test_moe_definition_is_verbatim(name):
    original = _definitions(REPO / "src" / "repro" / "models" / "moe.py")
    copy = _definitions(REPO / "src" / "repro_torch" / "models" / "moe.py")
    assert copy[name] == original[name]
