"""What every cell's run shares: the cell's files found by name, the
import guard, the checks and their limits, and the result line.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``. Its
configuration file (``bench/configs/<config>.json``) and the module
beside it that reads it for the harness (``bench/configs/<config>.py``:
``arch_config``, ``step_flops``, ``kernel_calls``, optionally
``fill``), its traffic file
(``bench/traffic/<traffic>.json``, which names its driver in
``bench/drivers/``), its limits (``bench/limits/<cell>.json``), the
per-layer metrics' readers (``bench/metrics/<metric>.py``) and its
configuration's plain reference (``bench/reference/<config>.py``) are
found by the names ``BENCHMARK.json`` gives, so a cell, a configuration
or a metric is added by adding files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path
from types import ModuleType

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

# top-level module names no run may hold once its window has closed: the
# JAX package the port was made from, and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def load_module(path: Path, name: str | None = None) -> ModuleType:
    """The Python file at ``path`` as a module (its name may hold dots
    or hyphens, as a metric's or a configuration's does)."""
    spec = importlib.util.spec_from_file_location(name or f"bench_file_{path.stem}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(name: str, spec_path: Path | None = None) -> Cell:
    """The workload ``name`` of ``BENCHMARK.json`` and its files."""
    spec_path = spec_path or ROOT / "BENCHMARK.json"
    spec = json.loads(spec_path.read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {spec_path}: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    root = spec_path.parent
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / "bench" / "traffic" / f"{w['traffic']}.json").read_text())
    limits_path = root / "bench" / "limits" / f"{name}.json"
    limits = json.loads(limits_path.read_text()) if limits_path.exists() else {}
    return Cell(
        name=name, config_name=w["config"], traffic_name=w["traffic"], chips=int(w["chips"]),
        config=config, traffic=traffic, limits=limits,
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, name)],
    )


def driver(cell: Cell) -> ModuleType:
    return load_module(BENCH / "drivers" / f"{cell.traffic['driver']}.py", f"bench_driver_{cell.traffic['driver']}")


def _module_name(prefix: str, name: str) -> str:
    return prefix + name.replace("-", "_").replace(".", "_")


def configuration(cell: Cell) -> ModuleType:
    """The configuration's module: the program's ``ArchConfig`` of its
    file, its step's model operations and kernel calls, its weights'
    hook."""
    return load_module(BENCH / "configs" / f"{cell.config_name}.py", _module_name("bench_config_", cell.config_name))


def weight_maker(cell: Cell, seed: int, device):
    """The benchmark's weights for the cell's configuration and ``seed``."""
    from bench.models import WeightMaker

    return WeightMaker(cell.config, seed, device, getattr(configuration(cell), "fill", None))


def reference(cell: Cell) -> ModuleType:
    """The configuration's plain reference (PyTorch ops only)."""
    name = _module_name("bench_reference_", cell.config_name)
    return load_module(BENCH / "reference" / f"{cell.config_name}.py", name)


def metric_reader(name: str) -> ModuleType:
    return load_module(BENCH / "metrics" / f"{name}.py", _module_name("bench_metric_", name))


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name, compared whole, is one
    of :data:`FORBIDDEN` (``repro_torch`` is the program under test and
    is not ``repro``)."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".", 1)[0] in FORBIDDEN})


def percentile(values: list[float], p: float) -> float:
    """The ``p``-th percentile (0-100) of ``values``, nearest rank: the
    smallest value with at least ``p`` percent of them at or below it."""
    if not values:
        raise ValueError("percentile of no values")
    s = sorted(values)
    return s[max(0, math.ceil(p / 100 * len(s)) - 1)]


@dataclasses.dataclass
class Check:
    """A number the run compares, with its limit: the run is correct
    where every check holds (``value <= limit``)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def limit(cell: Cell, name: str) -> float:
    """The limit of check ``name`` in the cell's limits file."""
    try:
        return float(cell.limits[name]["limit"])
    except KeyError as e:
        raise KeyError(f"{cell.name}: no limit for {name!r} in bench/limits/{cell.name}.json") from e


def result_line(*, correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: list[Check], breakdown: dict | None = None) -> str:
    """The run's last line of standard output: the contract's keys, then
    ``checks``, each compared number beside its limit, last."""
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return json.dumps(out)
