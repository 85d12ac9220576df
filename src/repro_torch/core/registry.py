"""Back-end registry — models, configurations, deployments, results.

Paper §IV-B: the back-end stores ML models, *configurations* (logical
groups of models trained from the **same single stream**, §III-B),
deployments, and — after training — the trained artifacts plus their
metrics, which can then be deployed for inference.

The registry is the single source of truth the other components talk to
(training jobs fetch their model from here and upload results here, the
control logger files stream metadata here, inference deployments pull
trained artifacts from here). State is in-memory with optional JSON+npz
persistence so a restarted control plane recovers.
"""

from __future__ import annotations

import itertools
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping

import numpy as np

from repro_torch.analysis.witness import make_rlock

__all__ = [
    "Configuration",
    "Deployment",
    "ModelSpec",
    "Registry",
    "TrainedResult",
]


@dataclass
class ModelSpec:
    """A registered model definition (paper §III-A).

    In Kafka-ML the user pastes TensorFlow/Keras source; here the
    definition is a named builder from :mod:`repro.configs` plus override
    kwargs — the JAX analogue of "only the model definition is needed".
    """

    model_id: str
    arch: str  # key into repro.configs registry (e.g. "qwen2-7b", "copd-mlp")
    overrides: dict[str, Any] = field(default_factory=dict)
    description: str = ""


@dataclass
class Configuration:
    """A logical set of models trained from one shared stream (§III-B)."""

    config_id: str
    model_ids: list[str]
    description: str = ""


@dataclass
class TrainedResult:
    """Uploaded by a training job on completion (paper Algorithm 1, last step)."""

    result_id: str
    deployment_id: str
    model_id: str
    metrics: dict[str, float]
    eval_metrics: dict[str, float]
    # control-message metadata captured during training; used to
    # auto-configure inference decode (paper §IV-E)
    input_format: str = "RAW"
    input_config: dict[str, Any] = field(default_factory=dict)
    artifact_path: str | None = None  # checkpoint on disk

    def params_available(self) -> bool:
        return self.artifact_path is not None and os.path.exists(self.artifact_path)


@dataclass
class Deployment:
    """One deployed configuration: training kwargs + lifecycle state."""

    deployment_id: str
    config_id: str
    kind: str  # "train" | "infer"
    training_kwargs: dict[str, Any] = field(default_factory=dict)
    status: str = "deployed"  # deployed -> running -> finished | failed
    replicas: int = 1
    input_topic: str | None = None
    output_topic: str | None = None
    result_ids: list[str] = field(default_factory=list)


class Registry:
    """Thread-safe in-memory store with JSON snapshot persistence."""

    def __init__(self, snapshot_dir: str | None = None):
        self._lock = make_rlock("registry")
        self._models: dict[str, ModelSpec] = {}
        self._configs: dict[str, Configuration] = {}
        self._deployments: dict[str, Deployment] = {}
        self._results: dict[str, TrainedResult] = {}
        self._counter = itertools.count(1)
        self.snapshot_dir = snapshot_dir
        if snapshot_dir:
            os.makedirs(snapshot_dir, exist_ok=True)
            self._maybe_load()

    def _next_id(self, prefix: str) -> str:
        return f"{prefix}-{next(self._counter)}"

    # ----------------------------------------------------------------- models
    def register_model(
        self, arch: str, overrides: Mapping[str, Any] | None = None, description: str = ""
    ) -> ModelSpec:
        with self._lock:
            spec = ModelSpec(
                model_id=self._next_id("model"),
                arch=arch,
                overrides=dict(overrides or {}),
                description=description,
            )
            self._models[spec.model_id] = spec
            self._snapshot()
            return spec

    def model(self, model_id: str) -> ModelSpec:
        with self._lock:
            return self._models[model_id]

    # ----------------------------------------------------------- configuration
    def create_configuration(self, model_ids: list[str], description: str = "") -> Configuration:
        with self._lock:
            missing = [m for m in model_ids if m not in self._models]
            if missing:
                raise KeyError(f"unknown model ids {missing}")
            cfg = Configuration(self._next_id("config"), list(model_ids), description)
            self._configs[cfg.config_id] = cfg
            self._snapshot()
            return cfg

    def configuration(self, config_id: str) -> Configuration:
        with self._lock:
            return self._configs[config_id]

    # -------------------------------------------------------------- deployment
    def deploy(
        self,
        config_id: str,
        kind: str = "train",
        *,
        training_kwargs: Mapping[str, Any] | None = None,
        replicas: int = 1,
        input_topic: str | None = None,
        output_topic: str | None = None,
    ) -> Deployment:
        with self._lock:
            if config_id not in self._configs:
                raise KeyError(f"unknown configuration {config_id}")
            dep = Deployment(
                deployment_id=self._next_id("deploy"),
                config_id=config_id,
                kind=kind,
                training_kwargs=dict(training_kwargs or {}),
                replicas=replicas,
                input_topic=input_topic,
                output_topic=output_topic,
            )
            self._deployments[dep.deployment_id] = dep
            self._snapshot()
            return dep

    def deployment(self, deployment_id: str) -> Deployment:
        with self._lock:
            return self._deployments[deployment_id]

    def set_status(self, deployment_id: str, status: str) -> None:
        with self._lock:
            self._deployments[deployment_id].status = status
            self._snapshot()

    # ----------------------------------------------------------------- results
    def upload_result(
        self,
        deployment_id: str,
        model_id: str,
        metrics: Mapping[str, float],
        eval_metrics: Mapping[str, float] | None = None,
        *,
        input_format: str = "RAW",
        input_config: Mapping[str, Any] | None = None,
        artifact_path: str | None = None,
    ) -> TrainedResult:
        with self._lock:
            res = TrainedResult(
                result_id=self._next_id("result"),
                deployment_id=deployment_id,
                model_id=model_id,
                metrics=dict(metrics),
                eval_metrics=dict(eval_metrics or {}),
                input_format=input_format,
                input_config=dict(input_config or {}),
                artifact_path=artifact_path,
            )
            self._results[res.result_id] = res
            dep = self._deployments.get(deployment_id)
            if dep is not None:
                dep.result_ids.append(res.result_id)
            self._snapshot()
            return res

    def result(self, result_id: str) -> TrainedResult:
        with self._lock:
            return self._results[result_id]

    def results_for(self, deployment_id: str) -> list[TrainedResult]:
        with self._lock:
            return [r for r in self._results.values() if r.deployment_id == deployment_id]

    def compare(self, deployment_id: str, metric: str = "loss") -> list[tuple[str, float]]:
        """Rank a configuration's models by a metric (the Web-UI compare view)."""
        rows = [
            (r.model_id, r.eval_metrics.get(metric, r.metrics.get(metric, float("nan"))))
            for r in self.results_for(deployment_id)
        ]
        return sorted(rows, key=lambda x: x[1])

    # ------------------------------------------------------------- persistence
    def _snapshot(self) -> None:
        if not self.snapshot_dir:
            return
        state = {
            "models": {k: vars(v) for k, v in self._models.items()},
            "configs": {k: vars(v) for k, v in self._configs.items()},
            "deployments": {k: vars(v) for k, v in self._deployments.items()},
            "results": {k: vars(v) for k, v in self._results.items()},
        }
        path = os.path.join(self.snapshot_dir, "registry.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f, default=str)
        os.replace(tmp, path)  # atomic: a crash mid-write never corrupts

    def _maybe_load(self) -> None:
        path = os.path.join(self.snapshot_dir, "registry.json")
        if not os.path.exists(path):
            return
        with open(path) as f:
            state = json.load(f)
        self._models = {k: ModelSpec(**v) for k, v in state["models"].items()}
        self._configs = {k: Configuration(**v) for k, v in state["configs"].items()}
        self._deployments = {k: Deployment(**v) for k, v in state["deployments"].items()}
        self._results = {k: TrainedResult(**v) for k, v in state["results"].items()}
        # resume id counter past anything loaded
        mx = 0
        for pool in (self._models, self._configs, self._deployments, self._results):
            for key in pool:
                try:
                    mx = max(mx, int(key.rsplit("-", 1)[1]))
                except (IndexError, ValueError):
                    pass
        self._counter = itertools.count(mx + 1)
