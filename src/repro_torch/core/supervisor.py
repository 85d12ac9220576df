"""Back-end supervisor — the paper's Kubernetes-facing control loop (§IV-B).

In Kafka-ML the back-end asks Kubernetes to run one training Job per model
of a deployed configuration and relies on the orchestrator to restart
failures. This supervisor is that loop, JAX-side: it watches the registry
for `deployed` training deployments, spawns a TrainingJob per model,
restarts crashed jobs from their offset-coupled checkpoints (bounded
retries), and marks deployment status through
``deployed -> running -> finished | failed``.

Jobs run in-process (sequentially or via a thread pool); on a real cluster
each job maps to one pod-slice process group — the lifecycle/restart logic
is identical.
"""

from __future__ import annotations

import dataclasses
import os
import traceback
from typing import Any, Callable

from repro_torch.core.log import StreamBackend
from repro_torch.core.registry import Registry

__all__ = ["JobOutcome", "Supervisor"]


@dataclasses.dataclass
class JobOutcome:
    deployment_id: str
    model_id: str
    attempts: int
    ok: bool
    error: str | None = None


class Supervisor:
    """Deploy-loop for training jobs with bounded restart.

    ``job_factory(deployment, model_spec, ckpt_dir)`` must return an object
    with ``run(batch_size=..., resume=..., **kwargs) -> TrainResult`` —
    normally :class:`repro.train.trainer.TrainingJob`.
    """

    def __init__(
        self,
        log: StreamBackend,
        registry: Registry,
        job_factory: Callable[..., Any],
        *,
        ckpt_root: str,
        max_restarts: int = 2,
    ):
        self.log = log
        self.registry = registry
        self.job_factory = job_factory
        self.ckpt_root = ckpt_root
        self.max_restarts = max_restarts
        self.outcomes: list[JobOutcome] = []

    # ------------------------------------------------------------------ loop
    def pending_deployments(self) -> list[str]:
        return [
            d.deployment_id
            for d in self.registry._deployments.values()  # read-only scan
            if d.kind == "train" and d.status == "deployed"
        ]

    def reconcile(self, **run_kwargs) -> list[JobOutcome]:
        """One pass: run every pending training deployment to completion,
        restarting crashed jobs from their checkpoints."""
        new: list[JobOutcome] = []
        for dep_id in self.pending_deployments():
            dep = self.registry.deployment(dep_id)
            cfg = self.registry.configuration(dep.config_id)
            self.registry.set_status(dep_id, "running")
            all_ok = True
            for model_id in cfg.model_ids:
                outcome = self._run_one(dep_id, model_id, run_kwargs)
                new.append(outcome)
                all_ok &= outcome.ok
            self.registry.set_status(dep_id, "finished" if all_ok else "failed")
        self.outcomes.extend(new)
        return new

    def _run_one(self, dep_id: str, model_id: str, run_kwargs) -> JobOutcome:
        ckpt_dir = os.path.join(self.ckpt_root, f"{dep_id}__{model_id}")
        spec = self.registry.model(model_id)
        dep = self.registry.deployment(dep_id)
        attempts = 0
        last_err: str | None = None
        while attempts <= self.max_restarts:
            attempts += 1
            job = self.job_factory(dep, spec, ckpt_dir)
            try:
                job.run(resume=attempts > 1, **{**dep.training_kwargs, **run_kwargs})
                return JobOutcome(dep_id, model_id, attempts, True)
            except Exception as e:  # noqa: BLE001 — the orchestrator catches all
                last_err = f"{type(e).__name__}: {e}"
                traceback.format_exc()
        return JobOutcome(dep_id, model_id, attempts, False, last_err)
