"""Training jobs (port of ``repro.train.trainer``): the paper's Algorithm 1
on one device.

* :func:`build_train_step` — the train step for the model zoo, with
  optional microbatch gradient accumulation (``_to_microbatches``, data
  parallelism of 1 until the multi-GPU work).
* :class:`TrainingJob` — the Kafka-ML training Job (paper §IV-C): block on
  the control topic for its deployment_id, read the stream (train/eval
  split per validation_rate), train, upload the result and metrics to the
  registry. Checkpoints embed the stream offsets; ``resume=True`` restarts
  exactly where a killed job died.

Interfaces follow the JAX package: ``loss_fn(params, batch) -> (loss,
metrics)`` over a parameter tree in the JAX layout (a ``StreamModel``'s
``param_tree()``, whose leaves are its parameters), ``init_fn`` makes the
parameters, ``opt`` is an :class:`~repro_torch.train.optimizer.Optimizer`.
Differences that belong to PyTorch: ``init_fn`` takes a
``torch.Generator`` (seeded from ``seed`` on the job's device) where JAX
takes a PRNG key; gradients come from ``torch.autograd.grad`` over the
tree's leaves, which the job sets to require grad; the optimizer updates
the parameters in place; batches land on ``device`` (the card unless the
caller passes ``device="cpu"``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.control import ControlMessage, poll_control
from repro_torch.core.controller import ClusterError
from repro_torch.core.log import StreamBackend
from repro_torch.core.registry import Registry
from repro_torch.data.pipeline import BatchIterator, StreamDataset, StreamingBatchIterator, device_feed
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.optimizer import Optimizer, adamw, tree_leaves, tree_unflatten

__all__ = ["TrainResult", "TrainingJob", "build_train_step", "make_state"]


def make_state(model, opt: Optimizer, generator: torch.Generator | int) -> dict:
    """Fresh weights from ``generator`` and a fresh optimizer state; the
    parameters are set to require grad."""
    params = model.init(generator)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return {"params": params, "opt": opt.init(params)}


def _to_microbatches(x: torch.Tensor, k: int, dp: int = 1) -> torch.Tensor:
    """(B, ...) -> (k, B/k, ...) such that every microbatch spans every
    data shard: shard d's rows are dealt round-robin to the k steps, as
    in JAX (with dp = 1 a plain reshape)."""
    b = x.shape[0]
    bl = b // (dp * k)
    y = x.reshape((dp, k, bl) + tuple(x.shape[1:]))
    y = torch.movedim(y, 1, 0)  # (k, dp, bl, ...)
    return y.reshape((k, dp * bl) + tuple(x.shape[1:]))


def _grads(loss: torch.Tensor, params) -> list[torch.Tensor]:
    """d loss / d every leaf of ``params``, in JAX's leaf order."""
    return list(torch.autograd.grad(loss, tree_leaves(params)))


def build_train_step(model, opt: Optimizer, *, microbatches: int = 1):
    """Returns (step_fn, None). ``step_fn(state, batch) -> (state, metrics)``
    updates ``state`` in place; ``batch`` holds tensors on the model's
    device. With ``microbatches`` k > 1 the gradients of the k
    microbatches are summed in f32 buffers, each divided by k, as the JAX
    scan does (``.grad`` would sum in the parameters' dtype)."""

    def step(state, batch):
        params = state["params"]
        b0 = next(iter(batch.values())).shape[0]
        dp = 1
        k = min(microbatches, max(b0 // max(dp, 1), 1))  # each microbatch must cover DP
        if k > 1:
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in tree_leaves(params)]
            loss_acc = torch.zeros((), dtype=torch.float32, device=acc[0].device)
            mbs = {key: _to_microbatches(x, k, dp) for key, x in batch.items()}
            for i in range(k):
                loss, _ = model.loss(params, {key: x[i] for key, x in mbs.items()})
                for a, g in zip(acc, _grads(loss, params)):
                    a.add_(g.float() / k)
                loss_acc = loss_acc + loss.detach() / k
            grads = tree_unflatten(params, acc)
            metrics = {"loss": loss_acc}
        else:
            loss, metrics = model.loss(params, batch)
            grads = tree_unflatten(params, _grads(loss, params))
            metrics = {key: v.detach() for key, v in metrics.items()}
        opt.update(grads, state["opt"], params)
        return state, {**metrics, "loss": metrics["loss"]}

    return step, None


# ------------------------------------------------------------- Training Job
@dataclasses.dataclass
class TrainResult:
    metrics: dict[str, float]
    eval_metrics: dict[str, float]
    steps: int
    control: ControlMessage


class TrainingJob:
    """Paper §IV-C Algorithm 1, with checkpoint/restart fault tolerance.

    One Job trains one model of a deployed configuration. ``run`` blocks
    on the control topic until a control message targets this deployment,
    then trains over the referenced stream ranges.
    """

    def __init__(
        self,
        log: StreamBackend,
        registry: Registry,
        deployment_id: str,
        model_id: str,
        *,
        loss_fn: Callable,  # (params, batch) -> (loss, metrics)
        init_fn: Callable,  # torch.Generator -> params
        opt: Optimizer | None = None,
        ckpt_dir: str | None = None,
        ckpt_every: int = 50,
        seed: int = 0,
        isolation_level: str | None = None,
        device: str | torch.device | None = None,
    ):
        self.log = log
        self.registry = registry
        self.deployment_id = deployment_id
        self.model_id = model_id
        self.loss_fn = loss_fn
        self.init_fn = init_fn
        self.opt = opt or adamw(1e-3)
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.seed = seed
        # "read_committed" pairs with ingest(transactional=True): the job
        # only ever acts on a control message whose whole stream is
        # durably committed
        self.isolation_level = isolation_level
        self.device = resolve_device(device)
        self.manager = (
            ckpt_lib.CheckpointManager(ckpt_dir) if ckpt_dir is not None else None
        )

    # ---------------------------------------------------------------- control
    def wait_for_control(self, poll_interval: float = 0.0, max_polls: int = 1000):
        """Algorithm 1's readControlStreams loop. A control topic that is
        momentarily unreadable mid-election counts as an empty poll and the
        loop retries, so a waiting job survives a broker or controller
        failover."""
        offset = 0
        for _ in range(max_polls):
            try:
                msg, offset = poll_control(
                    self.log, self.deployment_id, offset,
                    isolation=self.isolation_level,
                )
            except ClusterError:
                msg = None  # control topic unavailable mid-election
            if msg is not None:
                return msg
            if poll_interval:
                time.sleep(poll_interval)
        raise TimeoutError(
            f"no control message for deployment {self.deployment_id!r}"
        )

    def _to_device(self, batch) -> dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}

    # ------------------------------------------------------------------- run
    def run(
        self,
        *,
        batch_size: int,
        epochs: int = 1,
        resume: bool = False,
        max_steps: int | None = None,
        prefetch: int = 2,  # batches assembled ahead of the device step
        streaming: bool = False,
        fetch_records: int = 4096,
        crash_after: int | None = None,  # fault-injection hook for tests
    ) -> TrainResult:
        """Train over the announced stream.

        ``streaming=False`` (default) materializes the stream on the host
        (``StreamDataset.split()``) and trains with a seeded global
        shuffle. ``streaming=True`` is the broker -> device path: a
        :class:`StreamingBatchIterator` polls the consumer
        ``fetch_records`` records at a time and :func:`device_feed` copies
        each batch to the card on a stream of its own while the previous
        step runs; resume fast-forwards by offset arithmetic. Both modes
        yield a deterministic batch sequence, so checkpoints resume exactly
        either way.
        """
        msg = self.wait_for_control()

        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        params = self.init_fn(gen)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        state = {"params": params, "opt": self.opt.init(params)}
        start_step = 0
        if resume and self.manager is not None and self.manager.latest() is not None:
            state, offsets, meta = ckpt_lib.restore(self.ckpt_dir, state)
            start_step = int(meta.get("next_step", 0))

        def step_fn(state, batch):
            loss, metrics = self.loss_fn(state["params"], batch)
            grads = tree_unflatten(state["params"], _grads(loss, state["params"]))
            self.opt.update(grads, state["opt"], state["params"])
            return state, {k: v.detach() for k, v in metrics.items()}

        eval_arrays: dict[str, np.ndarray] | None = None
        if streaming:
            it = StreamingBatchIterator(
                self.log, msg, batch_size, split="train", epochs=None,
                fetch_records=fetch_records,
            )
            # resume = offset arithmetic: no records are fetched, decoded,
            # or copied for the fast-forwarded prefix
            it.fast_forward(start_step)
        else:
            ds = StreamDataset(self.log, msg)
            train_arrays, eval_arrays = ds.split()
            it = BatchIterator(
                train_arrays, batch_size, seed=self.seed, epochs=None,
                shuffle=True, prefetch=prefetch,
            )
        steps_per_epoch = it.steps_per_epoch()
        total = max_steps if max_steps is not None else epochs * steps_per_epoch

        metrics = {}
        # training throughput metrics (no-op on backends with no registry)
        reg = getattr(self.log, "metrics", None)
        instrument = reg is not None and reg.enabled
        if streaming:
            stream = device_feed(iter(it), device=self.device, depth=prefetch)
        else:
            stream = iter(it)
        try:
            if not streaming:
                # deterministic resume: fast-forward the shuffled stream
                for _ in range(start_step):
                    next(stream)
            for step_i in range(start_step, total):
                t0 = time.perf_counter() if instrument else 0.0
                nxt = next(stream)
                batch = nxt if streaming else self._to_device(nxt)
                state, m = step_fn(state, batch)
                metrics = {k: float(v) for k, v in m.items()}
                if instrument:
                    dt = time.perf_counter() - t0
                    reg.histogram(
                        "train_step_seconds", deployment=self.deployment_id
                    ).record(dt)
                    reg.counter(
                        "train_records_total", deployment=self.deployment_id
                    ).inc(batch_size)
                    if dt > 0:
                        reg.gauge(
                            "train_records_per_s",
                            deployment=self.deployment_id,
                        ).set(batch_size / dt)
                done = step_i + 1
                if self.manager is not None and done % self.ckpt_every == 0:
                    self.manager.save_async(
                        done,
                        state,
                        offsets={str(r): r.end for r in msg.ranges},
                        meta={"next_step": done, "deployment_id": self.deployment_id},
                    )
                if crash_after is not None and done >= crash_after:
                    self.manager and self.manager.wait()
                    raise RuntimeError(f"injected crash after step {done}")
        finally:
            # the epochs=None stream is infinite: stop its prefetch worker
            close = getattr(stream, "close", None)
            if close is not None:
                close()
        if self.manager is not None:
            self.manager.save_async(
                total, state, offsets={str(r): r.end for r in msg.ranges},
                meta={"next_step": total, "deployment_id": self.deployment_id},
            )
            self.manager.wait()

        eval_metrics = {}
        n_eval = int(round(msg.total_msg * msg.validation_rate))
        with torch.no_grad():
            if streaming:
                if msg.validation_rate > 0 and n_eval > 0:
                    # bounded-memory eval: stream the tail split in batches
                    # and average the metric means (equal-size batches)
                    acc: dict[str, float] = {}
                    seen = 0
                    ev = StreamingBatchIterator(
                        self.log, msg, min(batch_size, n_eval), split="eval",
                        epochs=1, fetch_records=fetch_records,
                    )
                    for eb in device_feed(iter(ev), device=self.device, depth=prefetch):
                        _, em = self.loss_fn(state["params"], eb)
                        for k, v in em.items():
                            acc[k] = acc.get(k, 0.0) + float(v)
                        seen += 1
                    eval_metrics = {k: v / seen for k, v in acc.items()}
            elif msg.validation_rate > 0 and next(iter(eval_arrays.values())).shape[0] > 0:
                _, em = self.loss_fn(state["params"], self._to_device(eval_arrays))
                eval_metrics = {k: float(v) for k, v in em.items()}

        artifact = None
        if self.ckpt_dir is not None:
            artifact = self.ckpt_dir
        self.registry.upload_result(
            self.deployment_id,
            self.model_id,
            metrics,
            eval_metrics,
            input_format=msg.input_format,
            input_config=msg.input_config,
            artifact_path=artifact,
        )
        self._final_state = state
        return TrainResult(metrics, eval_metrics, total, msg)
