"""Inference serving — the paper's Algorithm 2 + Replication Controller
(port of ``repro.serve.engine``).

An :class:`InferenceDeployment` runs N replicas of a trained model. All
replicas join one consumer group on the input topic, so the group's
partition assignment load-balances request batches across them (paper
§III-E); a replica that stops heartbeating loses its partitions to the
survivors, and committed offsets mean no request is lost. Each replica
is Algorithm 2: download the trained model, build the deserializer from
the control message captured at training time (paper §IV-E), then read
-> decode -> predict -> send to the output topic.
:class:`TxnOutputPublisher` makes a replica's publish exactly once on a
:class:`~repro_torch.core.cluster.BrokerCluster`.

``TxnOutputPublisher``, ``ReplicaStats``, ``_decode_data`` and
``InferenceDeployment`` keep the JAX package's text;
``InferenceReplica`` keeps it but for its collect line, which turns a
tensor into numpy with :func:`_to_numpy` (``np.asarray`` cannot take a
CUDA tensor). Every predict of a poll is still launched before the first
result is copied back, so the card computes while the host decodes the
next batch. The records keep the dtype ``predict_fn`` returns, so they
are byte-identical to the JAX package's when it returns the same dtype
(f32 probabilities for copd-mlp, int32 tokens for an LM).

``predict_fn`` is pluggable: the copd-mlp forward
(:func:`repro_torch.configs.copd_mlp.predict`), or an LM decode loop
built from :func:`build_prefill_step` and :func:`build_serve_step`. The
port's model holds its weights and its caches count positions, so those
steps drop the JAX steps' ``params`` argument (see their docstrings).
Deployments are host code and run against any
:class:`~repro_torch.core.log.StreamBackend`; they touch the device only
through ``predict_fn``.
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Mapping

import numpy as np
import torch

from repro_torch.core.cluster import ClusterProducer, InvalidTxnState
from repro_torch.core.consumer import ConsumerGroup, RebalanceError
from repro_torch.core.log import ProducerFenced, StreamBackend
from repro_torch.core.registry import Registry, TrainedResult
from repro_torch.data.formats import codec_from_control, decode_span_fields
from repro_torch.models.model import StreamModel, quantized_pspecs

__all__ = [
    "InferenceDeployment",
    "InferenceReplica",
    "TxnOutputPublisher",
    "build_serve_step",
    "build_prefill_step",
]


class TxnOutputPublisher:
    """Transactional produce-and-commit for one consumer-group worker.

    Wraps the exactly-once publish pattern of DESIGN.md §8: outputs and
    the input offsets they were computed from commit in ONE transaction,
    so a worker crash between "produce outputs" and "commit offsets" can
    neither re-serve a polled batch (duplicates downstream) nor drop
    one. The worker owns a stable transactional id — re-creating the
    publisher fences its zombie. Shared by :class:`InferenceReplica`
    and the LM serving workers (:mod:`repro.serve.lm_engine`).
    """

    def __init__(self, log, consumer, member_id: str, transactional_id: str):
        self.log = log
        self.consumer = consumer
        self.member_id = member_id
        self.producer = ClusterProducer(log, transactional_id=transactional_id)

    def txn_aborted(self) -> bool:
        """Whether the producer's current/last transaction is (or will
        be) aborted — drives whether local positions must rewind. A
        durably-decided COMMIT means the positions stand: rewinding them
        would re-deliver (and re-publish) a batch the commit covers."""
        st = self.log.txn_state(self.producer.producer_id)
        return st not in ("prepare_commit", "complete_commit")

    def recover_txn(self) -> bool:
        """Resolve a transaction a previous tick left behind (commit or
        abort raised mid-flight) before starting a new one. Returns True
        when it ended in an abort — local positions were rewound, so the
        CURRENT tick's computed outputs must be discarded too (their
        source records re-deliver at the next poll; publishing them now
        would commit outputs whose offsets were just reset)."""
        prod = self.producer
        try:
            prod.abort_txn()
            self.consumer.reset_positions()
            return True
        except (InvalidTxnState, ProducerFenced):
            pass  # outcome already decided (or we were fenced)
        except Exception:
            pass  # quorum window: outcome still open, try again next tick
        if self.txn_aborted():
            self.consumer.reset_positions()
            return True
        # commit durably decided: finish it (at the transaction's own
        # recorded epoch) so the committed offsets reflect the previous
        # tick's work before the next poll
        try:
            self.log.resolve_txn(prod.producer_id)
        except Exception:
            pass  # controller_tick recovery finishes it
        return False

    def publish(
        self,
        topic: str,
        batches: list[list[bytes]],
        keys: list[list[bytes]] | None = None,
    ) -> int:
        """Produce ``batches`` and commit the consumer's polled offsets
        in one transaction. With ``keys`` (parallel structure to
        ``batches``) records route by key hash — per-tenant partitioning
        — via per-record sends; without, each batch lands on partition 0
        in one append. Returns records published, or 0 when the tick
        must be discarded (recovery rewound positions, or the group
        moved on mid-compute)."""
        prod = self.producer
        if prod.in_txn:
            if self.recover_txn():
                return 0  # positions rewound: this tick's outs re-derive
            if prod.in_txn:
                return 0  # still unresolved (no quorum): skip this tick
        if not batches:
            return 0  # nothing polled: nothing to publish or commit
        self.log.ensure_topic(topic)
        prod.begin_txn()
        try:
            done = 0
            for i, out in enumerate(batches):
                if keys is None:
                    prod.send_batch(topic, out, partition=0)
                else:
                    # send_batch routes the whole batch by keys[0]; keyed
                    # records must fan out per-record to partition by key
                    for v, k in zip(out, keys[i]):
                        prod.send(topic, v, key=k)
                done += len(out)
            group = self.consumer.group
            if (
                self.member_id not in group.members
                or group.generation != self.consumer.generation
            ):
                # the group moved on while we computed (stall → eviction
                # → rebalance): committing these offsets would rewind the
                # new owner. Abort — the aborted outputs are invisible,
                # and the new owner re-serves the batch. (Best-effort
                # fence, same shape as commit_member's generation check;
                # the generation-atomic variant is the KIP-447 follow-up
                # in ROADMAP.)
                prod.abort_txn()
                self.consumer.reset_positions()
                return 0
            prod.send_offsets_to_txn(group.group_id, self.consumer.positions())
            prod.commit_txn()
        except BaseException:
            try:
                prod.abort_txn()
            except Exception:
                pass  # decided or quorum-blocked: resolved below / next tick
            if self.txn_aborted():
                # the abort un-published this tick's work: rewind to the
                # committed offsets so the next poll re-delivers it
                self.consumer.reset_positions()
            raise
        return done


# ------------------------------------------------------------------ serve steps
def build_serve_step(model: StreamModel, mesh=None):
    """Single-token decode step: ``step(caches, tokens, pos) -> (logits,
    caches)``, logits (B, 1, vocab_padded) f32.

    The JAX step is ``(params, caches, tokens, pos)``, jitted with the
    cache donated. Here the model holds its weights, and each attention
    layer's cache counts its own position, so ``pos`` is taken for the
    JAX signature and not read: the step decodes at the cache's position,
    which equals the ``pos`` the JAX loop passes (the prompt length plus
    the tokens decoded so far). The cache is updated in place.

    With a ``mesh`` (the model's own: the model was built on it, each rank
    holding its blocks) the step is the same call on every rank, and
    ``(step, specs)`` is returned as JAX returns ``(jit, pshard)``:
    ``specs`` are the specs of the model's parameter tree
    (``param_pspecs``, through ``quantized_pspecs`` for int8 weights)."""

    def step(caches, tokens, pos):
        return model.decode_step(caches, tokens)

    if mesh is None:
        return step
    if mesh is not model.mesh:
        raise ValueError("build_serve_step(model, mesh): the model was not built on this mesh")
    specs = model.param_pspecs()
    if model.policy.weights_int8:
        specs = quantized_pspecs(model.float_shapes(), specs)
    return step, specs


def build_prefill_step(model: StreamModel, s_cache: int, mesh=None):
    """Prompt prefill: ``step(batch) -> (logits, caches)``. ``batch["tokens"]``
    is (B, S) equal-length prompts (numpy or a tensor); logits are the
    last position's (B, vocab_padded) f32 and the cache is a dense
    ``init_cache`` of ``s_cache`` slots in bf16, the JAX default. The
    JAX step is ``(params, batch)``; the model holds its weights here.
    Attention runs the flash-attention kernel on the card. With a ``mesh``
    (the model's own) every rank passes the whole batch and gets the whole
    batch's logits and its blocks of the cache."""
    if mesh is not None and mesh is not model.mesh:
        raise ValueError("build_prefill_step(model, s_cache, mesh): the model was not built on this mesh")

    def step(batch):
        tokens = batch["tokens"]
        if not isinstance(tokens, torch.Tensor):  # a read-only view of the log
            tokens = torch.tensor(tokens, device=model.device)
        return model.prefill(tokens, s_cache)

    return step


# ------------------------------------------------------------------- replicas
@dataclasses.dataclass
class ReplicaStats:
    processed: int = 0
    batches: int = 0
    errors: int = 0


class InferenceReplica:
    """One containerized inference worker (paper Algorithm 2)."""

    def __init__(
        self,
        replica_id: str,
        log: StreamBackend,
        group: ConsumerGroup,
        result: TrainedResult,
        predict_fn: Callable[[Mapping[str, np.ndarray]], np.ndarray],
        output_topic: str,
        transactional: bool = False,
    ):
        self.replica_id = replica_id
        self.log = log
        # transactional publish (DESIGN.md §8), via TxnOutputPublisher
        txn = transactional and hasattr(log, "init_producer")
        self.consumer = group.join(
            replica_id,
            isolation_level="read_committed" if txn else None,
        )
        self._publisher = (
            TxnOutputPublisher(
                log, self.consumer, replica_id,
                transactional_id=f"{group.group_id}-{replica_id}",
            )
            if txn
            else None
        )
        # getDeserializer(input_configuration): auto-configured from the
        # training control message (paper §IV-E)
        self.codec = codec_from_control(result.input_format, result.input_config)
        self.predict_fn = predict_fn
        self.output_topic = output_topic
        self.stats = ReplicaStats()
        self.alive = True

    def poll_once(self, max_records: int = 256) -> int:
        """One loop iteration: read -> decode -> predict -> produce."""
        return self.publish(self.poll_compute(max_records))

    def poll_compute(self, max_records: int = 256) -> list[list[bytes]] | None:
        """The parallel-safe half of a poll: read assigned partitions,
        decode, predict — everything except publishing. Returns encoded
        output batches for :meth:`publish`, or None if this replica is
        dead. Splitting the tick lets a deployment run every replica's
        compute concurrently while still publishing (and committing) in
        replica order, so the output stream stays deterministic."""
        if not self.alive:
            return None
        if self.replica_id not in self.consumer.group.members:
            # evicted while alive (heartbeats lapsed under load, not a
            # crash): re-enter the group and resume from committed
            # offsets next tick — without this a momentarily-stalled
            # replica would stay silent forever
            self.consumer.rejoin()
            return None
        outs: list[list[bytes]] = []
        # poll-to-predict latency (no-op on backends with no registry)
        reg = getattr(self.log, "metrics", None)
        instrument = reg is not None and reg.enabled
        t0 = time.perf_counter() if instrument else 0.0
        try:
            polled = self.consumer.poll(max_records)
        except RebalanceError:
            # expired between the membership check above and the poll
            # (failure detection ran concurrently): rejoin and skip the
            # tick instead of killing the deployment's poll thread
            self.consumer.rejoin()
            return None
        # dispatch/collect split (DESIGN.md §10): predict for batch i is
        # dispatched before batch i+1 is decoded — with a jitted
        # predict_fn, JAX's async dispatch returns immediately and the
        # device computes batch i while the host zero-copy decodes i+1.
        # Results are collected (np.asarray blocks on the device) only
        # after every dispatch is in flight.
        pending = []
        for batch in polled:
            pending.append(self.predict_fn(self._decode_batch(batch)))
        for preds in pending:
            preds = _to_numpy(preds)
            outs.append([preds[i].tobytes() for i in range(preds.shape[0])])
        if instrument and outs:
            reg.histogram(
                "serve_poll_to_predict_seconds", replica=self.replica_id
            ).record(time.perf_counter() - t0)
            reg.counter(
                "serve_predictions_total", replica=self.replica_id
            ).inc(sum(len(o) for o in outs))
        return outs

    def _decode_batch(self, batch) -> dict[str, np.ndarray]:
        """Decode a polled request batch to its data fields, zero-copy
        when framed (DESIGN.md §10).

        Inference streams carry only the data fields; full-record
        streams (training-format replays) are tolerated by slicing the
        data prefix. Either layout takes the framed strided-view path
        when the fetch is contiguous; a filtered/ragged fetch falls back
        to the copying matrix decode.
        """
        data_fields = list(
            getattr(self.codec, "data_fields", self.codec.fields[:-1])
        )
        data_bytes = sum(f.nbytes for f in data_fields)
        if batch.framed(self.codec.record_bytes) is not None:
            full = self.codec.decode_frames(batch)
            return {f.name: full[f.name] for f in data_fields}
        spans = batch.framed(data_bytes)
        if spans is not None:
            # data-only records: frame against the data-prefix layout
            offs, pos = [], 0
            for f in data_fields:
                offs.append(pos)
                pos += f.nbytes
            parts = [
                decode_span_fields(mv, cnt, data_fields, offs, data_bytes)[0]
                for mv, cnt in spans
            ]
            if len(parts) == 1:
                return parts[0]
            return {
                f.name: np.concatenate([p[f.name] for p in parts], axis=0)
                for f in data_fields
            }
        return _decode_data(self.codec, batch.to_matrix(), data_bytes)

    def publish(self, outs: list[list[bytes]] | None) -> int:
        """Produce computed predictions, then commit the read offsets —
        commit-after-produce keeps delivery at-least-once (a crash between
        the two re-polls the batch). A transactional replica upgrades the
        pair to exactly-once: predictions and offsets commit atomically."""
        if outs is None:
            return 0
        if self._publisher is not None:
            done = self._publisher.publish(self.output_topic, outs)
            if done:
                self.stats.processed += done
                self.stats.batches += len(outs)
            return done
        done = 0
        if outs:
            self.log.ensure_topic(self.output_topic)
        for out in outs:
            self.log.produce_batch(self.output_topic, out, partition=0)
            self.stats.processed += len(out)
            self.stats.batches += 1
            done += len(out)
        self.consumer.commit()
        return done

    def kill(self) -> None:
        """Simulated crash: stops heartbeating (the group expires it)."""
        self.alive = False


def _to_numpy(preds) -> np.ndarray:
    """A prediction on the host: a tensor (on any device) through
    ``.cpu().numpy()``, which blocks until the device has computed it;
    numpy passes through unchanged."""
    if isinstance(preds, torch.Tensor):
        return preds.cpu().numpy()
    return np.asarray(preds)


def _decode_data(codec, mat: np.ndarray, data_bytes: int) -> dict[str, np.ndarray]:
    if mat.shape[1] == codec.record_bytes:
        full = codec.decode_matrix(mat)
        names = [f.name for f in getattr(codec, "data_fields", codec.fields[:-1])]
        return {k: full[k] for k in names}
    # data-only records
    out: dict[str, np.ndarray] = {}
    off = 0
    for f in getattr(codec, "data_fields", codec.fields[:-1]):
        chunk = np.ascontiguousarray(mat[:, off : off + f.nbytes])
        out[f.name] = chunk.view(np.dtype(f.dtype)).reshape((mat.shape[0],) + f.shape)
        off += f.nbytes
    return out


class InferenceDeployment:
    """The Replication Controller: N replicas on one consumer group.

    ``parallel_poll=True`` (default) drives the replicas' compute phases
    (read → decode → predict) concurrently from a worker pool: each
    replica owns disjoint partitions (consumer-group range assignment),
    so on a cluster with per-partition locking their reads don't contend
    and one slow replica no longer stalls the whole tick's compute.
    Outputs are then published — and offsets committed — serially in
    replica order, so the output topic's record order is identical to a
    serial tick's.

    ``transactional=True`` (clusters only) makes each replica publish its
    predictions atomically with the input offsets they answer — a replica
    crash mid-tick can neither duplicate nor drop a served request batch,
    and downstream read_committed consumers of the prediction topic never
    observe a half-published tick. Replicas then also read their input
    read_committed, composing end-to-end exactly-once with a
    transactional upstream (DESIGN.md §8).
    """

    def __init__(
        self,
        log: StreamBackend,
        registry: Registry,
        result_id: str,
        predict_fn,
        *,
        input_topic: str,
        output_topic: str,
        replicas: int = 2,
        session_timeout_s: float = 5.0,
        parallel_poll: bool = True,
        transactional: bool = False,
        clock=None,
    ):
        self.log = log
        self.result = registry.result(result_id)
        self.group = ConsumerGroup(
            log,
            group_id=f"infer-{result_id}",
            topics=[input_topic],
            session_timeout_s=session_timeout_s,
            clock=clock,
        )
        self.replicas = [
            InferenceReplica(
                f"replica-{i}", log, self.group, self.result, predict_fn,
                output_topic, transactional=transactional,
            )
            for i in range(replicas)
        ]
        self.input_topic = input_topic
        self.output_topic = output_topic
        self.parallel_poll = parallel_poll
        self._pool: ThreadPoolExecutor | None = None

    def poll_all(self) -> int:
        """Drive every live replica one iteration (the K8s 'tick')."""
        for r in self.replicas:  # live replicas heartbeat, dead ones don't
            if r.alive and r.replica_id in self.group.members:
                self.group.heartbeat(r.replica_id)
        self.group.expire_dead_members()
        if self.parallel_poll and len(self.replicas) > 1:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=len(self.replicas),
                    thread_name_prefix="replica-poll",
                )
            # compute in parallel, publish+commit in replica order. One
            # replica's failure must not abandon siblings' already-polled
            # work (their consumer positions advanced): publish every
            # healthy result first, then re-raise the first error.
            futs = [self._pool.submit(r.poll_compute) for r in self.replicas]
            total = 0
            first_err: BaseException | None = None
            for r, f in zip(self.replicas, futs):
                try:
                    total += r.publish(f.result())
                except BaseException as e:
                    if first_err is None:
                        first_err = e
            if first_err is not None:
                raise first_err
            return total
        return sum(r.poll_once() for r in self.replicas)

    def close(self) -> None:
        """Release the polling pool (idempotent)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __del__(self):  # backstop for call sites that never close()
        try:
            if self._pool is not None:
                self._pool.shutdown(wait=False)
        except Exception:
            pass

    def kill_replica(self, idx: int) -> None:
        self.replicas[idx].kill()

    def drain(self, max_iters: int = 100) -> int:
        total = 0
        for _ in range(max_iters):
            got = self.poll_all()
            total += got
            if got == 0:
                break
        return total
