"""Replicated broker cluster — multi-broker StreamLog with ISR replication.

The paper's fault-tolerance and high-availability claims (abstract, §II,
§V) rest on Kafka's *replicated* distributed log: every partition lives on
``replication_factor`` brokers, one of which is the **leader** (serves all
produce/fetch traffic) while the rest are **followers** that replicate the
leader's log by fetching from it. This module supplies that substrate for
the JAX-side reproduction:

* :class:`BrokerCluster` — N in-process brokers, each backed by its own
  :class:`~repro.core.log.StreamLog`. Topics are created with per-partition
  **replica sets** (round-robin placement), a deterministic **preferred
  leader**, an **in-sync-replica (ISR)** set, and a **high watermark** (HW):
  the largest offset known to be on every ISR member. Consumers only ever
  see records below the HW, so an acknowledged-and-visible record can never
  be un-read by a failover.
* **Producer acks** (paper §II's durability/latency trade-off):
  ``acks=0`` fire-and-forget, ``acks=1`` leader-only append, ``acks='all'``
  append + synchronous ISR replication + HW advance before the call
  returns. An ``acks='all'`` record survives the loss of any single broker
  *provided the ISR held >= 2 members when it was acknowledged* — as in
  Kafka, set ``min_insync_replicas=2`` to make the broker reject appends
  whenever that precondition doesn't hold (topics created without an
  explicit config get ``min(2, rf)``).
* **Leader election** — when a broker dies or is network-partitioned, every
  partition it led elects the lowest-id in-sync survivor (deterministic),
  bumps the partition **epoch** (fences stale clients), and shrinks the
  ISR. A rejoining broker truncates its log to the HW (discarding unacked
  suffix records, Kafka's log reconciliation) and re-fetches from the new
  leader until it is back in sync.
* :class:`ClusterProducer` / :class:`ClusterConsumer` — failover-aware
  clients: they cache partition metadata, route to the cached leader, and
  on :class:`NotLeaderError` / :class:`BrokerUnavailable` refresh metadata
  and retry — exactly the real Kafka client protocol loop.
  ``ClusterProducer(idempotent=True)`` stamps batches with a
  quorum-committed ``(pid, epoch)`` identity and per-partition sequences,
  turning that retry loop **exactly-once**: a re-sent committed batch
  dedups on the leader (and on any follower that inherits leadership) to
  its original offsets — see DESIGN.md §7.

Concurrency model (DESIGN.md §4). The data plane is partition-parallel:

* a cluster-wide **metadata lock** guards topology only (topic create or
  delete, broker up/down transitions, the consumer-offset store);
* each partition carries its own **controller lock** serializing that
  partition's produces, fetches, replication passes, elections, ISR and
  HW updates. Produces/fetches to *different* partitions never contend.
* The lock hierarchy is strictly ``metadata lock → partition lock``
  (never reversed), so topology events may sweep partitions but
  partition-level work never blocks on topology.
* :class:`ReplicationService` is the background follower-fetch daemon:
  worker threads drive replication passes for every partition on a
  configurable interval, advancing HWs and completing leader elections
  without any client on the hot path.
* **Follower reads** — a fetch addressed to an *in-sync* follower may be
  served from its local log, capped at the high watermark. Records below
  the HW are immutable and identical on every ISR member, so follower
  reads are stale-bounded but never wrong; serving replicas keep
  answering while a leader election is in flight.

The cluster also implements the full :class:`~repro.core.log.StreamBackend`
surface (``produce_batch``/``read``/``read_range``/offset store/…), so the
data pipeline, consumer groups, control plane, trainer and serving engine
all run unchanged against either a bare ``StreamLog`` or a cluster — see
DESIGN.md §"Cluster".

The consumer-offset store (Kafka's ``__consumer_offsets``) is held by the
cluster controller and mirrored onto every live broker, i.e. replicated at
the full cluster width, so committed offsets survive any broker loss.

Transactions (DESIGN.md §8). The cluster doubles as the **transaction
coordinator**: ``begin_txn``/``txn_add_partitions``/``txn_add_offsets``/
``commit_txn``/``abort_txn`` drive a two-phase commit whose every state
transition is a committed ``MetadataCommand`` in the replicated metadata
log — so a transaction whose driver (or controller leader) dies after
the ``PrepareCommit`` decision is finished by any later
``controller_tick``: COMMIT/ABORT control markers land on every
registered partition, attached consumer offsets apply exactly with the
commit, and every touched partition converges to the same outcome.
:class:`ClusterProducer(transactional_id=...)` is the client half
(``begin_txn``/``send_offsets_to_txn``/``commit_txn``/``abort_txn``
layered on the idempotent machinery), and
``ClusterConsumer(isolation_level="read_committed")`` the consumer half
(LSO-capped fetches, aborted ranges filtered).

Control plane (DESIGN.md §5). Topology is no longer mutated in place:
every topology change — broker liveness, partition leadership, ISR
membership, topic create/delete — is a :class:`MetadataCommand` committed
through the :class:`~repro.core.controller.QuorumController`'s replicated
metadata log (majority of N controller nodes) and only then applied to
the partition ctls. The controller itself fails over by quorum election
(``kill_controller`` + a daemon tick), and a partitioned controller
minority can neither elect nor commit, so the control plane has no single
point of failure and no split-brain window. The lock hierarchy gains a
leaf: ``metadata lock → partition lock → controller lock``.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import weakref
from dataclasses import asdict, dataclass, replace
from typing import Callable, Iterator, Sequence

from repro_torch.analysis.witness import make_lock, make_rlock
from repro_torch.core.controller import (
    ClusterError,
    ControllerUnavailable,
    MetadataCommand,
    QuorumController,
)
from repro_torch.core.log import (
    LogConfig,
    OffsetOutOfRange,
    ProducerFenced,
    RecordBatch,
    StreamLog,
    TopicPartition,
    default_partition,
)
from repro_torch.core.metrics import METRICS_TOPIC, MetricsRegistry

__all__ = [
    "Broker",
    "BrokerCluster",
    "BrokerUnavailable",
    "ClusterConsumer",
    "ClusterError",
    "ClusterProducer",
    "ControllerUnavailable",
    "InvalidTxnState",
    "METRICS_TOPIC",
    "MetricsReporter",
    "NotEnoughReplicasError",
    "NotLeaderError",
    "PartitionMeta",
    "PartitionOffline",
    "ProducerFenced",
    "ReplicationService",
]

_REPLICA_FETCH_CHUNK = 4096
_ROUTED_RETRIES = 8


# ------------------------------------------------------------------ errors
# ClusterError itself lives in repro.core.controller (the shared base
# module) and is re-exported here; ControllerUnavailable subclasses it so
# `except ClusterError` retry loops cover controller-quorum windows too.
class NotLeaderError(ClusterError):
    """The addressed broker is not the current leader for the partition.

    Carries a ``leader_hint`` (the current leader's broker id, or None)
    so clients can refresh their metadata cache and retry — Kafka's
    NOT_LEADER_OR_FOLLOWER error code.
    """

    def __init__(self, topic: str, partition: int, leader_hint: int | None):
        super().__init__(
            f"not leader for {topic}:{partition} (current leader: {leader_hint})"
        )
        self.topic = topic
        self.partition = partition
        self.leader_hint = leader_hint


class BrokerUnavailable(ClusterError):
    """The addressed broker is dead or unreachable."""


class PartitionOffline(ClusterError):
    """No eligible (in-sync, live) leader candidate exists."""


class NotEnoughReplicasError(ClusterError):
    """acks=all rejected: live ISR smaller than ``min_insync_replicas``."""


class InvalidTxnState(RuntimeError):
    """A transactional operation was attempted in a state that forbids it
    (begin while a transaction is already in progress, commit with no
    transaction, abort of a transaction whose commit is already durably
    decided, ...). Deliberately NOT a ``ClusterError``: retry loops must
    not re-drive a structurally invalid request — the caller's state
    machine is wrong, not the cluster's availability."""


class _TxnState:
    """Coordinator-side state of one producer's transaction, reconstructed
    purely by applying committed txn ``MetadataCommand``s in log order —
    so a controller successor holds exactly the same view.

    ``state``: ``ongoing`` → ``prepare_commit``/``prepare_abort`` (the
    durable decision) → ``complete_commit``/``complete_abort`` (markers
    written everywhere, offsets applied). ``seq`` is the per-pid command
    sequence (the transactional pversion) guarding idempotent replay.
    """

    __slots__ = (
        "pid", "epoch", "state", "seq", "partitions", "offsets", "touched",
    )

    def __init__(self, pid: int, epoch: int, seq: int):
        self.pid = pid
        self.epoch = epoch
        self.state = "ongoing"
        self.seq = seq
        self.partitions: set[tuple[str, int]] = set()
        # group -> {"topic:partition" -> offset} committed atomically
        # with the transaction's produced records
        self.offsets: dict[str, dict[str, int]] = {}
        # local wall-clock of the last applied command for this txn — the
        # transaction-timeout reference (coordinator-local bookkeeping,
        # not replicated state: the timeout *abort* goes through the
        # quorum like any other decision)
        self.touched = 0.0


# ------------------------------------------------------------------- broker
@dataclass
class Broker:
    """One broker: an id plus its local :class:`StreamLog` replica store.

    ``alive`` models a crash (process gone); ``reachable`` models a network
    partition (process up but unreachable). Either way the broker is *down*
    from the cluster's point of view.
    """

    broker_id: int
    log: StreamLog
    alive: bool = True
    reachable: bool = True

    @property
    def up(self) -> bool:
        return self.alive and self.reachable


@dataclass(frozen=True)
class PartitionMeta:
    """Client-visible metadata for one partition (Kafka MetadataResponse)."""

    topic: str
    partition: int
    leader: int | None
    epoch: int
    replicas: tuple[int, ...]
    isr: frozenset[int]
    high_watermark: int


class _PartitionCtl:
    """Controller-side replication state for one partition.

    ``lock`` serializes every data-plane operation touching this partition
    (produce, fetch, replication pass, election, ISR/HW update) — the
    per-partition half of the lock hierarchy. Holders of a partition lock
    must never acquire the cluster metadata lock.
    """

    __slots__ = (
        "topic",
        "partition",
        "replicas",
        "leader",
        "epoch",
        "isr",
        "hw",
        "epoch_starts",
        "synced_epoch",
        "version",
        "gen",
        "lock",
        "m_produce",
        "m_repl",
        "m_fetch",
    )

    def __init__(
        self,
        topic: str,
        partition: int,
        replicas: list[int],
        lock: threading.RLock | None = None,
        gen: int = 0,
    ):
        self.topic = topic
        self.partition = partition
        self.replicas = list(replicas)
        self.leader: int | None = replicas[0]
        self.epoch = 0
        self.isr: set[int] = set(replicas)
        self.hw = 0
        # metadata version: bumped by every applied controller command for
        # this partition; application is guarded by `pversion > version`,
        # which makes controller-failover replay idempotent
        self.version = 0
        # owning topic's generation (fences replays against a same-name
        # recreated topic)
        self.gen = gen
        # Kafka's leader-epoch checkpoint: epoch -> first offset written in
        # that epoch. A rejoining replica truncates to the start of the
        # first epoch it missed — records above may be a deposed leader's
        # divergent unacked suffix, even below the since-advanced HW.
        self.epoch_starts: dict[int, int] = {0: 0}
        # last epoch each replica fully caught up in
        self.synced_epoch: dict[int, int] = {b: 0 for b in replicas}
        self.lock = lock if lock is not None else make_rlock(
            "partition", name=f"partition:{topic}:{partition}")
        # lazily bound per-partition metric handles (produce / replication
        # / fetch record counters): the hot path must not pay a series-key
        # format + registry lookup per batch (DESIGN §9 overhead budget)
        self.m_produce = None
        self.m_repl = None
        self.m_fetch = None

    def meta(self) -> PartitionMeta:
        with self.lock:
            return PartitionMeta(
                topic=self.topic,
                partition=self.partition,
                leader=self.leader,
                epoch=self.epoch,
                replicas=tuple(self.replicas),
                isr=frozenset(self.isr),
                high_watermark=self.hw,
            )


# ------------------------------------------------------- replication daemon
class ReplicationService:
    """Background follower-fetch daemon for a :class:`BrokerCluster`.

    ``workers`` threads share the partition set (partition *i* belongs to
    worker ``i % workers``); each runs a replication pass for its
    partitions every ``interval_s`` seconds, advancing high watermarks,
    pruning dead followers from ISRs and — because a pass resolves the
    partition leader — completing leader elections for partitions whose
    leader died, all off the client hot path. This replaces the explicit
    ``replicate_all()`` ticks (which remain available) with the same
    leader-epoch reconciliation guarantees: a pass is exactly
    ``BrokerCluster.replicate_partition`` under the partition lock.

    Worker 0 additionally drives the **controller heartbeat**
    (``BrokerCluster.controller_tick``) once per sweep: quorum lease
    renewal, controller-leader election on failure, and application of
    any committed-but-unapplied metadata backlog — so a controller-leader
    kill fails over within one daemon interval with no client involved.

    ``start``/``stop`` are idempotent; the service is also a context
    manager. Unexpected per-partition errors are collected on ``errors``
    (bounded) instead of killing the worker. The service holds its
    cluster only weakly: workers exit on their own once every other
    reference to the cluster is dropped, so a caller that forgets
    ``stop_replication()`` leaks neither the cluster nor a busy loop.
    """

    def __init__(
        self,
        cluster: "BrokerCluster",
        *,
        interval_s: float = 0.02,
        workers: int = 2,
    ):
        self._cluster_ref = weakref.ref(cluster)
        self.interval_s = interval_s
        self.workers = max(1, int(workers))
        self.errors: list[BaseException] = []
        self.passes = 0  # completed sweeps by worker 0 (progress probe)
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    @property
    def cluster(self) -> "BrokerCluster | None":
        return self._cluster_ref()

    @property
    def running(self) -> bool:
        return bool(self._threads) and not self._stop.is_set()

    def start(self) -> "ReplicationService":
        if self._threads:
            return self
        # a fresh Event per worker generation: a worker that outlived a
        # stop() join timeout stays bound to its own (set) event and can
        # never be resurrected by a later start() clearing a shared flag
        self._stop = stop = threading.Event()
        for i in range(self.workers):
            t = threading.Thread(
                target=self._run,
                args=(i, stop),
                name=f"replication-worker-{i}",
                daemon=True,
            )
            t.start()
            self._threads.append(t)
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout)
        self._threads = []

    def _run(self, idx: int, stop: threading.Event) -> None:
        while not stop.is_set():
            cluster = self._cluster_ref()
            if cluster is None:
                return  # cluster dropped without stop_replication()
            if idx == 0:
                try:
                    cluster.controller_tick()
                except (ClusterError, ControllerUnavailable):
                    # no controller quorum yet — next sweep retries
                    cluster.metrics.counter(
                        "daemon_retries_total", daemon="replication"
                    ).inc()
            for j, (topic, p) in enumerate(cluster.partition_ids()):
                if j % self.workers != idx:
                    continue
                if stop.is_set():
                    return
                try:
                    cluster.replicate_partition(topic, p)
                except (ClusterError, ControllerUnavailable, KeyError, IndexError):
                    # offline/deleted partition — next pass retries
                    cluster.metrics.counter(
                        "daemon_retries_total", daemon="replication"
                    ).inc()
                    continue
                except BaseException as e:  # pragma: no cover - diagnostics
                    cluster.metrics.counter(
                        "daemon_errors_total", daemon="replication"
                    ).inc()
                    if len(self.errors) < 16:
                        self.errors.append(e)
            if idx == 0:
                self.passes += 1
            del cluster  # don't pin the cluster across the sleep
            stop.wait(self.interval_s)

    def __enter__(self) -> "ReplicationService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# -------------------------------------------------------- metrics reporter
class MetricsReporter:
    """Background observability daemon: periodically snapshots the
    cluster's metrics registry and publishes it to the replicated
    internal ``__metrics`` topic (DESIGN.md §9).

    The observability plane is itself a data stream: any plain consumer
    (or a future Web UI) can subscribe to ``__metrics`` and decode each
    record with :meth:`MetricsRegistry.decode_snapshot`. Publishing goes
    through the normal routed produce path, so snapshots keep flowing
    across broker leader kills — exactly when they are needed most; a
    publish that cannot complete right now (no quorum, partition offline
    mid-election) is recorded on ``errors`` (bounded) and retried on the
    next interval, never crashing the daemon.

    Lifecycle mirrors :class:`ReplicationService`: idempotent
    ``start``/``stop``, context manager, weak cluster reference (the
    daemon exits on its own once every other reference to the cluster is
    dropped), and a fresh stop event per start generation so a worker
    that outlived a ``stop()`` join timeout can never be resurrected.
    """

    def __init__(
        self,
        cluster: "BrokerCluster",
        *,
        interval_s: float = 0.05,
    ):
        self._cluster_ref = weakref.ref(cluster)
        self.interval_s = interval_s
        self.errors: list[BaseException] = []
        self.published = 0  # snapshots that reached the __metrics topic
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @property
    def cluster(self) -> "BrokerCluster | None":
        return self._cluster_ref()

    @property
    def running(self) -> bool:
        return self._thread is not None and not self._stop.is_set()

    def start(self) -> "MetricsReporter":
        if self._thread is not None:
            return self
        self._stop = stop = threading.Event()
        t = threading.Thread(
            target=self._run, args=(stop,), name="metrics-reporter",
            daemon=True,
        )
        t.start()
        self._thread = t
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
        self._thread = None

    def _run(self, stop: threading.Event) -> None:
        while not stop.is_set():
            cluster = self._cluster_ref()
            if cluster is None:
                return  # cluster dropped without stop()
            try:
                cluster.publish_metrics()
                self.published += 1
            except (ClusterError, ControllerUnavailable):
                # quorum/election window — next interval retries
                cluster.metrics.counter(
                    "daemon_retries_total", daemon="metrics-reporter"
                ).inc()
            except BaseException as e:  # pragma: no cover - diagnostics
                cluster.metrics.counter(
                    "daemon_errors_total", daemon="metrics-reporter"
                ).inc()
                if len(self.errors) < 16:
                    self.errors.append(e)
            del cluster  # don't pin the cluster across the sleep
            stop.wait(self.interval_s)

    def __enter__(self) -> "MetricsReporter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# ------------------------------------------------------------------ cluster
class BrokerCluster:
    """N replicated brokers behind a single :class:`StreamBackend` surface.

    Drop-in for :class:`StreamLog` in every upper layer; additionally
    exposes the broker-level protocol (``broker_append``/``broker_fetch``
    with leader checks and epoch fencing) used by the failover-aware
    clients, plus chaos hooks (``kill_broker``/``partition_broker``/
    ``restart_broker``/``heal_broker``) used by the fault-tolerance tests.

    ``follower_reads=True`` (default) lets the ``StreamBackend`` read path
    fall back to an in-sync follower — capped at the high watermark — when
    the partition leader is down, so consumers keep draining committed
    records while an election is pending. ``legacy_global_lock=True``
    restores the PR-1 data plane (one cluster-wide lock, fetch-based
    synchronous replication); it exists so ``benchmarks/replication.py``
    can measure the concurrent data plane against its own baseline.
    """

    def __init__(
        self,
        num_brokers: int = 3,
        *,
        default_replication_factor: int | None = None,
        default_acks: int | str = "all",
        allow_unclean_election: bool = False,
        follower_reads: bool = True,
        legacy_global_lock: bool = False,
        controller_nodes: int = 3,
        controller_lease_s: float = 1.0,
        txn_timeout_s: float = 60.0,
        metrics_enabled: bool = True,
        clock: Callable[[], float] | None = None,
    ):
        if num_brokers < 1:
            raise ValueError("need at least one broker")
        self._clock = clock or time.time
        # cluster-wide observability registry (DESIGN.md §9), shared with
        # every broker's log; metrics_enabled=False turns every probe
        # into a near-free no-op (the benchmark's control arm)
        self.metrics = MetricsRegistry(enabled=metrics_enabled)
        # bound hot-path handles (no registry lookup per produce/fetch);
        # harmless null singletons when the registry is disabled. The
        # latency histograms sample 1-in-8 after warm-up (see
        # metrics.Histogram) to stay inside the ≤5% overhead budget.
        self._h_produce_latency = self.metrics.histogram(
            "produce_latency_seconds", sample=8
        )
        self._h_commit_latency = self.metrics.histogram(
            "commit_latency_seconds", sample=8
        )
        self._h_fetch_latency = self.metrics.histogram(
            "fetch_latency_seconds", sample=8
        )
        self._c_produce_dups = self.metrics.counter("produce_duplicates_total")
        self.brokers: dict[int, Broker] = {
            i: Broker(i, StreamLog(clock=self._clock)) for i in range(num_brokers)
        }
        for br in self.brokers.values():
            br.log.metrics = self.metrics
        self.default_replication_factor = (
            num_brokers if default_replication_factor is None
            else default_replication_factor
        )
        self.default_acks = default_acks
        self.allow_unclean_election = allow_unclean_election
        self.follower_reads = follower_reads
        self._legacy = legacy_global_lock
        self._meta: dict[tuple[str, int], _PartitionCtl] = {}
        self._configs: dict[str, LogConfig] = {}
        self._topic_gens: dict[str, int] = {}  # name -> creation generation
        self._committed: dict[str, dict[TopicPartition, int]] = {}
        self._topic_seq = 0  # staggers replica placement across topics
        # idempotent-producer id space: grants are AllocatePid commands
        # committed to the metadata log, so ids stay unique across
        # controller failovers. _producer_epochs is the cluster-wide fence
        # (pid -> newest granted epoch): an append from an older epoch is
        # a zombie and rejected before it touches any partition.
        self._next_pid = 0
        self._producer_names: dict[str, tuple[int, int]] = {}
        self._producer_epochs: dict[int, int] = {}
        # transaction coordinator state: pid -> _TxnState, mutated only by
        # applying committed txn MetadataCommands (see _apply_txn). A
        # transaction in a prepare_* state whose driver died is finished
        # by controller_tick (_resume_pending_txns) — the decision is in
        # the replicated log, so the outcome survives any failover.
        self._txns: dict[int, _TxnState] = {}
        # per-pid phase-two serialization: _finish_txn's marker writes
        # run outside the metadata lock, so a client driver and the
        # controller tick can race into phase two for the same pid; the
        # per-pid lock makes the loser re-read coordinator state AFTER
        # the winner completed (it then sees complete/ongoing and backs
        # off) instead of resolving a successor transaction of the same
        # (pid, epoch) with the predecessor's snapshot. Acquired BEFORE
        # the metadata lock, never while holding it.
        self._txn_locks: dict[int, threading.Lock] = {}
        # a transaction left ongoing longer than this (its producer died
        # without ever re-initializing) is fenced and aborted by the
        # controller tick — Kafka's transaction.timeout.ms; without it an
        # abandoned txn would pin the partition LSO forever and stall
        # every read_committed consumer behind it
        self.txn_timeout_s = txn_timeout_s
        # chaos hook: the next _end_txn dies right after its prepare
        # decision commits, before any marker is written (models a
        # coordinator crash mid two-phase commit)
        self.crash_after_prepare = False
        # topology lock: topic create/delete, broker up/down, offset store.
        # Data-plane work runs under per-partition ctl locks instead; in
        # legacy mode every ctl shares _data_lock, restoring one-big-lock.
        self._meta_lock = make_rlock("metadata")
        self._data_lock = (
            make_rlock("partition", name="partition:legacy-global")
            if legacy_global_lock else None
        )
        self._services: list[ReplicationService] = []
        self._reporters: list[MetricsReporter] = []
        # the replicated control plane: every topology mutation below goes
        # through a command committed to this quorum's metadata log
        self.controller = QuorumController(
            controller_nodes, lease_s=controller_lease_s, clock=self._clock
        )
        # open 2PC trace spans (pid -> Span), begun at BeginTxn and ended
        # when CompleteTxn commits; coordinator-local bookkeeping only
        self._txn_spans: dict[int, object] = {}
        # (topic, partition) -> monotonic time its leader was observed
        # down, consumed by the elect_leader apply to measure election
        # duration (detection -> committed new leader)
        self._election_pending: dict[tuple[str, int], float] = {}
        self._register_gauges()

    def _register_gauges(self) -> None:
        """Register lazy gauge callbacks: expensive-to-compute state is
        evaluated only at snapshot/render time, never on the hot path.
        Closures hold the cluster weakly so the registry (owned by the
        cluster) never pins it into a reference cycle."""
        ref = weakref.ref(self)

        def controller_stat(name: str) -> Callable[[], float]:
            def fn() -> float:
                c = ref()
                return 0.0 if c is None else float(
                    getattr(c.controller, name)
                )
            return fn

        m = self.metrics
        m.gauge_fn("controller_elections", controller_stat("elections"))
        m.gauge_fn("controller_term_changes", controller_stat("term_changes"))
        m.gauge_fn("controller_quorum_rpcs", controller_stat("quorum_rpcs"))

        def apply_lag() -> float:
            c = ref()
            return 0.0 if c is None else float(c.controller.apply_lag())

        m.gauge_fn("controller_apply_lag", apply_lag)

        def log_stat(broker_id: int, key: str) -> Callable[[], float]:
            def fn() -> float:
                c = ref()
                if c is None:
                    return 0.0
                return float(c.brokers[broker_id].log.stats()[key])
            return fn

        for bid in self.brokers:
            for key in ("segments", "producer_state_entries", "open_txns"):
                m.gauge_fn(f"log_{key}", log_stat(bid, key), broker=bid)

    # ------------------------------------------------------------------ admin
    def create_topic(self, name: str, cfg: LogConfig | None = None) -> None:
        with self._meta_lock:
            if name in self._configs:
                raise ValueError(f"topic {name!r} already exists")
            cfg = replace(cfg) if cfg is not None else LogConfig()
            n = len(self.brokers)
            if cfg.replication_factor is None:
                # unspecified -> cluster default (as Kafka's broker-side
                # default.replication.factor), so a config written for
                # partitioning/retention never opts out of replication
                cfg.replication_factor = self.default_replication_factor
            rf = cfg.replication_factor
            if rf < 1 or rf > n:
                raise ValueError(
                    f"replication_factor {rf} not in [1, {n}] for {name!r}"
                )
            if cfg.min_insync_replicas is None:
                # default topics enforce the durability the docs promise:
                # acks=all is only accepted while >= 2 replicas are in sync
                # (so the ack implies single-broker-loss survival)
                cfg.min_insync_replicas = min(2, rf)
            cmd = MetadataCommand(
                kind="create_topic", topic=name, cfg=asdict(cfg),
                gen=self._topic_seq,
            )
            self.controller.submit(cmd)
            self._apply_metadata(cmd)

    def ensure_topic(self, name: str, cfg: LogConfig | None = None) -> None:
        with self._meta_lock:
            if name not in self._configs:
                self.create_topic(name, cfg)

    def delete_topic(self, name: str) -> None:
        with self._meta_lock:
            if name not in self._configs:
                return
            cmd = MetadataCommand(
                kind="delete_topic", topic=name, gen=self._topic_gens[name]
            )
            self.controller.submit(cmd)
            self._apply_metadata(cmd)

    def _apply_create_topic(self, cmd: MetadataCommand) -> None:
        with self._meta_lock:
            if cmd.topic in self._configs:
                return  # replay of an already-applied creation
            cfg = LogConfig(**cmd.cfg)
            n = len(self.brokers)
            rf = cfg.replication_factor
            seed = cmd.gen
            self._topic_seq = max(self._topic_seq, seed + 1)
            self._topic_gens[cmd.topic] = seed
            self._configs[cmd.topic] = cfg
            # every broker materializes the topic locally; only replica-set
            # members ever hold data for a given partition. Spill files are
            # namespaced per broker — replicas seal segments with identical
            # (topic, partition, base_offset) names and must not clobber
            # each other's files.
            for br in self.brokers.values():
                local = replace(cfg)
                if cfg.spill_dir is not None:
                    local.spill_dir = os.path.join(
                        cfg.spill_dir, f"broker-{br.broker_id}"
                    )
                br.log.ensure_topic(cmd.topic, local)
            for p in range(cfg.num_partitions):
                start = (p + seed) % n
                replicas = [(start + j) % n for j in range(rf)]
                ctl = _PartitionCtl(
                    cmd.topic, p, replicas, lock=self._data_lock, gen=seed
                )
                self._meta[(cmd.topic, p)] = ctl
                if not self.brokers[ctl.leader].up:
                    with ctl.lock:
                        try:
                            self._elect(ctl)
                        except ControllerUnavailable:
                            pass  # lazy paths elect once quorum returns

    def _apply_delete_topic(self, cmd: MetadataCommand) -> None:
        with self._meta_lock:
            if self._topic_gens.get(cmd.topic) != cmd.gen:
                return  # replay against a later same-name incarnation
            self._topic_gens.pop(cmd.topic, None)
            cfg = self._configs.pop(cmd.topic, None)
            if cfg is None:
                return
            ctls = [
                self._meta.pop((cmd.topic, p), None)
                for p in range(cfg.num_partitions)
            ]
            # sweep the partition locks (sanctioned meta→partition order)
            # before tearing down broker logs: any in-flight data-plane
            # operation finishes its current critical section against
            # intact logs, and its next one — it may still hold the popped
            # ctl — sees the offline fence instead of appending into a
            # recreated topic's logs behind the new ctl's accounting
            for ctl in ctls:
                if ctl is None:
                    continue
                with ctl.lock:
                    ctl.leader = None
                    ctl.isr = set()
                    # also empty the replica set: with unclean election
                    # enabled, a bare leader=None fence could be re-elected
                    # through from live replicas by a stale holder
                    ctl.replicas = []
            for br in self.brokers.values():
                br.log.delete_topic(cmd.topic)

    def init_producer(self, name: str | None = None) -> tuple[int, int]:
        """Grant an idempotent-producer identity: ``(pid, epoch)``.

        The grant is an ``AllocatePid`` command committed to the
        controller quorum's metadata log before it is usable, so producer
        ids stay unique across controller failovers (a successor inherits
        every committed grant and allocates above them).

        ``name`` opts into *named* re-initialization (Kafka's
        transactional.id shape): re-initializing an existing name returns
        the same pid with a bumped epoch, and the bump — also committed —
        fences the previous incarnation cluster-wide: any append it still
        has in flight fails with :class:`~repro.core.log.ProducerFenced`
        (zombie fencing). Raises :class:`ControllerUnavailable` with no
        quorum — an unfenced identity must never be handed out.
        """
        with self._meta_lock:
            if name is not None and name in self._producer_names:
                pid, ep = self._producer_names[name]
                ep += 1
            else:
                pid, ep = self._next_pid, 0
            cmd = MetadataCommand(
                kind="allocate_pid", pid=pid, producer_epoch=ep, name=name
            )
            self.controller.submit(cmd)
            self._apply_metadata(cmd)
            return pid, ep

    def _apply_allocate_pid(self, cmd: MetadataCommand) -> None:
        with self._meta_lock:
            self._next_pid = max(self._next_pid, cmd.pid + 1)
            if cmd.producer_epoch > self._producer_epochs.get(cmd.pid, -1):
                self._producer_epochs[cmd.pid] = cmd.producer_epoch
            if cmd.name is not None:
                known = self._producer_names.get(cmd.name)
                if known is None or cmd.producer_epoch >= known[1]:
                    self._producer_names[cmd.name] = (
                        cmd.pid, cmd.producer_epoch
                    )

    # ------------------------------------------------ transaction coordinator
    def _fence_pid(self, pid: int, epoch: int) -> None:
        known = self._producer_epochs.get(pid)
        if known is not None and epoch < known:
            raise ProducerFenced(
                f"producer {pid} epoch {epoch} fenced by granted epoch {known}"
            )

    def _submit_txn(self, cmd: MetadataCommand) -> None:
        """Commit one txn command to the metadata log and apply it.
        Caller holds the metadata lock."""
        self.controller.submit(cmd)
        self._apply_metadata(cmd)

    def begin_txn(self, pid: int, epoch: int) -> None:
        """Open a transaction for ``(pid, epoch)`` — a committed
        ``BeginTxn`` command. A stale incarnation's unfinished transaction
        is resolved first: a prepared one is driven to completion (its
        outcome is already durably decided), an ongoing one is aborted
        (its producer is fenced — it can never commit)."""
        with self._meta_lock:
            self._fence_pid(pid, epoch)
            st = self._txns.get(pid)
            stale = st.state if st is not None else None
            stale_epoch = st.epoch if st is not None else -1
        if stale is not None and stale.startswith("prepare"):
            self._finish_txn(pid)
        elif stale == "ongoing":
            if stale_epoch >= epoch:
                raise InvalidTxnState(
                    f"producer {pid} already has a transaction in "
                    f"progress (epoch {stale_epoch})"
                )
            self._end_txn(pid, stale_epoch, commit=False, internal=True)
        with self._meta_lock:
            st = self._txns.get(pid)
            if st is not None and st.state == "ongoing" and st.epoch >= epoch:
                raise InvalidTxnState(
                    f"producer {pid} already has a transaction in "
                    f"progress (epoch {st.epoch})"
                )
            seq = st.seq + 1 if st is not None else 0
            self._submit_txn(MetadataCommand(
                kind="begin_txn", pid=pid, producer_epoch=epoch, txn_seq=seq
            ))
            if self.metrics.enabled:
                # 2PC trace span: BeginTxn -> prepare -> markers ->
                # complete, with per-phase timings (DESIGN.md §9)
                self._txn_spans[pid] = self.metrics.span("txn_2pc", pid=pid)

    def _require_ongoing(self, pid: int, epoch: int) -> _TxnState:
        st = self._txns.get(pid)
        if st is None or st.state != "ongoing" or st.epoch != epoch:
            raise InvalidTxnState(
                f"producer {pid} (epoch {epoch}) has no ongoing transaction"
                f" (state: {st.state if st is not None else 'none'})"
            )
        return st

    def txn_add_partitions(
        self, pid: int, epoch: int, parts: Sequence[tuple[str, int]]
    ) -> None:
        """Register partitions the transaction will write to (Kafka's
        AddPartitionsToTxn) — the set the coordinator must put markers on
        at resolution, durably in the metadata log *before* the first
        transactional append lands on them."""
        with self._meta_lock:
            self._fence_pid(pid, epoch)
            st = self._require_ongoing(pid, epoch)
            new = [tuple(p) for p in parts if tuple(p) not in st.partitions]
            if not new:
                return
            self._submit_txn(MetadataCommand(
                kind="add_partitions_to_txn", pid=pid, producer_epoch=epoch,
                partitions=tuple(new), txn_seq=st.seq + 1,
            ))

    def txn_add_offsets(
        self,
        pid: int,
        epoch: int,
        group: str,
        offsets: dict[TopicPartition, int],
    ) -> None:
        """Attach consumer offsets to the transaction (Kafka's
        AddOffsetsToTxn + TxnOffsetCommit): they are applied to the
        replicated offset store if — and only if — the transaction
        commits, which is what makes read-process-write atomic."""
        with self._meta_lock:
            self._fence_pid(pid, epoch)
            st = self._require_ongoing(pid, epoch)
            enc = {f"{tp.topic}:{tp.partition}": off for tp, off in offsets.items()}
            self._submit_txn(MetadataCommand(
                kind="add_offsets_to_txn", pid=pid, producer_epoch=epoch,
                group=group, offsets=enc, txn_seq=st.seq + 1,
            ))

    def commit_txn(self, pid: int, epoch: int) -> None:
        """Two-phase commit: (1) commit a ``PrepareCommit`` decision to
        the controller quorum — from here the transaction WILL commit,
        whatever fails next; (2) write COMMIT markers on every registered
        partition, apply the attached consumer offsets, and commit
        ``CompleteTxn``. A crash between the phases leaves a prepared
        transaction that ``controller_tick`` finishes (idempotently) on
        any later heartbeat, so every touched partition converges to the
        same outcome across controller and broker failovers."""
        self._end_txn(pid, epoch, commit=True)

    def abort_txn(self, pid: int, epoch: int) -> None:
        """Two-phase abort: durable ``PrepareAbort`` decision, then ABORT
        markers — read_committed consumers never see the records."""
        self._end_txn(pid, epoch, commit=False)

    def resolve_txn(self, pid: int) -> None:
        """Finish a *prepared* transaction at its own recorded epoch —
        the recovery entry point for a restarted driver whose producer
        epoch has moved past the transaction it inherited (its
        ``commit_txn(pid, new_epoch)`` would be rejected as an epoch
        mismatch). No-op unless a prepare decision is pending; raises
        ``ClusterError`` when the cluster cannot complete it right now."""
        self._finish_txn(pid)

    def _end_txn(
        self, pid: int, epoch: int, *, commit: bool, internal: bool = False
    ) -> None:
        with self._meta_lock:
            if not internal:
                self._fence_pid(pid, epoch)
            st = self._txns.get(pid)
            prepared = "prepare_commit" if commit else "prepare_abort"
            if st is None or st.epoch != epoch:
                raise InvalidTxnState(
                    f"producer {pid} (epoch {epoch}) has no transaction"
                )
            if st.state == ("complete_commit" if commit else "complete_abort"):
                return  # a retried end of an already-finished transaction
            if st.state == "ongoing":
                self._submit_txn(MetadataCommand(
                    kind=prepared, pid=pid, producer_epoch=epoch,
                    txn_seq=st.seq + 1,
                ))
                sp = self._txn_spans.get(pid)
                if sp is not None:
                    sp.phase("prepare")
            elif st.state != prepared:
                # the opposite decision (or completion) is already durable
                raise InvalidTxnState(
                    f"transaction of producer {pid} is {st.state}; "
                    f"cannot {'commit' if commit else 'abort'}"
                )
            if self.crash_after_prepare:
                self.crash_after_prepare = False
                raise ControllerUnavailable(
                    "injected: transaction coordinator crashed after the "
                    "prepare decision committed, before marker writes"
                )
        self._finish_txn(pid)

    def _finish_txn(self, pid: int) -> None:
        """Phase two: write markers on every registered partition, apply
        offsets (commit only), record ``CompleteTxn``. Idempotent — every
        step no-ops where a previous attempt already succeeded (a racing
        second driver's duplicate ``CompleteTxn`` is dropped by the
        ``txn_seq`` guard) — and restartable: any ClusterError propagates
        with the transaction still in its prepare state for the next
        ``controller_tick`` (or a client retry) to re-drive. The marker
        writes deliberately run OUTSIDE the metadata lock (partition +
        controller locks only): a slow failover inside one transaction's
        phase two must not stall every other producer, consumer-offset
        commit and admin call on the cluster-wide lock. Concurrent
        finishers of the same pid serialize on its phase-two lock: the
        state snapshot happens inside it, so a finisher that lost the
        race observes the completed (or successor) state and backs off."""
        with self._meta_lock:
            lock = self._txn_locks.setdefault(
                pid, make_lock("txn", name=f"txn:{pid}"))
        with lock:
            with self._meta_lock:
                st = self._txns.get(pid)
                if st is None or not st.state.startswith("prepare"):
                    return  # already complete (or never prepared)
                commit = st.state == "prepare_commit"
                epoch = st.epoch
                parts = sorted(st.partitions)
                offsets = {g: dict(o) for g, o in st.offsets.items()}
            for topic, p in parts:
                self._write_marker(topic, p, pid, epoch, commit=commit)
            sp = self._txn_spans.get(pid)
            if sp is not None:
                sp.phase("markers")
            with self._meta_lock:
                st = self._txns.get(pid)
                if st is None or not st.state.startswith("prepare"):
                    return  # a concurrent driver completed it meanwhile
                if commit:
                    for group, offs in offsets.items():
                        for tps, off in offs.items():
                            t, _, pstr = tps.rpartition(":")
                            self.commit_offset(
                                group, TopicPartition(t, int(pstr)), off
                            )
                self._submit_txn(MetadataCommand(
                    kind="complete_txn", pid=pid, producer_epoch=epoch,
                    committed=commit, txn_seq=st.seq + 1,
                ))
                sp = self._txn_spans.pop(pid, None)
                if sp is not None:
                    sp.phase("complete")
                    sp.end("commit" if commit else "abort")
                self.metrics.counter(
                    "txn_commit_total" if commit else "txn_abort_total"
                ).inc()

    def _write_marker(
        self, topic: str, partition: int, pid: int, epoch: int, *, commit: bool
    ) -> None:
        """Write one COMMIT/ABORT control marker on a partition's leader
        and replicate it into the ISR (the marker is only 'written' once
        it is below the HW — an unreplicated marker on a dying leader is
        truncated and must be re-driven). No-ops when the partition has
        no open transaction for the pid: the marker already landed (this
        is a recovery re-drive), the partition never saw an append, or
        the topic is gone."""
        try:
            ctl = self._ctl(topic, partition)
        except (KeyError, IndexError):
            return  # topic deleted since the partition was registered
        last_err: ClusterError | None = None
        for _ in range(_ROUTED_RETRIES):
            with ctl.lock:
                try:
                    leader = self._leader_broker(ctl)
                    off = leader.log.append_control(
                        topic, partition, pid, epoch, abort=not commit
                    )
                    if off is None:
                        # no open transaction on the leader: either this
                        # partition never saw an append, or the marker
                        # already landed — possibly on a PREVIOUS attempt
                        # that never replicated it. Only a HW at or past
                        # the leader's end proves the close is durable
                        # (an unreplicated marker on a dying leader would
                        # be truncated, silently re-opening the txn on
                        # the survivors); force a pass otherwise.
                        if ctl.hw >= leader.log.end_offset(topic, partition):
                            return
                        self._replicate_partition(ctl)
                        if ctl.hw >= leader.log.end_offset(topic, partition):
                            return
                        last_err = NotLeaderError(topic, partition, ctl.leader)
                        continue
                    # push the marker straight to caught-up ISR followers
                    # (the acks=all hot-path shape): the one-record fetch
                    # carries its ctrl metadata verbatim, so follower txn
                    # state and timestamps track the leader's exactly;
                    # any lagging follower falls back to a full pass
                    vals, keys, ts, prods, _offs, _nxt, sbase = (
                        leader.log.replica_fetch(topic, partition, off, 1)
                    )
                    need_full = self._legacy
                    for bid in sorted(ctl.isr):
                        if bid == ctl.leader or need_full:
                            continue
                        fbr = self.brokers[bid]
                        if (
                            not fbr.up
                            or ctl.synced_epoch.get(bid) != ctl.epoch
                            or fbr.log.end_offset(topic, partition) != off
                        ):
                            need_full = True
                            continue
                        fbr.log.replica_append(
                            topic, partition, vals, keys, ts, prods=prods,
                            seg_base=sbase,
                        )
                    if need_full:
                        self._replicate_partition(ctl)
                    else:
                        ctl.hw = max(ctl.hw, off + 1)
                    if ctl.hw > off:
                        return
                    last_err = NotLeaderError(topic, partition, ctl.leader)
                except ClusterError as e:
                    # leadership in flux / no quorum for the ISR change:
                    # retry — the next pass elects through dead leaders
                    last_err = e
        raise last_err

    def _resume_pending_txns(self) -> None:
        """Finish transactions whose prepare decision is durable but
        whose driver died before markers landed everywhere — the
        controller-failover half of the two-phase commit — and fence +
        abort transactions left *ongoing* past ``txn_timeout_s`` (the
        producer died without re-initializing; its open txn would pin
        the LSO forever). Driven by ``controller_tick``."""
        now = self._clock()
        with self._meta_lock:
            pending = [
                pid for pid, st in self._txns.items()
                if st.state.startswith("prepare")
            ]
            expired = [
                (pid, st.epoch) for pid, st in self._txns.items()
                if st.state == "ongoing"
                and now - st.touched > self.txn_timeout_s
            ]
        for pid in pending:
            try:
                self._finish_txn(pid)
            except (ClusterError, ControllerUnavailable):
                continue  # partition/quorum unavailable: next tick retries
        for pid, ep in expired:
            try:
                with self._meta_lock:
                    st = self._txns.get(pid)
                    if st is None or st.state != "ongoing" or st.epoch != ep:
                        continue  # resolved since the snapshot
                    if self._producer_epochs.get(pid, -1) <= ep:
                        # fence the timed-out incarnation BEFORE aborting
                        # (Kafka bumps the producer epoch on transaction
                        # timeout): its late appends must not re-open the
                        # transaction after the abort markers land
                        cmd = MetadataCommand(
                            kind="allocate_pid", pid=pid,
                            producer_epoch=ep + 1,
                        )
                        self.controller.submit(cmd)
                        self._apply_metadata(cmd)
                # abort outside the metadata lock (phase two takes
                # partition locks; see _finish_txn)
                self._end_txn(pid, ep, commit=False, internal=True)
                self.metrics.counter("txn_timeout_total").inc()
            except (ClusterError, ControllerUnavailable, InvalidTxnState):
                continue  # next tick retries (fence bump is idempotent)

    def _apply_txn(self, cmd: MetadataCommand) -> None:
        """Apply one committed txn command — the coordinator state
        machine. Replay-idempotent via the per-pid ``txn_seq`` guard."""
        with self._meta_lock:
            st = self._txns.get(cmd.pid)
            if cmd.kind == "begin_txn":
                if st is not None and (
                    cmd.txn_seq <= st.seq or cmd.producer_epoch < st.epoch
                ):
                    return
                st = _TxnState(cmd.pid, cmd.producer_epoch, cmd.txn_seq)
                st.touched = self._clock()
                self._txns[cmd.pid] = st
                return
            if st is None or cmd.txn_seq is None or cmd.txn_seq <= st.seq:
                return
            st.seq = cmd.txn_seq
            st.touched = self._clock()
            if cmd.kind == "add_partitions_to_txn":
                st.partitions |= {tuple(p) for p in cmd.partitions}
            elif cmd.kind == "add_offsets_to_txn":
                st.offsets.setdefault(cmd.group, {}).update(cmd.offsets)
            elif cmd.kind == "prepare_commit":
                st.state = "prepare_commit"
            elif cmd.kind == "prepare_abort":
                st.state = "prepare_abort"
            elif cmd.kind == "complete_txn":
                st.state = (
                    "complete_commit" if cmd.committed else "complete_abort"
                )

    def txn_state(self, pid: int) -> str | None:
        """Coordinator state for a producer id (test/observability hook)."""
        with self._meta_lock:
            st = self._txns.get(pid)
            return st.state if st is not None else None

    def topics(self) -> list[str]:
        with self._meta_lock:
            return sorted(self._configs)

    def num_partitions(self, topic: str) -> int:
        with self._meta_lock:
            try:
                return self._configs[topic].num_partitions
            except KeyError:
                raise KeyError(f"unknown topic {topic!r}") from None

    def partition_ids(self) -> list[tuple[str, int]]:
        """Snapshot of every (topic, partition) — the daemon's work list."""
        with self._meta_lock:
            return list(self._meta)

    # --------------------------------------------------------------- metadata
    def _ctl(self, topic: str, partition: int) -> _PartitionCtl:
        try:
            return self._meta[(topic, partition)]
        except KeyError:
            if topic not in self._configs:
                raise KeyError(f"unknown topic {topic!r}") from None
            raise IndexError(f"{topic} has no partition {partition}") from None

    def metadata(self, topic: str) -> dict[int, PartitionMeta]:
        """MetadataResponse: partition -> (leader, epoch, replicas, isr, hw)."""
        with self._meta_lock:
            # ctl lookup is atomic with the partition count, so a racing
            # delete_topic yields a clean KeyError from num_partitions on
            # the next refresh, never a torn half-deleted view
            n = self.num_partitions(topic)
            ctls = [self._meta.get((topic, p)) for p in range(n)]
        return {p: ctl.meta() for p, ctl in enumerate(ctls) if ctl is not None}

    def partition_meta(self, topic: str, partition: int) -> PartitionMeta:
        """One partition's MetadataResponse — touches only its ctl lock."""
        return self._ctl(topic, partition).meta()

    def leader_for(self, topic: str, partition: int) -> int | None:
        ctl = self._ctl(topic, partition)
        with ctl.lock:
            return ctl.leader

    def describe(self) -> dict[str, dict[int, PartitionMeta]]:
        return {t: self.metadata(t) for t in self.topics()}

    # ------------------------------------------------------------ replication
    def _leader_broker(self, ctl: _PartitionCtl) -> Broker:
        if ctl.leader is None:
            # leaderless (offline) partition: recover lazily when an
            # eligible candidate exists — e.g. a replica rejoined while
            # the controller quorum was down, so no election could commit
            # at rejoin time. Never submit a None-leader election here:
            # that would churn epochs on every read of an offline
            # partition.
            cmd = self._election_command(ctl)
            if cmd.leader is not None:
                self.controller.submit(cmd)
                self._apply_metadata(cmd)
            if ctl.leader is None:
                raise PartitionOffline(
                    f"{ctl.topic}:{ctl.partition} has no leader"
                )
        br = self.brokers[ctl.leader]
        if not br.up:
            # the controller notices the dead leader lazily (e.g. a client
            # addressed the partition before any explicit failure event)
            self._elect(ctl)
            if ctl.leader is None:
                raise PartitionOffline(
                    f"{ctl.topic}:{ctl.partition} has no leader"
                )
            br = self.brokers[ctl.leader]
        return br

    def _replicate_partition(self, ctl: _PartitionCtl) -> None:
        """One follower-fetch pass: copy leader records to live followers,
        refresh ISR membership (any change routes through the controller
        quorum as a ``ShrinkIsr``/``ExpandIsr`` command — with no quorum
        the committed ISR stands and the HW simply stops advancing), and
        advance the high watermark."""
        with ctl.lock:
            leader = self._leader_broker(ctl)
            leo = leader.log.end_offset(ctl.topic, ctl.partition)
            new_isr = set(ctl.isr)
            copied = 0
            for bid in ctl.replicas:
                if bid == ctl.leader:
                    continue
                br = self.brokers[bid]
                if not br.up:
                    new_isr.discard(bid)
                    continue
                local_end = br.log.end_offset(ctl.topic, ctl.partition)
                last_synced = ctl.synced_epoch.get(bid, -1)
                if last_synced < ctl.epoch:
                    # leader-epoch reconciliation: this replica missed one or
                    # more elections, so records above the first missed
                    # epoch's start may be a divergent unacked suffix from
                    # its own time as leader — even below the since-advanced
                    # HW. Truncate to that point before fetching.
                    cut = min(
                        (
                            start
                            for e, start in ctl.epoch_starts.items()
                            if e > last_synced
                        ),
                        default=None,
                    )
                    if cut is not None and cut < local_end:
                        local_end = br.log.truncate_to(
                            ctl.topic, ctl.partition, cut
                        )
                if local_end > leo:
                    # deposed leader with an unacked suffix: reconcile
                    local_end = br.log.truncate_to(ctl.topic, ctl.partition, leo)
                lstart = leader.log.start_offset(ctl.topic, ctl.partition)
                if local_end < lstart:
                    # fell behind the leader's retention point while down:
                    # drop everything and re-fetch from the leader's log start
                    local_end = br.log.reset_to(ctl.topic, ctl.partition, lstart)
                while local_end < leo:
                    values, keys, timestamps, prods, offs, nxt, sbase = (
                        leader.log.replica_fetch(
                            ctl.topic, ctl.partition, local_end,
                            _REPLICA_FETCH_CHUNK,
                        )
                    )
                    if nxt <= local_end:
                        break
                    if values:
                        br.log.replica_append(
                            ctl.topic, ctl.partition, values, keys,
                            timestamps, prods=prods, offsets=offs,
                            seg_base=sbase,
                        )
                        copied += len(values)
                    # advance by the covered raw window, not the record
                    # count — a compacted range can deliver fewer records
                    # than offsets (or none at all)
                    local_end = nxt
                if local_end >= leo:
                    new_isr.add(bid)
                    ctl.synced_epoch[bid] = ctl.epoch
                else:
                    new_isr.discard(bid)
                # propagate the leader's compact point: the keep rule is
                # deterministic over the replicated records, so followers
                # cleaning to the same horizon converge on the same
                # surviving records (DESIGN.md §11)
                cp = leader.log.compact_point(ctl.topic, ctl.partition)
                if cp > br.log.compact_point(ctl.topic, ctl.partition):
                    br.log.compact_to(ctl.topic, ctl.partition, cp)
            new_isr.add(ctl.leader)
            ctl.synced_epoch[ctl.leader] = ctl.epoch
            if copied and self.metrics.enabled:
                mr = ctl.m_repl
                if mr is None:
                    mr = ctl.m_repl = self.metrics.counter(
                        "replication_records_total", topic=ctl.topic,
                        partition=ctl.partition,
                    )
                mr.inc(copied)
            self._propose_isr(ctl, new_isr)
            # the HW derives from the *committed* ISR: if the quorum was
            # unavailable and a dead member is still in the ISR, its stale
            # end pins the HW (safety: nothing is acked that could be lost)
            isr_ends = [
                self.brokers[b].log.end_offset(ctl.topic, ctl.partition)
                for b in ctl.isr
            ]
            # HW never regresses below what consumers may already have read
            ctl.hw = max(ctl.hw, min(isr_ends)) if isr_ends else ctl.hw

    def _propose_isr(self, ctl: _PartitionCtl, new_isr: set[int]) -> None:
        """Route an ISR membership change through the metadata log (Kafka's
        AlterPartition). Caller holds the partition lock. No-op when the
        membership is unchanged; swallowed when the controller quorum is
        unavailable — the committed ISR then stands, which only ever
        *withholds* HW advances and acks (safe)."""
        if new_isr == ctl.isr:
            return
        removed = ctl.isr - new_isr
        added = new_isr - ctl.isr
        try:
            if removed:
                cmd = MetadataCommand(
                    kind="shrink_isr", topic=ctl.topic, partition=ctl.partition,
                    epoch=ctl.epoch, isr=tuple(sorted(ctl.isr - removed)),
                    pversion=ctl.version + 1, gen=ctl.gen,
                )
                self.controller.submit(cmd)
                self._apply_metadata(cmd)
                self.metrics.counter(
                    "isr_shrink_total", topic=ctl.topic,
                    partition=ctl.partition,
                ).inc()
            if added:
                cmd = MetadataCommand(
                    kind="expand_isr", topic=ctl.topic, partition=ctl.partition,
                    epoch=ctl.epoch, isr=tuple(sorted(ctl.isr | added)),
                    pversion=ctl.version + 1, gen=ctl.gen,
                )
                self.controller.submit(cmd)
                self._apply_metadata(cmd)
                self.metrics.counter(
                    "isr_expand_total", topic=ctl.topic,
                    partition=ctl.partition,
                ).inc()
        except ControllerUnavailable:
            pass

    def _commit_batch(
        self,
        ctl: _PartitionCtl,
        values: Sequence[bytes],
        keys: Sequence[bytes | None] | None,
        now_ms: int,
        first: int,
        last: int,
        producer: tuple[int, int, int] | None = None,
        txn: bool = False,
    ) -> None:
        """Synchronous ISR replication for one acked batch (caller holds
        the partition lock and just appended ``[first, last]`` on the
        leader).

        Hot path: the records are still in hand, so push them straight to
        every caught-up ISR follower — no leader re-fetch, no per-record
        materialization — and advance the HW. Any follower that lagged
        (acks<all appends in between, missed epochs, just rejoined) falls
        back to a full reconciliation pass, which re-derives ISR and HW
        from scratch.

        Invariant this relies on (and preserves): between replication
        passes, every non-leader ISR member holds the same prefix-
        consistent log with the same end offset — followers only advance
        via full passes (which equalize them at the leader's end) or via
        this push (all caught-up followers, or the full-pass fallback).
        Election survivors are therefore prefix-identical, which is what
        makes the caller's ``hw > last`` ack test exact: the HW can only
        pass ``last`` if the committed records at ``[first, last]`` are
        this batch.
        """
        if self._legacy:
            self._replicate_partition(ctl)
            return
        need_full = False
        pushed = 0
        for bid in sorted(ctl.isr):
            if bid == ctl.leader:
                continue
            fbr = self.brokers[bid]
            if (
                not fbr.up
                or ctl.synced_epoch.get(bid) != ctl.epoch
                or fbr.log.end_offset(ctl.topic, ctl.partition) != first
            ):
                need_full = True
                continue
            # the push carries the batch's producer stamp, so the
            # follower's dedup table tracks the leader's — if this
            # follower wins a mid-append election, the client's retry of
            # this very batch resolves to these offsets instead of
            # re-appending (exactly-once through failover)
            fbr.log.replica_append(
                ctl.topic, ctl.partition, values, keys, now_ms,
                producer=producer, txn=txn,
            )
            pushed += 1
        if pushed and self.metrics.enabled:
            mr = ctl.m_repl
            if mr is None:
                mr = ctl.m_repl = self.metrics.counter(
                    "replication_records_total", topic=ctl.topic,
                    partition=ctl.partition,
                )
            mr.inc(pushed * len(values))
        if need_full:
            self._replicate_partition(ctl)
        else:
            # leader + every ISR follower now hold [.., last]
            ctl.hw = max(ctl.hw, last + 1)

    def replicate_partition(self, topic: str, partition: int) -> None:
        """One replication pass for one partition (daemon work unit)."""
        self._replicate_partition(self._ctl(topic, partition))

    def replicate_all(self) -> None:
        """Drive one replication pass for every partition (an explicit
        cluster-wide tick; the background daemon does the same per
        partition on an interval)."""
        for topic, p in self.partition_ids():
            try:
                self.replicate_partition(topic, p)
            except PartitionOffline:
                continue  # no live leader to fetch from — skip, not abort
            except ControllerUnavailable:
                continue  # no controller quorum — leadership frozen for now
            except (KeyError, IndexError):
                continue  # topic deleted since the snapshot

    # ------------------------------------------------------- daemon lifecycle
    def start_replication(
        self, *, interval_s: float = 0.02, workers: int = 2
    ) -> ReplicationService:
        """Start (and register) a background replication daemon."""
        svc = ReplicationService(self, interval_s=interval_s, workers=workers)
        self._services.append(svc)
        return svc.start()

    def stop_replication(self) -> None:
        """Stop every registered replication daemon."""
        for svc in self._services:
            svc.stop()
        self._services = []

    @property
    def _daemon_active(self) -> bool:
        return any(s.running for s in self._services)

    # ---------------------------------------------------------- observability
    def metrics_text(self) -> str:
        """Prometheus-style text dump of every metric series (zero
        dependencies) — for humans and CI artifacts."""
        return self.metrics.render_text()

    def metrics_snapshot(self) -> dict:
        """JSON-safe point-in-time dump of the cluster registry."""
        return self.metrics.snapshot()

    def publish_metrics(self) -> tuple[int, int]:
        """Snapshot the registry and produce it to the replicated
        internal ``__metrics`` topic (creating it on first use,
        ``rf=min(3, brokers)``). Returns ``(partition, offset)``. Goes
        through the routed produce path, so a snapshot lands even while
        a broker leader election is being completed lazily. Raises
        ``ClusterError``/``ControllerUnavailable`` when the cluster
        cannot accept it right now — callers (the reporter daemon)
        retry on the next interval."""
        payload = json.dumps(
            self.metrics.snapshot(), sort_keys=True
        ).encode("utf-8")
        if METRICS_TOPIC not in self._configs:
            self.ensure_topic(METRICS_TOPIC, LogConfig(
                num_partitions=1,
                replication_factor=min(3, len(self.brokers)),
            ))
        return self.produce(METRICS_TOPIC, payload)

    def start_metrics_reporter(
        self, *, interval_s: float = 0.05
    ) -> MetricsReporter:
        """Start (and register) a background metrics reporter daemon."""
        rep = MetricsReporter(self, interval_s=interval_s)
        self._reporters.append(rep)
        return rep.start()

    def stop_metrics_reporter(self) -> None:
        """Stop every registered metrics reporter."""
        for rep in self._reporters:
            rep.stop()
        self._reporters = []

    # ----------------------------------------------------------- elections
    def _election_command(self, ctl: _PartitionCtl) -> MetadataCommand:
        """Deterministic leader choice: lowest-id live ISR member wins
        (unclean election falls back to any live replica). Caller holds
        the partition lock; the choice becomes an ``ElectLeader`` command
        that must commit to the controller quorum before it applies."""
        candidates = sorted(
            b for b in ctl.isr if self.brokers[b].up and b != ctl.leader
        )
        if not candidates and self.allow_unclean_election:
            # last resort: any live replica, acked records may be lost
            candidates = sorted(
                b for b in ctl.replicas if self.brokers[b].up
            )
        new_leader = candidates[0] if candidates else None
        # live ISR survivors stay in-sync (they reconcile against the new
        # leader on the next replication pass); a leaderless (offline)
        # partition keeps its last-known ISR as the eligibility list
        isr = None
        if new_leader is not None:
            isr = tuple(sorted(
                {b for b in ctl.isr if self.brokers[b].up} | {new_leader}
            ))
        return MetadataCommand(
            kind="elect_leader", topic=ctl.topic, partition=ctl.partition,
            leader=new_leader, epoch=ctl.epoch + 1, isr=isr,
            pversion=ctl.version + 1, gen=ctl.gen,
        )

    def _elect(self, ctl: _PartitionCtl) -> None:
        """Change partition leadership through the replicated control
        plane: the election decision commits to the controller quorum's
        metadata log, then applies. Caller holds the partition lock.
        Raises :class:`ControllerUnavailable` (leadership unchanged) when
        the command cannot reach a controller majority — a partitioned
        controller minority can never move a leader (split-brain safety).
        """
        cmd = self._election_command(ctl)
        self.controller.submit(cmd)
        self._apply_metadata(cmd)

    # ------------------------------------------------------------ chaos hooks
    def kill_broker(self, broker_id: int, *, defer_election: bool = False) -> None:
        """Hard-crash a broker: every partition it led fails over.

        The liveness transition routes through the controller quorum as a
        ``RegisterBroker`` command; its application shrinks ISRs and
        elects through the dead leader. ``defer_election=True`` models the
        detection gap before the controller notices (Kafka's session
        timeout): the broker is down but nothing is registered — elections
        wait for the next replication pass (a daemon tick or explicit
        ``replicate_all``) or the next *StreamBackend-facade* produce/read
        to that partition, which elect through the dead leader lazily.
        Direct broker-protocol clients (``ClusterProducer``/
        ``ClusterConsumer``) see :class:`BrokerUnavailable` until one of
        those runs — the window follower reads are designed to bridge.
        With no controller quorum the registration itself is deferred the
        same way (the daemon retries once quorum returns).
        """
        with self._meta_lock:
            self.brokers[broker_id].alive = False
            self._note_leader_down(broker_id)
            if not defer_election:
                self._register_broker(broker_id, up=False)

    def partition_broker(self, broker_id: int, *, defer_election: bool = False) -> None:
        """Network-partition a broker away from the cluster."""
        with self._meta_lock:
            self.brokers[broker_id].reachable = False
            self._note_leader_down(broker_id)
            if not defer_election:
                self._register_broker(broker_id, up=False)

    def restart_broker(self, broker_id: int) -> None:
        """Bring a crashed broker back; it rejoins as a follower."""
        with self._meta_lock:
            self.brokers[broker_id].alive = True
            if not self._register_broker(broker_id, up=True):
                # no controller quorum: still catch up physically — ISR
                # re-entry (a quorum-committed ExpandIsr) waits for quorum
                self._rejoin(broker_id)

    def heal_broker(self, broker_id: int) -> None:
        """Heal a network partition; the broker rejoins as a follower."""
        with self._meta_lock:
            self.brokers[broker_id].reachable = True
            if not self._register_broker(broker_id, up=True):
                self._rejoin(broker_id)

    def _note_leader_down(self, broker_id: int) -> None:
        """Stamp election-duration start for every partition the dying
        broker leads (detection time; the matching elect_leader apply
        records the duration). Caller holds the metadata lock; ctl.leader
        is read without the ctl lock — this is observability bookkeeping,
        a torn read only mis-times one measurement."""
        if not self.metrics.enabled:
            return
        now = time.monotonic()
        for (topic, p), ctl in self._meta.items():
            if ctl.leader == broker_id:
                self._election_pending.setdefault((topic, p), now)

    def _register_broker(self, broker_id: int, *, up: bool) -> bool:
        """Commit a broker liveness transition to the metadata log and
        apply it. Returns False (transition stays pending) when there is
        no controller quorum — lazy election / rejoin paths complete the
        work once quorum returns."""
        cmd = MetadataCommand(kind="register_broker", broker_id=broker_id, up=up)
        try:
            self.controller.submit(cmd)
        except ControllerUnavailable:
            return False
        self._apply_metadata(cmd)
        return True

    def _apply_register_broker(self, cmd: MetadataCommand) -> None:
        bid = cmd.broker_id
        if cmd.up:
            self._rejoin(bid)
            return
        with self._meta_lock:
            ctls = list(self._meta.values())
        for ctl in ctls:
            with ctl.lock:
                if bid in ctl.isr and bid != ctl.leader:
                    self._propose_isr(ctl, set(ctl.isr) - {bid})
                if ctl.leader == bid and not self.brokers[bid].up:
                    try:
                        self._elect(ctl)
                    except ControllerUnavailable:
                        # quorum lost mid-sweep: this partition's election
                        # stays pending; daemon/lazy paths retry
                        continue

    def _rejoin(self, broker_id: int) -> None:
        br = self.brokers[broker_id]
        with self._meta_lock:
            ctls = list(self._meta.values())
        for ctl in ctls:
            with ctl.lock:
                if broker_id not in ctl.replicas:
                    continue
                if ctl.leader is None:
                    # partition was offline — the rejoining replica restores it
                    try:
                        self._elect(ctl)
                    except ControllerUnavailable:
                        pass
                    continue
                if ctl.leader == broker_id:
                    continue
                try:
                    # catch up as a follower; _replicate_partition performs
                    # the leader-epoch truncation before fetching
                    self._replicate_partition(ctl)
                except PartitionOffline:
                    # recorded leader dead (deferred election) with no other
                    # live ISR member: this partition stays offline, but the
                    # rejoin sweep — and the offset mirror below — continue
                    continue
                except ControllerUnavailable:
                    continue
        # mirror the (cluster-wide replicated) offset store back onto it
        with self._meta_lock:
            committed = {g: dict(o) for g, o in self._committed.items()}
        for group, offsets in committed.items():
            for tp, off in offsets.items():
                br.log.commit_offset(group, tp, off)

    # -------------------------------------------------- metadata application
    def _apply_metadata(self, cmd: MetadataCommand) -> None:
        """Apply one COMMITTED metadata command to cluster state — the
        state-machine half of the replicated control plane. Idempotent:
        partition commands are guarded by ``pversion``/topic generation,
        topic commands by existence, broker commands by liveness checks —
        so controller-failover replay (``controller_tick`` draining the
        committed-but-unapplied backlog) can never half-apply or
        double-apply a transition."""
        kind = cmd.kind
        if kind == "noop":
            return
        if kind == "register_broker":
            self._apply_register_broker(cmd)
            return
        if kind == "create_topic":
            self._apply_create_topic(cmd)
            return
        if kind == "delete_topic":
            self._apply_delete_topic(cmd)
            return
        if kind == "allocate_pid":
            self._apply_allocate_pid(cmd)
            return
        if kind in (
            "begin_txn", "add_partitions_to_txn", "add_offsets_to_txn",
            "prepare_commit", "prepare_abort", "complete_txn",
        ):
            self._apply_txn(cmd)
            return
        # partition-scoped commands
        key = (cmd.topic, cmd.partition)
        ctl = self._meta.get(key)
        if ctl is None:
            return
        with ctl.lock:
            # re-validate under the ctl lock: a concurrent delete_topic
            # pops the ctl from _meta (under the metadata lock) before
            # fencing it under this lock — a backlog replay that applied
            # past that check could un-fence a deleted partition
            if self._meta.get(key) is not ctl:
                return  # deleted (and fenced) since the lookup
            if cmd.gen is not None and self._topic_gens.get(cmd.topic) != cmd.gen:
                return  # topic deleted/recreated since the command committed
            if cmd.pversion is None or cmd.pversion <= ctl.version:
                return  # already applied (or a stale duplicate)
            ctl.version = cmd.pversion
            if kind == "elect_leader":
                ctl.epoch = cmd.epoch
                ctl.leader = cmd.leader
                if self.metrics.enabled:
                    # inside the pversion guard, so controller-failover
                    # replay of the same committed election can never
                    # double-count (exactly once per election)
                    self.metrics.counter(
                        "partition_elections_total", topic=ctl.topic,
                        partition=ctl.partition,
                    ).inc()
                    since = self._election_pending.pop(key, None)
                    if since is not None:
                        self.metrics.histogram(
                            "election_duration_seconds"
                        ).record(time.monotonic() - since)
                if cmd.leader is None:
                    return  # offline fence: epoch bumped, ISR retained
                ctl.isr = set(cmd.isr)
                new_leo = self.brokers[cmd.leader].log.end_offset(
                    ctl.topic, ctl.partition
                )
                ctl.epoch_starts[cmd.epoch] = new_leo
                ctl.synced_epoch[cmd.leader] = cmd.epoch
                # at acks=all the new leader holds every record below the
                # HW, so the HW is stable; an unclean (or acks<all)
                # election may regress it
                ctl.hw = min(ctl.hw, new_leo)
                # a deposed-but-live old leader (healed network partition)
                # is reconciled as a follower on the next replication pass
            elif kind in ("shrink_isr", "expand_isr"):
                ctl.isr = set(cmd.isr)

    # -------------------------------------------------- controller lifecycle
    def controller_tick(self) -> bool:
        """One control-plane heartbeat: quorum lease renewal / controller
        election, then apply any committed-but-unapplied metadata backlog
        (commands a dead controller leader committed but never applied),
        then — when controller leadership changed — complete partition
        elections the dead controller left pending. Returns True on a
        controller leadership change. Driven by the replication daemon."""
        changed = self.controller.tick()
        for entry in self.controller.take_unapplied():
            self._apply_metadata(entry.command)
        if changed:
            self._complete_pending_elections()
        # two-phase-commit recovery: transactions whose prepare decision
        # is durable but whose driver died finish here, on any tick — not
        # just leadership changes (the driver may have died without its
        # controller)
        self._resume_pending_txns()
        return changed

    def _complete_pending_elections(self) -> None:
        """Elect through every dead partition leader — and restore
        leaderless (offline) partitions that regained an eligible replica
        while the quorum was down (a new controller leader's first duty
        after winning its own election)."""
        with self._meta_lock:
            ctls = list(self._meta.values())
        for ctl in ctls:
            with ctl.lock:
                leader_down = (
                    ctl.leader is not None and not self.brokers[ctl.leader].up
                )
                if not leader_down and ctl.leader is not None:
                    continue
                cmd = self._election_command(ctl)
                if ctl.leader is None and cmd.leader is None:
                    continue  # still no eligible candidate: stay offline
                try:
                    self.controller.submit(cmd)
                    self._apply_metadata(cmd)
                except ControllerUnavailable:
                    return

    def kill_controller(self) -> int:
        """Chaos hook: crash the current controller-leader node (electing
        one first if the quorum is fresh). Returns the killed node id; the
        surviving quorum elects a successor on the next controller tick
        and completes any partition elections left pending."""
        lid = self.controller.ensure_leader()
        self.controller.kill_node(lid)
        return lid

    def restart_controller(self, node_id: int) -> None:
        """Bring a crashed controller node back; it rejoins as a follower
        and its log is reconciled by the next leader heartbeat."""
        self.controller.restart_node(node_id)

    def live_brokers(self) -> list[int]:
        return sorted(b.broker_id for b in self.brokers.values() if b.up)

    # ------------------------------------------- broker-level client protocol
    def _check_leader(self, broker_id: int, ctl: _PartitionCtl) -> Broker:
        br = self.brokers.get(broker_id)
        if br is None or not br.up:
            raise BrokerUnavailable(f"broker {broker_id} is down")
        if ctl.leader != broker_id:
            raise NotLeaderError(ctl.topic, ctl.partition, ctl.leader)
        return br

    def broker_append(
        self,
        broker_id: int,
        topic: str,
        partition: int,
        values: Sequence[bytes],
        *,
        keys: Sequence[bytes | None] | None = None,
        acks: int | str | None = None,
        epoch: int | None = None,
        producer: tuple[int, int, int] | None = None,
        transactional: bool = False,
    ) -> tuple[int, int]:
        """Leader-side ProduceRequest. Returns ``(first, last)`` offsets.

        ``transactional=True`` (requires ``producer``) marks the batch as
        part of the producer's open transaction: it replicates and acks
        like any idempotent batch, but stays above the LSO — invisible to
        ``read_committed`` consumers — until the transaction coordinator
        writes its COMMIT/ABORT marker.

        ``acks='all'`` replicates to every live ISR follower and advances
        the high watermark before returning — the acknowledged records are
        then on every ISR member, so they survive any single broker loss
        whenever the ISR held >= 2 members at ack time
        (``min_insync_replicas=2`` makes that a hard precondition).

        If leadership moves mid-append (the addressed broker died between
        the leader check and the HW advance) and the batch did not commit,
        the ack is withheld and :class:`NotLeaderError` raised instead —
        the records sit only on the deposed leader, where epoch
        reconciliation will truncate them, and clients retry against the
        new leader. The commit test is ``hw > last``: the partition lock
        is held across append+commit, so offsets ``[first, last]`` can
        hold no other producer's records — if the HW passed ``last``, the
        committed records *are* this batch (even when a direct-pushed
        follower won the election mid-call) and acking is exact, never
        duplicated. Zero-acked-loss therefore holds under concurrent
        broker failures without re-append duplicates.

        ``producer=(pid, epoch, base_seq)`` makes the append idempotent:
        the leader's per-partition producer-state table resolves a retried
        batch — same pid/epoch/sequences, e.g. the response to an append
        that *did* commit was lost, so the client re-sent it — to its
        original offsets instead of re-appending. That closes the one
        duplicate window the ``hw > last`` test cannot: a committed append
        whose ack never reached the client. A stale producer epoch raises
        :class:`~repro.core.log.ProducerFenced` (zombie fencing; fatal,
        never retried); a sequence gap raises
        :class:`~repro.core.log.OutOfOrderSequence`.
        """
        acks = self.default_acks if acks is None else acks
        if acks not in (0, 1, "all", -1):
            raise ValueError(f"bad acks {acks!r}; want 0, 1, or 'all'")
        ctl = self._ctl(topic, partition)
        m = self.metrics
        t0 = time.perf_counter() if m.enabled else 0.0
        with ctl.lock:
            br = self._check_leader(broker_id, ctl)
            if epoch is not None and epoch != ctl.epoch:
                raise NotLeaderError(topic, partition, ctl.leader)
            if acks in ("all", -1):
                cfg = self._configs.get(topic)  # plain dict read: no meta
                if cfg is None:                 # lock under a ctl lock
                    # topic deleted under us — surface the offline fence,
                    # not a raw KeyError the client retry loops don't know
                    raise PartitionOffline(f"{topic}:{partition} was deleted")
                live_isr = [b for b in ctl.isr if self.brokers[b].up]
                if len(live_isr) < cfg.min_insync_replicas:
                    raise NotEnoughReplicasError(
                        f"{topic}:{partition} ISR {sorted(live_isr)} below "
                        f"min.insync.replicas={cfg.min_insync_replicas}"
                    )
            # stamp the batch once so leader and followers agree on record
            # timestamps (and therefore on retention_ms expiry)
            now_ms = int(self._clock() * 1000)
            if producer is not None:
                pid, pep, pseq = producer
                known = self._producer_epochs.get(pid)  # plain dict read
                if known is not None and pep < known:
                    # cluster-wide zombie fence: a newer incarnation of
                    # this producer id was granted (AllocatePid with a
                    # bumped epoch) — reject even on partitions the new
                    # incarnation has not written to yet
                    raise ProducerFenced(
                        f"producer {pid} epoch {pep} fenced by granted "
                        f"epoch {known}"
                    )
                first, last, dup = br.log.producer_append(
                    topic, partition, values, keys, now_ms, pid, pep, pseq,
                    txn=transactional,
                )
                if dup:
                    # the batch is already in the log from a previous
                    # delivery; make sure it is *committed* before acking
                    # its original offsets (it may have ridden a direct
                    # push whose HW advance died with the old leader)
                    if acks in ("all", -1) and ctl.hw <= last:
                        self._replicate_partition(ctl)
                        if ctl.hw <= last:
                            raise NotLeaderError(topic, partition, ctl.leader)
                    if m.enabled:
                        self._c_produce_dups.inc()
                        self._h_produce_latency.record(
                            time.perf_counter() - t0
                        )
                    return first, last
            else:
                first, last = br.log.replica_append(
                    topic, partition, values, keys, now_ms
                )
            if acks in ("all", -1):
                tc = time.perf_counter() if m.enabled else 0.0
                self._commit_batch(
                    ctl, values, keys, now_ms, first, last, producer,
                    txn=transactional,
                )
                if m.enabled:
                    # acks=all commit latency: ISR push + HW advance
                    self._h_commit_latency.record(time.perf_counter() - tc)
                if ctl.hw <= last:
                    # leadership moved under us mid-append and the batch
                    # did not commit: it must not be acknowledged (a new
                    # leader without it caps the HW at `first` or below)
                    raise NotLeaderError(topic, partition, ctl.leader)
            if m.enabled:
                mp = ctl.m_produce
                if mp is None:
                    mp = ctl.m_produce = m.counter(
                        "produce_records_total", topic=topic,
                        partition=partition,
                    )
                mp.inc(len(values))
                self._h_produce_latency.record(time.perf_counter() - t0)
            return first, last

    def broker_fetch(
        self,
        broker_id: int,
        topic: str,
        partition: int,
        offset: int,
        max_records: int = 1024,
        *,
        allow_follower: bool = False,
        isolation: str | None = None,
    ) -> RecordBatch:
        """Leader-side FetchRequest, capped at the high watermark.

        With ``allow_follower=True`` a fetch addressed to an **in-sync**
        follower is served from that follower's local log (still capped at
        the HW) instead of raising :class:`NotLeaderError` — records below
        the HW are on every ISR member and immutable, so the response is
        stale-bounded but never divergent. Out-of-sync replicas never
        serve: their log may hold a deposed leader's suffix below the HW.

        ``isolation="read_committed"`` additionally caps the read at the
        serving replica's last stable offset (LSO) and filters out control
        markers and aborted transactions' records. Below the HW every ISR
        member derives the identical transaction state from its identical
        log, so follower reads stay exact at read_committed too.
        """
        ctl = self._ctl(topic, partition)
        m = self.metrics
        t0 = time.perf_counter() if m.enabled else 0.0
        with ctl.lock:
            br = self.brokers.get(broker_id)
            if br is None or not br.up:
                raise BrokerUnavailable(f"broker {broker_id} is down")
            if ctl.leader == broker_id:
                if not self._daemon_active or ctl.hw <= offset:
                    self._replicate_partition(ctl)  # opportunistic HW advance
                batch = self._read_visible(
                    br, ctl, offset, max_records, isolation
                )
            elif not allow_follower or broker_id not in ctl.isr:
                raise NotLeaderError(topic, partition, ctl.leader)
            else:
                batch = self._read_visible(
                    br, ctl, offset, max_records, isolation
                )
            if m.enabled:
                self._h_fetch_latency.record(time.perf_counter() - t0)
            return batch

    def _serving_follower(self, ctl: _PartitionCtl) -> Broker | None:
        """Lowest-id live in-sync non-leader replica, or None — the single
        eligibility rule for every follower-read fallback path. Caller
        holds the ctl lock."""
        for bid in sorted(ctl.isr):
            if bid != ctl.leader and self.brokers[bid].up:
                return self.brokers[bid]
        return None

    def _read_visible(
        self,
        br: Broker,
        ctl: _PartitionCtl,
        offset: int,
        max_records: int,
        isolation: str | None = None,
    ) -> RecordBatch:
        """Serve a read from ``br``'s local log, capped at the high
        watermark. ``br`` is the leader or an in-sync follower — an ISR
        member's log always extends to the HW, so bounding by its own end
        offset is equivalent for both. read_committed caps additionally
        at the serving replica's LSO."""
        end = br.log.end_offset(ctl.topic, ctl.partition)
        if offset > end:
            raise OffsetOutOfRange(
                f"{ctl.topic}:{ctl.partition} offset {offset} > end {end}"
            )
        cap = min(ctl.hw, end)
        if isolation == "read_committed":
            cap = min(cap, br.log.last_stable_offset(ctl.topic, ctl.partition))
        n = min(max_records, max(cap - offset, 0))
        if n <= 0:
            return RecordBatch(
                topic=ctl.topic,
                partition=ctl.partition,
                first_offset=offset,
                values=[],
                timestamps=[],
            )
        batch = br.log.read(ctl.topic, ctl.partition, offset, n, isolation)
        if self.metrics.enabled and len(batch):
            mf = ctl.m_fetch
            if mf is None:
                mf = ctl.m_fetch = self.metrics.counter(
                    "fetch_records_total", topic=ctl.topic,
                    partition=ctl.partition,
                )
            mf.inc(len(batch))
        return batch

    # ------------------------------------- StreamBackend facade (StreamLog)
    # Everything below makes the cluster a drop-in for StreamLog: internal
    # routing retries through leader changes, so the pipeline/trainer/server
    # survive a broker loss mid-call without knowing about brokers at all.
    def _routed_append(
        self,
        topic: str,
        values: Sequence[bytes],
        keys: Sequence[bytes | None] | None,
        partition: int | None,
        acks: int | str | None = None,
    ) -> tuple[int, int, int]:
        nparts = self.num_partitions(topic)
        if partition is None:
            partition = default_partition(
                keys, nparts, int(self._clock() * 1000)
            )
        ctl = self._ctl(topic, partition)
        last_err: ClusterError | None = None
        # Leadership is pinned while the partition lock is held, but the
        # addressed broker may die between the leader check and the ack
        # (flags flip without the partition lock) — re-resolve and retry;
        # _leader_broker elects through the dead leader. PartitionOffline
        # propagates: there is nothing to retry against.
        for _ in range(_ROUTED_RETRIES):
            with ctl.lock:
                leader = self._leader_broker(ctl)
                try:
                    first, last = self.broker_append(
                        leader.broker_id, topic, partition, values,
                        keys=keys, acks=acks,
                    )
                    return partition, first, last
                except (NotLeaderError, BrokerUnavailable) as e:
                    last_err = e
        raise last_err

    def produce(
        self,
        topic: str,
        value: bytes,
        *,
        key: bytes | None = None,
        partition: int | None = None,
        acks: int | str | None = None,
    ) -> tuple[int, int]:
        p, first, _ = self._routed_append(topic, [value], [key], partition, acks)
        return p, first

    def produce_batch(
        self,
        topic: str,
        values: Sequence[bytes],
        *,
        keys: Sequence[bytes | None] | None = None,
        partition: int | None = None,
        acks: int | str | None = None,
    ) -> tuple[int, int, int]:
        return self._routed_append(topic, values, keys, partition, acks)

    def read(
        self,
        topic: str,
        partition: int,
        offset: int,
        max_records: int = 1024,
        isolation: str | None = None,
    ) -> RecordBatch:
        ctl = self._ctl(topic, partition)
        with ctl.lock:
            leader_id = ctl.leader
            if leader_id is not None and self.brokers[leader_id].up:
                # live leader: serve from it; skip the inline replication
                # pass when a daemon is advancing the HW in the background
                # (unless the read would come back empty without it)
                if not self._daemon_active or ctl.hw <= offset:
                    self._replicate_partition(ctl)
                return self._read_visible(
                    self.brokers[ctl.leader], ctl, offset, max_records, isolation
                )
            if self.follower_reads:
                # leader down/None: keep serving committed records from an
                # in-sync follower while the election is pending
                follower = self._serving_follower(ctl)
                if follower is not None:
                    return self._read_visible(
                        follower, ctl, offset, max_records, isolation
                    )
            leader = self._leader_broker(ctl)  # lazy election / offline
            self._replicate_partition(ctl)
            return self._read_visible(leader, ctl, offset, max_records, isolation)

    def read_range(
        self, topic: str, partition: int, offset: int, length: int
    ) -> RecordBatch:
        # the window is counted in raw offsets: a filtered batch's
        # `scanned` — not its delivered record count — says how much of
        # it was actually readable (control markers occupy offsets but
        # are never delivered; see StreamLog.read_range)
        def covered(b: RecordBatch) -> int:
            return b.scanned if b.scanned is not None else len(b)

        batch = self.read(topic, partition, offset, length)
        if covered(batch) < length:
            # the shortfall may just be a daemon-stale HW (read() skips the
            # inline pass when some records are visible): force one pass
            # and retry before declaring the range unreadable
            ctl = self._ctl(topic, partition)
            try:
                with ctl.lock:
                    self._replicate_partition(ctl)
            except PartitionOffline:
                pass  # follower reads may still serve below the HW
            batch = self.read(topic, partition, offset, length)
        if covered(batch) < length:
            ctl = self._ctl(topic, partition)
            with ctl.lock:
                hw = ctl.hw
            raise OffsetOutOfRange(
                f"{topic}:{partition} range [{offset}, {offset + length}) extends "
                f"past high watermark {hw}"
            )
        return batch

    def iter_range(
        self,
        topic: str,
        partition: int,
        offset: int,
        length: int,
        chunk: int = 4096,
    ) -> Iterator[RecordBatch]:
        done = 0
        while done < length:
            take = min(chunk, length - done)
            yield self.read_range(topic, partition, offset + done, take)
            done += take

    def start_offset(self, topic: str, partition: int) -> int:
        ctl = self._ctl(topic, partition)
        with ctl.lock:
            leader_id = ctl.leader
            if leader_id is None or not self.brokers[leader_id].up:
                if self.follower_reads:
                    follower = self._serving_follower(ctl)
                    if follower is not None:
                        return follower.log.start_offset(topic, partition)
                leader_id = self._leader_broker(ctl).broker_id
            return self.brokers[leader_id].log.start_offset(topic, partition)

    def end_offset(self, topic: str, partition: int) -> int:
        """Consumer-visible end: the high watermark (not the leader LEO)."""
        ctl = self._ctl(topic, partition)
        with ctl.lock:
            leader_id = ctl.leader
            if (
                self.follower_reads
                and (leader_id is None or not self.brokers[leader_id].up)
                and self._serving_follower(ctl) is not None
            ):
                # leader down but in-sync followers serve: report the HW
                # as-is rather than forcing an election from the read path
                return ctl.hw
            self._leader_broker(ctl)  # refresh leadership if stale
            if not self._daemon_active:
                self._replicate_partition(ctl)
            return ctl.hw

    def log_end_offset(self, topic: str, partition: int) -> int:
        """Leader log end offset (includes not-yet-replicated records)."""
        ctl = self._ctl(topic, partition)
        with ctl.lock:
            leader = self._leader_broker(ctl)
            return leader.log.end_offset(topic, partition)

    def last_stable_offset(self, topic: str, partition: int) -> int:
        """Consumer-visible read_committed bound: min(HW, leader LSO)."""
        ctl = self._ctl(topic, partition)
        with ctl.lock:
            leader = self._leader_broker(ctl)
            return min(ctl.hw, leader.log.last_stable_offset(topic, partition))

    def size_bytes(self, topic: str, partition: int | None = None) -> int:
        if partition is not None:
            ctl = self._ctl(topic, partition)
            with ctl.lock:
                return self._leader_broker(ctl).log.size_bytes(topic, partition)
        return sum(
            self.size_bytes(topic, p)
            for p in range(self.num_partitions(topic))
        )

    # -------------------------------------------------- consumer offset store
    # Kafka's `__consumer_offsets`, replicated at cluster width: commits
    # fan out to every live broker (and are re-mirrored on rejoin), and
    # reads are served from a live broker's replica — so committed offsets
    # survive any broker loss. The controller dict is the recovery fallback
    # for the no-live-broker window.
    def commit_offset(self, group: str, tp: TopicPartition, offset: int) -> None:
        with self._meta_lock:
            self._committed.setdefault(group, {})[tp] = offset
            for br in self.brokers.values():
                if br.up:
                    br.log.commit_offset(group, tp, offset)

    def committed_offset(self, group: str, tp: TopicPartition) -> int | None:
        with self._meta_lock:
            for bid in sorted(self.brokers):
                if self.brokers[bid].up:
                    return self.brokers[bid].log.committed_offset(group, tp)
            return self._committed.get(group, {}).get(tp)


# ------------------------------------------------------------------ clients
class _MetadataCache:
    """Client-side partition→leader cache shared by producer and consumer.

    ``leader`` serves from cache (refreshing a whole topic on miss);
    ``note_leader_hint`` applies a NotLeaderError's hint; ``invalidate``
    drops an entry so the next lookup refreshes. ``metadata_refreshes``
    counts round-trips, the client-observable cost of failover.
    """

    def __init__(self, cluster: BrokerCluster):
        self.cluster = cluster
        self._leaders: dict[tuple[str, int], int | None] = {}
        self.metadata_refreshes = 0

    def leader(self, topic: str, partition: int) -> int:
        key = (topic, partition)
        if key not in self._leaders:
            self.metadata_refreshes += 1
            for p, meta in self.cluster.metadata(topic).items():
                self._leaders[(topic, p)] = meta.leader
        leader = self._leaders.get(key)
        if leader is None:
            raise PartitionOffline(f"{topic}:{partition} has no leader")
        return leader

    def note_leader_hint(self, topic: str, partition: int, hint: int | None) -> None:
        self._leaders[(topic, partition)] = hint

    def invalidate(self, topic: str, partition: int) -> None:
        self._leaders.pop((topic, partition), None)


class ClusterProducer:
    """Failover-aware producer: metadata cache + leader routing + retry.

    The client-side half of the Kafka produce protocol: it routes every
    batch to the cached leader broker, and when the cluster answers
    :class:`NotLeaderError` (stale cache after an election) or
    :class:`BrokerUnavailable` (cached leader died), it refreshes metadata
    and retries — so a broker loss mid-stream costs one round-trip, not the
    stream.

    ``idempotent=True`` upgrades that retry loop from at-least-once to
    **exactly-once**: the producer asks the cluster for a committed
    ``(pid, epoch)`` identity (:meth:`BrokerCluster.init_producer`) and
    stamps every batch with per-partition sequence numbers, so a retry of
    a batch whose ack was lost — or that landed on a deposed leader whose
    direct push already committed it — resolves to the *original* offsets
    instead of re-appending. ``producer_name`` additionally pins a stable
    identity: re-initializing the same name bumps the epoch and fences the
    previous incarnation (its in-flight appends raise
    :class:`~repro.core.log.ProducerFenced`, which is fatal and never
    retried here). Each producer instance is single-threaded, like the
    rest of the client surface.
    """

    def __init__(
        self,
        cluster: BrokerCluster,
        *,
        acks: int | str = "all",
        retries: int = 5,
        idempotent: bool = False,
        producer_name: str | None = None,
        transactional_id: str | None = None,
    ):
        self.cluster = cluster
        self.acks = acks
        self.retries = retries
        # a transactional producer IS an idempotent producer whose stable
        # name is the transactional id (Kafka's transactional.id): the
        # committed epoch bump on re-initialization is what fences a
        # zombie's in-flight transaction
        self.transactional_id = transactional_id
        if transactional_id is not None:
            producer_name = transactional_id
        self.idempotent = idempotent or producer_name is not None
        if self.idempotent and acks not in ("all", -1):
            # as in Kafka: idempotence requires acks=all. At acks=0/1 an
            # acked suffix may be truncated by reconciliation, after which
            # the producer's next sequence looks like a gap and dies with
            # OutOfOrderSequence — turning permitted acks<all loss into a
            # fatal client error. Refuse the combination up front.
            raise ValueError(
                f"idempotent producers require acks='all' (got {acks!r})"
            )
        self.producer_id: int | None = None
        self.producer_epoch: int | None = None
        if self.idempotent:
            self.producer_id, self.producer_epoch = cluster.init_producer(
                producer_name
            )
        self._seqs: dict[tuple[str, int], int] = {}  # next seq per partition
        # an idempotent send that failed is *unresolved*: some attempt may
        # have appended the batch under its sequence even though no ack
        # arrived. Re-using that sequence for a DIFFERENT batch could
        # silently dedup the new data against the old batch's offsets
        # (data loss), so the partition is pinned to a same-batch
        # continuation: tp -> (seq, payload digest). Re-sending the
        # identical batch resumes the retry exactly-once; anything else
        # raises ProducerFenced (recovery: a new producer, fresh pid).
        self._unresolved: dict[tuple[str, int], tuple[int, bytes]] = {}
        self._meta = _MetadataCache(cluster)
        self._sticky: dict[str, int] = {}
        self._in_txn = False
        self._txn_parts: set[tuple[str, int]] = set()

    # ------------------------------------------------------------ transactions
    def begin_txn(self) -> None:
        """Open a transaction: every ``send``/``send_batch`` until
        ``commit_txn``/``abort_txn`` becomes atomic with the others (and
        with any offsets attached via :meth:`send_offsets_to_txn`)."""
        if self.transactional_id is None:
            raise InvalidTxnState(
                "transactions require ClusterProducer(transactional_id=...)"
            )
        if self._in_txn:
            raise InvalidTxnState("transaction already in progress")
        self.cluster.begin_txn(self.producer_id, self.producer_epoch)
        self._in_txn = True
        self._txn_parts = set()

    def send_offsets_to_txn(
        self, group_id: str, offsets: dict[TopicPartition, int]
    ) -> None:
        """Attach consumer offsets to the open transaction — they commit
        to the replicated offset store atomically with the produced
        records (the read-process-write exactly-once primitive)."""
        if not self._in_txn:
            raise InvalidTxnState("no transaction in progress")
        self.cluster.txn_add_offsets(
            self.producer_id, self.producer_epoch, group_id, offsets
        )

    @property
    def in_txn(self) -> bool:
        return self._in_txn

    def commit_txn(self) -> None:
        """Commit the open transaction. Raises ``ClusterError`` when the
        cluster cannot complete the two-phase commit right now — the
        transaction is then either still ongoing (prepare never committed;
        retry or abort) or durably prepared (the cluster finishes it on a
        controller tick; a retry here also re-drives it, idempotently)."""
        if not self._in_txn:
            raise InvalidTxnState("no transaction in progress")
        try:
            self.cluster.commit_txn(self.producer_id, self.producer_epoch)
        except (InvalidTxnState, ProducerFenced):
            # the transaction is beyond this operation (opposite outcome
            # decided, or a newer incarnation fenced us): locally over
            self._in_txn = False
            raise
        self._in_txn = False

    def abort_txn(self) -> None:
        """Abort the open transaction: its records become permanently
        invisible to read_committed consumers, its offsets never apply.
        Raises :class:`InvalidTxnState` when a COMMIT is already durably
        decided — the transaction will complete as committed regardless;
        the local transaction is considered over either way."""
        if not self._in_txn:
            raise InvalidTxnState("no transaction in progress")
        try:
            self.cluster.abort_txn(self.producer_id, self.producer_epoch)
        except (InvalidTxnState, ProducerFenced):
            self._in_txn = False
            raise
        self._in_txn = False

    @property
    def metadata_refreshes(self) -> int:
        return self._meta.metadata_refreshes

    def _pick_partition(self, topic: str, key: bytes | None) -> int:
        n = self.cluster.num_partitions(topic)
        if key is not None:
            return default_partition([key], n, 0)  # same key→partition map
        # sticky partitioner: stay on one partition per topic per producer
        return self._sticky.setdefault(topic, hash(id(self)) % n)

    def send(
        self,
        topic: str,
        value: bytes,
        *,
        key: bytes | None = None,
        partition: int | None = None,
    ) -> tuple[int, int]:
        p, first, _ = self.send_batch(topic, [value], keys=[key], partition=partition)
        return p, first

    def send_batch(
        self,
        topic: str,
        values: Sequence[bytes],
        *,
        keys: Sequence[bytes | None] | None = None,
        partition: int | None = None,
    ) -> tuple[int, int, int]:
        if partition is None:
            k = keys[0] if keys else None
            partition = self._pick_partition(topic, k)
        producer = None
        if self.idempotent:
            tp = (topic, partition)
            pending = self._unresolved.get(tp)
            if pending is not None:
                if self._fingerprint(values, keys) != pending[1]:
                    raise ProducerFenced(
                        f"producer {self.producer_id} has an unresolved "
                        f"send on {topic}:{partition} (ack never arrived; "
                        "the batch may be committed under its sequence): "
                        "only an identical re-send may continue — create "
                        "a new producer to move on"
                    )
                seq = pending[0]  # continuation of the unresolved retry
            else:
                seq = self._seqs.get(tp, 0)
            # the same (pid, epoch, seq) stamp rides every retry of this
            # batch, so a re-send of an already-committed append dedups on
            # the broker and returns the original offsets; the sequence
            # only advances once the batch is acknowledged
            producer = (self.producer_id, self.producer_epoch, seq)
        if self._in_txn and (topic, partition) not in self._txn_parts:
            # the partition joins the transaction's registered set (a
            # committed AddPartitionsToTxn) BEFORE its first append, so
            # the coordinator knows where markers must go even if this
            # producer dies one line down
            self.cluster.txn_add_partitions(
                self.producer_id, self.producer_epoch, [(topic, partition)]
            )
            self._txn_parts.add((topic, partition))
        last_err: ClusterError | None = None
        try:
            for _ in range(self.retries + 1):
                try:
                    leader = self._meta.leader(topic, partition)
                    first, last = self.cluster.broker_append(
                        leader, topic, partition, values, keys=keys,
                        acks=self.acks, producer=producer,
                        transactional=self._in_txn,
                    )
                    if producer is not None:
                        self._unresolved.pop((topic, partition), None)
                        self._seqs[(topic, partition)] = (
                            producer[2] + len(values)
                        )
                    return partition, first, last
                except NotLeaderError as e:
                    self._meta.note_leader_hint(topic, partition, e.leader_hint)
                    last_err = e
                except (BrokerUnavailable, PartitionOffline) as e:
                    self._meta.invalidate(topic, partition)
                    last_err = e
            raise last_err  # exhausted retries
        except BaseException:
            if producer is not None:
                # ANY non-success exit — exhausted retries, or an error
                # outside the retried set (NotEnoughReplicasError, a
                # quorum window, ...) escaping after an earlier attempt
                # may already have appended — leaves the outcome unknown:
                # pin this partition's sequence to an identical re-send
                # of this batch
                self._unresolved[(topic, partition)] = (
                    producer[2], self._fingerprint(values, keys)
                )
            raise

    @staticmethod
    def _fingerprint(
        values: Sequence[bytes], keys: Sequence[bytes | None] | None
    ) -> bytes:
        """Identity of a batch's contents, used only around unresolved
        sends (never on the happy path): a continuation re-send must carry
        the same payload or the pinned sequence would ack wrong data. A
        real digest, not Python's ``hash()`` — a collision here acks new
        data at old offsets, the exact loss this mechanism prevents."""
        h = hashlib.sha256()
        for v in values:
            h.update(len(v).to_bytes(4, "big"))
            h.update(v)
        h.update(b"\xffK")
        # keys=None and keys=[None]*n append identically, so they must
        # fingerprint identically too (a continuation must not be wedged
        # by spelling the same batch the other way)
        if keys is not None and any(k is not None for k in keys):
            for k in keys:
                if k is None:
                    h.update(b"\xff\xff\xff\xff")
                else:
                    kb = bytes(k)
                    h.update(len(kb).to_bytes(4, "big"))
                    h.update(kb)
        return h.digest()


class ClusterConsumer:
    """Failover-aware fetcher: routes reads to the partition leader and
    retries through elections; offsets commit to the replicated store.

    ``follower_reads=True`` adds the Kafka 2.4 "fetch from follower" mode:
    when the leader is unreachable (or the partition is leaderless
    mid-election), the fetch falls back to an in-sync follower, capped at
    the high watermark — bounded staleness, never divergence.

    ``isolation_level="read_committed"`` caps every fetch at the last
    stable offset and filters out control markers and aborted
    transactions' records: the consumer observes a transaction's records
    only after its COMMIT marker, and never observes an aborted one.
    """

    def __init__(self, cluster: BrokerCluster, *, group_id: str | None = None,
                 retries: int = 5, follower_reads: bool = False,
                 isolation_level: str | None = None):
        self.cluster = cluster
        self.group_id = group_id
        self.retries = retries
        self.follower_reads = follower_reads
        self.isolation_level = isolation_level
        self.follower_fetches = 0
        self._meta = _MetadataCache(cluster)

    @property
    def metadata_refreshes(self) -> int:
        return self._meta.metadata_refreshes

    def fetch(
        self, topic: str, partition: int, offset: int, max_records: int = 1024
    ) -> RecordBatch:
        last_err: ClusterError | None = None
        for _ in range(self.retries + 1):
            try:
                leader = self._meta.leader(topic, partition)
                return self.cluster.broker_fetch(
                    leader, topic, partition, offset, max_records,
                    isolation=self.isolation_level,
                )
            except NotLeaderError as e:
                self._meta.note_leader_hint(topic, partition, e.leader_hint)
                last_err = e
            except (BrokerUnavailable, PartitionOffline) as e:
                self._meta.invalidate(topic, partition)
                last_err = e
                if self.follower_reads:
                    batch = self._follower_fetch(
                        topic, partition, offset, max_records
                    )
                    if batch is not None:
                        return batch
        raise last_err

    def _follower_fetch(
        self, topic: str, partition: int, offset: int, max_records: int
    ) -> RecordBatch | None:
        """Try each in-sync replica in turn; None if none can serve."""
        try:
            # single-partition metadata: touches only this partition's lock
            meta = self.cluster.partition_meta(topic, partition)
        except (KeyError, IndexError):
            return None
        for b in sorted(meta.isr):
            if b == meta.leader:
                continue
            try:
                batch = self.cluster.broker_fetch(
                    b, topic, partition, offset, max_records,
                    allow_follower=True, isolation=self.isolation_level,
                )
            except ClusterError:
                continue
            self.follower_fetches += 1
            return batch
        return None

    def position_bounds(self, topic: str, partition: int) -> tuple[int, int]:
        """(log start, high watermark) for the partition."""
        return (
            self.cluster.start_offset(topic, partition),
            self.cluster.end_offset(topic, partition),
        )

    def commit(self, tp: TopicPartition, offset: int) -> None:
        if self.group_id is None:
            raise ValueError("consumer has no group_id")
        self.cluster.commit_offset(self.group_id, tp, offset)

    def committed(self, tp: TopicPartition) -> int | None:
        if self.group_id is None:
            raise ValueError("consumer has no group_id")
        return self.cluster.committed_offset(self.group_id, tp)

    def lag(self, topic: str, partition: int, *,
            offset: int | None = None) -> int:
        """LSO-aware consumer lag for one partition.

        Lag is measured against min(HW, LSO) for ``read_committed``
        consumers — records behind an open transaction are not
        consumable, so they must not count as lag — and against the
        high watermark otherwise. ``offset`` overrides the consumer
        position; by default the group's committed offset is used
        (0 when nothing has been committed). Never negative.
        """
        if offset is None:
            if self.group_id is not None:
                offset = self.cluster.committed_offset(
                    self.group_id, TopicPartition(topic, partition)
                ) or 0
            else:
                offset = 0
        if self.isolation_level == "read_committed":
            bound = self.cluster.last_stable_offset(topic, partition)
        else:
            bound = self.cluster.end_offset(topic, partition)
        lag = max(0, bound - offset)
        m = self.cluster.metrics
        if m.enabled and self.group_id is not None:
            m.gauge(
                "consumer_lag", group=self.group_id,
                topic=topic, partition=str(partition),
            ).set(lag)
        return lag
