"""Consumer groups — load balancing + fault tolerance (paper §II, §IV-D).

Kafka-ML leans on the Kafka consumer-group feature twice:

* inference *replicas* join one group so partitions (and therefore request
  load) are spread across them, and a dead replica's partitions are
  reassigned to the survivors;
* committed offsets give at-least-once delivery: a restarted member resumes
  from its group's committed offset rather than re-reading the stream.

This module implements the group coordinator: deterministic *range*
assignment (Kafka's default), generation-numbered rebalances on
join/leave/failure, heartbeat-based failure detection, and offset commit
backed by the log's offset store.

Groups run against any :class:`~repro.core.log.StreamBackend` — a bare
:class:`StreamLog` or a replicated :class:`~repro.core.cluster.BrokerCluster`.
On a cluster, reads route to partition leaders through elections and
committed offsets live in the cluster-replicated offset store, so a group
resumes from its committed offsets on the new leader after a broker loss.
A partition that is momentarily unavailable (leader election in flight,
no in-sync follower to serve) is skipped for that poll rather than
failing the member — the next poll retries it; the same applies to
resolving its committed offset after a rebalance. Offset commits are
fenced on the generation the positions were polled under, so a zombie
member (evicted, or holding positions from before a rebalance) can never
rewind the committed offset under a partition's new owner; eviction
surfaces as a typed :class:`RebalanceError` with
:meth:`GroupConsumer.rejoin` as the recovery path.

The coordinator is thread-safe; each :class:`GroupConsumer` is owned by
one member thread (positions are member-local), so N members may poll the
same group concurrently — the serving engine's parallel replica polling
relies on exactly that.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Sequence

from repro_torch.analysis.witness import make_rlock
from repro_torch.core.cluster import ClusterError
from repro_torch.core.log import (
    OffsetOutOfRange,
    RecordBatch,
    StreamBackend,
    TopicPartition,
)

__all__ = ["ConsumerGroup", "GroupConsumer", "RebalanceError", "range_assign"]


class RebalanceError(RuntimeError):
    """The member was evicted from its group (missed heartbeats — another
    member now owns its partitions) or tried to act under a stale
    generation. Deliberately NOT a ``ClusterError``: cluster retry loops
    must not blindly re-poll as a zombie. Recover with
    :meth:`GroupConsumer.rejoin` and poll again — positions restart from
    the group's committed offsets (at-least-once)."""


def range_assign(
    members: Sequence[str], partitions: Sequence[TopicPartition]
) -> dict[str, list[TopicPartition]]:
    """Kafka's range assignor: sort both sides, give each member a
    contiguous slice; the first ``len(partitions) % len(members)`` members
    get one extra partition.

    Invariants (property-tested): every partition assigned exactly once;
    member loads differ by at most one; deterministic in its inputs.
    """
    out: dict[str, list[TopicPartition]] = {m: [] for m in members}
    if not members:
        return out
    ms = sorted(members)
    ps = sorted(partitions, key=lambda tp: (tp.topic, tp.partition))
    base, extra = divmod(len(ps), len(ms))
    start = 0
    for i, m in enumerate(ms):
        take = base + (1 if i < extra else 0)
        out[m] = ps[start : start + take]
        start += take
    return out


@dataclass
class _Member:
    member_id: str
    last_heartbeat: float


class ConsumerGroup:
    """Group coordinator for one consumer group over a :class:`StreamBackend`."""

    def __init__(
        self,
        log: StreamBackend,
        group_id: str,
        topics: Sequence[str],
        *,
        session_timeout_s: float = 10.0,
        clock: Callable[[], float] | None = None,
    ):
        self.log = log
        self.group_id = group_id
        self.topics = list(topics)
        self.session_timeout_s = session_timeout_s
        self._clock = clock or time.monotonic
        self._members: dict[str, _Member] = {}
        self._assignment: dict[str, list[TopicPartition]] = {}
        self.generation = 0
        self.rebalances = 0
        self._lock = make_rlock("group", name=f"group:{group_id}")

    # ------------------------------------------------------------ membership
    def _partitions(self) -> list[TopicPartition]:
        tps: list[TopicPartition] = []
        for t in self.topics:
            tps.extend(TopicPartition(t, p) for p in range(self.log.num_partitions(t)))
        return tps

    def join(
        self,
        member_id: str,
        *,
        on_revoked: Callable[[list[TopicPartition]], None] | None = None,
        on_assigned: Callable[[list[TopicPartition]], None] | None = None,
        isolation_level: str | None = None,
    ) -> "GroupConsumer":
        """Add a member; returns its :class:`GroupConsumer` view.

        ``on_revoked`` / ``on_assigned`` are rebalance listener hooks
        (Kafka's ConsumerRebalanceListener): when the member observes a
        generation change at its next poll, ``on_revoked`` fires with the
        partitions it lost *before* positions reset, ``on_assigned`` with
        the new assignment after.

        ``isolation_level="read_committed"`` makes the member's polls
        stop at each partition's last stable offset and skip control
        markers and aborted transactions' records — it never observes a
        transaction that has not committed.
        """
        with self._lock:
            self._members[member_id] = _Member(member_id, self._clock())
            self._rebalance()
            return GroupConsumer(
                self, member_id,
                on_revoked=on_revoked, on_assigned=on_assigned,
                isolation_level=isolation_level,
            )

    def rejoin(self, member_id: str) -> None:
        """Re-register an evicted member (recovery after
        :class:`RebalanceError`); triggers a rebalance like any join."""
        with self._lock:
            self._members[member_id] = _Member(member_id, self._clock())
            self._rebalance()

    def leave(self, member_id: str) -> None:
        with self._lock:
            if self._members.pop(member_id, None) is not None:
                self._rebalance()

    def heartbeat(self, member_id: str) -> None:
        with self._lock:
            m = self._members.get(member_id)
            if m is None:
                # typed, recoverable: the poll loop can rejoin() instead
                # of dying on a raw KeyError (the member was expired by
                # failure detection between two polls)
                raise RebalanceError(
                    f"{member_id} evicted from group {self.group_id}"
                )
            m.last_heartbeat = self._clock()

    def expire_dead_members(self) -> list[str]:
        """Failure detection: drop members whose heartbeat lapsed, rebalance.

        Returns the expired member ids. This is the fault-tolerance path the
        paper gets from Kafka: a crashed inference replica's partitions move
        to live replicas within a session timeout.
        """
        with self._lock:
            now = self._clock()
            dead = [
                m.member_id
                for m in self._members.values()
                if now - m.last_heartbeat > self.session_timeout_s
            ]
            for mid in dead:
                self._members.pop(mid)
            if dead:
                self._rebalance()
            return dead

    def _rebalance(self) -> None:
        self.generation += 1
        self.rebalances += 1
        self._assignment = range_assign(list(self._members), self._partitions())
        # backends without a registry (bare StreamLog default) skip this
        m = getattr(self.log, "metrics", None)
        if m is not None and m.enabled:
            m.counter("consumer_rebalances_total", group=self.group_id).inc()

    def assignment(self, member_id: str) -> list[TopicPartition]:
        with self._lock:
            return list(self._assignment.get(member_id, []))

    def assignment_with_generation(
        self, member_id: str
    ) -> tuple[int, list[TopicPartition]]:
        """Assignment plus the generation it belongs to, read atomically —
        the pair a member needs to fence its commits on."""
        with self._lock:
            return self.generation, list(self._assignment.get(member_id, []))

    @property
    def members(self) -> list[str]:
        with self._lock:
            return sorted(self._members)

    # ---------------------------------------------------------------- offsets
    def committed(self, tp: TopicPartition) -> int:
        off = self.log.committed_offset(self.group_id, tp)
        return off if off is not None else self.log.start_offset(tp.topic, tp.partition)

    def commit(self, tp: TopicPartition, offset: int) -> None:
        self.log.commit_offset(self.group_id, tp, offset)

    def commit_member(
        self,
        member_id: str,
        generation: int,
        positions: dict[TopicPartition, int],
    ) -> bool:
        """Generation-fenced offset commit (Kafka's OffsetCommit with
        ``generation_id`` validation). Publishes ``positions`` only when
        they were polled under the **current** generation by a member
        that is still in the group *and* still owns each partition —
        otherwise nothing commits and False returns. This is what stops a
        zombie (a member that kept stale positions across a rebalance)
        from rewinding the committed offset under the partition's new
        owner. Atomic with the membership/assignment check: the group
        lock is held across validation and the commits, so a rebalance
        cannot interleave between them."""
        with self._lock:
            if generation != self.generation or member_id not in self._members:
                return False
            assigned = set(self._assignment.get(member_id, ()))
            for tp, off in positions.items():
                if tp in assigned:
                    self.log.commit_offset(self.group_id, tp, off)
            return True


class GroupConsumer:
    """One member's view: poll assigned partitions from committed offsets.

    ``poll`` returns record batches and advances *local* positions;
    ``commit`` publishes them (at-least-once: a crash between poll and
    commit re-delivers). Commits are **generation-fenced**: positions
    only publish under the generation they were polled in, for partitions
    this member still owns — a zombie's stale commit is dropped (returns
    False) instead of rewinding the new owner's offset. An evicted member
    sees a typed :class:`RebalanceError` from ``poll`` and can
    :meth:`rejoin` instead of dying.
    """

    def __init__(
        self,
        group: ConsumerGroup,
        member_id: str,
        *,
        on_revoked: Callable[[list[TopicPartition]], None] | None = None,
        on_assigned: Callable[[list[TopicPartition]], None] | None = None,
        isolation_level: str | None = None,
    ):
        self.group = group
        self.member_id = member_id
        self.isolation_level = isolation_level
        self._positions: dict[TopicPartition, int] = {}
        self._assigned: list[TopicPartition] = []  # last observed assignment
        self._generation_seen = -1
        self._paused = False
        self._on_revoked = on_revoked
        self._on_assigned = on_assigned

    def _sync_assignment(self) -> list[TopicPartition]:
        # generation and assignment are read atomically: racing on the
        # two separately could pair a new assignment with a stale
        # generation and mis-fence the next commit
        gen, assignment = self.group.assignment_with_generation(self.member_id)
        if gen != self._generation_seen:
            if self._on_revoked is not None and self._generation_seen >= 0:
                # diff against the previously *observed assignment*, not
                # _positions: a partition whose committed offset never
                # resolved (mid-election skips) was still owned and must
                # still be reported revoked, or listeners doing
                # per-partition cleanup leak it
                revoked = sorted(
                    set(self._assigned) - set(assignment),
                    key=lambda tp: (tp.topic, tp.partition),
                )
                if revoked:
                    self._on_revoked(revoked)
            # after a rebalance, restart from the group's committed offsets
            self._positions = {}
            self._assigned = list(assignment)
            self._generation_seen = gen
            if self._on_assigned is not None:
                self._on_assigned(list(assignment))
        for tp in assignment:
            if tp not in self._positions:
                try:
                    self._positions[tp] = self.group.committed(tp)
                except ClusterError:
                    # committed offset / log start unreadable mid-election
                    # (leaderless partition, no controller quorum): skip
                    # this partition for the round and retry next poll,
                    # exactly like the read path below — one unavailable
                    # partition must not kill the member's poll loop
                    continue
        return assignment

    def pause(self) -> None:
        """Stop fetching without leaving the group: a paused member's
        ``poll`` still heartbeats and tracks assignment (so it is not
        expired or rebalanced away) but delivers no records and holds its
        positions — Kafka's ``pause()`` backpressure, used by serving
        workers whose request queue is at its high-water mark."""
        self._paused = True

    def resume(self) -> None:
        self._paused = False

    @property
    def paused(self) -> bool:
        return self._paused

    def poll(self, max_records: int = 1024) -> list[RecordBatch]:
        self.group.heartbeat(self.member_id)  # raises RebalanceError if evicted
        batches: list[RecordBatch] = []
        if self._paused:
            self._sync_assignment()  # keep generation/positions fresh
            return batches
        for tp in self._sync_assignment():
            pos = self._positions.get(tp)
            if pos is None:
                continue  # position still unresolved (mid-election skip)
            try:
                batch = self.group.log.read(
                    tp.topic, tp.partition, pos, max_records,
                    isolation=self.isolation_level,
                )
            except OffsetOutOfRange:
                try:
                    # evicted under us — jump to log start (auto.offset.reset)
                    pos = self.group.log.start_offset(tp.topic, tp.partition)
                    batch = self.group.log.read(
                        tp.topic, tp.partition, pos, max_records,
                        isolation=self.isolation_level,
                    )
                    # persist the recovered position even when the read
                    # comes back empty, or every later poll re-raises and
                    # re-recovers (and commit republishes the evicted
                    # offset) until new records arrive
                    self._positions[tp] = pos
                except ClusterError:
                    continue  # leader lost mid-recovery: retry next poll
            except ClusterError:
                # partition unavailable mid-election (offline, no serving
                # follower): skip it this round, keep the member alive
                continue
            if len(batch):
                self._positions[tp] = batch.next_offset
                batches.append(batch)
            elif (batch.scanned or 0) > 0:
                # a read_committed poll that scanned only control markers
                # (or aborted records) delivers nothing but must still
                # advance, or every later poll re-reads the same span
                self._positions[tp] = batch.next_offset
        return batches

    def commit(self) -> bool:
        """Publish polled positions, fenced on the generation they were
        polled under. Returns False — committing nothing — when a
        rebalance has moved on (stale generation or eviction): the new
        owner's committed offsets must not be rewound by a zombie."""
        return self.group.commit_member(
            self.member_id, self._generation_seen, dict(self._positions)
        )

    def lag(self) -> dict[TopicPartition, int]:
        """Per-partition LSO-aware lag for this member's assignment.

        Lag = bound - committed offset, clamped at 0, where the bound is
        min(HW, LSO) for a ``read_committed`` member (records parked
        behind an open transaction are not consumable, so they are not
        lag) and the high watermark otherwise. Uses the *group's
        committed* offsets, not local polled positions: lag is an
        external progress measure, and uncommitted positions would be
        lost on a crash anyway.
        """
        log = self.group.log
        out: dict[TopicPartition, int] = {}
        for tp in self.group.assignment(self.member_id):
            try:
                committed = self.group.committed(tp)
                if (self.isolation_level == "read_committed"
                        and hasattr(log, "last_stable_offset")):
                    bound = log.last_stable_offset(tp.topic, tp.partition)
                else:
                    bound = log.end_offset(tp.topic, tp.partition)
            except ClusterError:
                continue  # partition unavailable mid-election: omit
            out[tp] = max(0, bound - committed)
        m = getattr(log, "metrics", None)
        if m is not None and m.enabled:
            for tp, lag in out.items():
                m.gauge(
                    "consumer_lag", group=self.group.group_id,
                    topic=tp.topic, partition=str(tp.partition),
                ).set(lag)
        return out

    def positions(self) -> dict[TopicPartition, int]:
        """Snapshot of the member's polled positions — what a
        transactional publisher hands to ``send_offsets_to_txn`` so the
        offsets commit atomically with its produced records."""
        return dict(self._positions)

    @property
    def generation(self) -> int:
        """The group generation the current positions were polled under —
        what a transactional publisher checks against the group before
        committing offsets through a transaction (best-effort zombie
        fencing; the generation-atomic path is :meth:`commit`)."""
        return self._generation_seen

    def reset_positions(self) -> None:
        """Forget local positions; the next poll re-resolves them from
        the group's committed offsets (the recovery path after an aborted
        transaction: re-deliver everything the abort un-published)."""
        self._positions = {}

    def rejoin(self) -> None:
        """Recover from :class:`RebalanceError`: re-enter the group and
        restart from committed offsets at the next poll (at-least-once —
        records polled but not committed before eviction re-deliver)."""
        if self._on_revoked is not None and self._assigned:
            # eviction lost every owned partition (Kafka's
            # onPartitionsLost): report them so per-partition listener
            # cleanup runs before the fresh assignment arrives
            self._on_revoked(sorted(
                self._assigned, key=lambda tp: (tp.topic, tp.partition)
            ))
        self.group.rejoin(self.member_id)
        self._positions = {}
        self._assigned = []
        self._generation_seen = -1

    def close(self) -> None:
        self.commit()
        self.group.leave(self.member_id)
