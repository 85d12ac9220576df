"""Quorum controller — a Raft-style replicated control plane.

PR-1/PR-2 hung the whole cluster's fault-tolerance story off a single
in-process controller that could not itself fail: broker liveness,
partition leadership, ISR sets and leader epochs were mutated directly
under the metadata lock. This module replaces that with the KRaft-shaped
design the paper's availability claims actually need:

* **Replicated metadata log.** Controller state changes are *commands*
  (:class:`MetadataCommand`: ``RegisterBroker``, ``ElectLeader``,
  ``ShrinkIsr``, ``ExpandIsr``, ``CreateTopic``, ``DeleteTopic``,
  ``AllocatePid``, and the transaction-coordinator commands
  ``BeginTxn``/``AddPartitionsToTxn``/``AddOffsetsToTxn``/
  ``PrepareCommit``/``PrepareAbort``/``CompleteTxn``)
  appended to a log replicated across N controller nodes. Each node's
  log **is** a :class:`~repro.core.log.StreamLog` topic
  (``__cluster_metadata``) — the same segment substrate the data plane
  uses, reusing its append/point-read/``truncate_to`` machinery for
  Raft's log reconciliation.
* **Term-based elections.** A candidate bumps the term and requests
  votes; a voter grants only if the candidate's log is at least as
  up-to-date as its own (Raft's §5.4.1 election restriction, which is
  what guarantees committed commands survive controller failover). A
  candidate that cannot see a majority doesn't bump terms at all
  (pre-vote), so a partitioned minority node can neither elect itself
  nor disrupt the quorum's term sequence.
* **Majority commit.** A command is *committed* once it is on a majority
  of nodes; only committed commands are ever applied to cluster state.
  A new leader appends a no-op barrier entry in its own term — when that
  commits, every inherited entry commits with it (Raft's
  no-direct-commit-of-prior-term-entries rule). A command submitted to a
  leader that dies mid-commit is therefore either durably applied by the
  new leader (it reached a majority-electable node) or cleanly truncated
  (it lived only on the dead leader) — never half-applied.
* **Leader lease.** The leader holds a wall-clock lease renewed on every
  majority round (commit or heartbeat). A *partitioned* leader blocks
  elections until its lease expires (no dual-leader window); a *dead*
  leader is replaced immediately. A deposed leader's late writes are
  fenced twice over: it cannot reach a majority, and any node that
  observed a higher term rejects its entries outright.
* **Snapshots + install (DESIGN.md §11).** A long-lived quorum folds its
  applied committed prefix into a snapshot (``ControllerNode.snap_*``):
  superseded per-partition commands collapse to the newest one, barriers
  drop, and the node's metadata log physically restarts at the snapshot
  index (offsets stay Raft indexes). A follower missing the folded
  prefix — or conflicting below it — receives InstallSnapshot before
  normal AppendEntries resumes, so restarted controllers recover from
  snapshot + suffix replay instead of full history.

The controller is a pure consensus module: it never touches partition or
cluster-metadata locks. :class:`~repro.core.cluster.BrokerCluster`
submits commands (possibly while holding a partition lock — the lock
hierarchy is ``metadata lock → partition lock → controller lock``) and
applies each committed command itself; committed-but-unapplied backlog
(controller failover with the submitter gone) is drained by
``BrokerCluster.controller_tick``, which the replication daemon drives.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import asdict, dataclass
from typing import Callable, Iterator

from repro_torch.analysis.witness import make_rlock
from repro_torch.core.log import METADATA_TOPIC, LogConfig, StreamLog

__all__ = [
    "ClusterError",
    "ControllerNode",
    "ControllerUnavailable",
    "LogEntry",
    "MetadataCommand",
    "QuorumController",
]


class ClusterError(RuntimeError):
    """Base class for cluster-level failures. Defined here (the module
    both :mod:`repro.core.cluster` and this one can import) and
    re-exported by ``cluster``, so client retry loops written against
    ``except ClusterError`` also cover controller-quorum conditions."""


class ControllerUnavailable(ClusterError):
    """No controller leader can commit: quorum lost, lease held by an
    unreachable leader, or the submitting node was fenced/deposed. The
    submitted command is NOT committed (it may sit uncommitted on a
    minority of nodes, where log reconciliation will truncate it)."""


@dataclass(frozen=True)
class MetadataCommand:
    """One replicated control-plane command (the metadata-log record).

    ``kind`` selects the state transition; the remaining fields are its
    payload (unused ones stay None). ``pversion`` is the per-partition
    metadata version the command produces — application is guarded by
    ``pversion > ctl.version``, which makes replay after controller
    failover idempotent and makes lost (uncommitted) commands harmless:
    their version number is simply reissued by the next command.
    """

    kind: str  # register_broker | elect_leader | shrink_isr | expand_isr
    #          | create_topic | delete_topic | allocate_pid | noop
    #          | begin_txn | add_partitions_to_txn | add_offsets_to_txn
    #          | prepare_commit | prepare_abort | complete_txn
    topic: str | None = None
    partition: int | None = None
    broker_id: int | None = None
    up: bool | None = None
    leader: int | None = None
    epoch: int | None = None
    isr: tuple[int, ...] | None = None
    pversion: int | None = None
    cfg: dict | None = None  # create_topic: LogConfig fields
    gen: int | None = None  # topic generation (fences delete-vs-recreate)
    note: str | None = None  # free-form tag (tests mark entries with it)
    # allocate_pid: producer-id grants are metadata commands, so ids stay
    # unique across controller failovers (the grant is in the replicated
    # log a successor inherits) and a named re-initialization's epoch bump
    # (zombie fencing) is durable
    pid: int | None = None
    producer_epoch: int | None = None
    name: str | None = None
    # transaction-coordinator commands (DESIGN.md §8): the coordinator's
    # whole state machine — ongoing partition set, consumer offsets to
    # commit with the transaction, and the prepare/complete decisions —
    # lives in these replicated commands, so a controller successor
    # reconstructs every in-flight transaction from the metadata log
    partitions: tuple[tuple[str, int], ...] | None = None
    group: str | None = None  # add_offsets_to_txn: consumer group id
    offsets: dict | None = None  # "topic:partition" -> offset
    committed: bool | None = None  # complete_txn outcome
    # per-pid txn command sequence: application is guarded by
    # ``txn_seq > state.seq`` (the transactional pversion), making
    # failover replay idempotent
    txn_seq: int | None = None

    def to_bytes(self, term: int) -> bytes:
        body = {k: v for k, v in asdict(self).items() if v is not None}
        if self.isr is not None:
            body["isr"] = list(self.isr)
        if self.partitions is not None:
            body["partitions"] = [list(p) for p in self.partitions]
        return json.dumps({"term": term, "cmd": body}, sort_keys=True).encode()

    @staticmethod
    def from_bytes(payload: bytes) -> tuple[int, "MetadataCommand"]:
        obj = json.loads(bytes(payload).decode())
        body = obj["cmd"]
        if "isr" in body:
            body["isr"] = tuple(body["isr"])
        if "partitions" in body:
            body["partitions"] = tuple(
                (t, int(p)) for t, p in body["partitions"]
            )
        return obj["term"], MetadataCommand(**body)


def _is_barrier(cmd: MetadataCommand) -> bool:
    """A new leader's untagged no-op barrier entry (pure consensus
    bookkeeping — never surfaced to the state machine or log readers)."""
    return cmd.kind == "noop" and cmd.note is None


# Auto-snapshot thresholds: fold once the applied committed prefix
# exceeds _SNAPSHOT_ENTRIES live entries, keeping the newest
# _SNAPSHOT_RETAIN committed entries un-folded (recent history stays
# individually addressable for reconciliation and debugging).
_SNAPSHOT_ENTRIES = 1024
_SNAPSHOT_RETAIN = 256


def _fold_commands(cmds: list[MetadataCommand]) -> list[MetadataCommand]:
    """Collapse a committed command prefix to its net effect, order
    preserved. Deliberately conservative: only commands whose application
    is last-writer-wins are folded — ``register_broker`` (latest per
    broker) and the ``pversion``-guarded partition commands
    ``elect_leader``/``shrink_isr``/``expand_isr`` (latest per kind and
    partition, so a trailing ISR change never erases the leader/epoch the
    preceding election carries). Everything else — topic lifecycle,
    ``allocate_pid`` (an epoch-bump grant carries no ``name``; folding
    would lose the name→pid binding), the transaction-coordinator
    commands, tagged no-ops — replays verbatim. Barriers drop."""
    last: dict[tuple, int] = {}
    for i, c in enumerate(cmds):
        if c.kind == "register_broker":
            last[("register_broker", c.broker_id)] = i
        elif c.kind in ("elect_leader", "shrink_isr", "expand_isr"):
            last[(c.kind, c.topic, c.partition)] = i
    out = []
    for i, c in enumerate(cmds):
        if _is_barrier(c):
            continue
        if c.kind == "register_broker":
            if last[("register_broker", c.broker_id)] != i:
                continue
        elif c.kind in ("elect_leader", "shrink_isr", "expand_isr"):
            if last[(c.kind, c.topic, c.partition)] != i:
                continue
        out.append(c)
    return out


@dataclass(frozen=True)
class LogEntry:
    """One committed metadata-log entry as handed to the state machine."""

    term: int
    index: int
    command: MetadataCommand


class ControllerNode:
    """One controller node: durable term/vote plus its metadata log.

    The log is a real :class:`StreamLog` topic — offsets are Raft log
    indexes, ``truncate_to`` is Raft's conflict-suffix truncation, and a
    killed node that restarts keeps its durable state (log, term, vote),
    exactly the persistence Raft assumes.

    Snapshot state (DESIGN.md §11): entries below ``snap_index`` have
    been folded into ``snap_commands`` (their net effect, order
    preserved); ``snap_term`` is the term of the boundary entry
    ``snap_index - 1``, which is all AppendEntries consistency checks
    need about the folded prefix (Raft's Log Matching Property: a
    matching boundary entry implies the whole prefix matched).
    ``_terms`` covers only the live suffix ``[snap_index, end())``.

    ``alive`` models a crashed controller process; ``reachable`` models a
    network partition. Either way the node is invisible to its peers.
    """

    __slots__ = ("node_id", "term", "voted_for", "won_term", "log", "_terms",
                 "commit_count", "alive", "reachable",
                 "snap_index", "snap_term", "snap_commands")

    def __init__(self, node_id: int, clock: Callable[[], float] | None = None):
        self.node_id = node_id
        self.term = 0
        self.voted_for: int | None = None
        # highest term this node won an election for: a node may only act
        # as leader (append + replicate outward) in a term it won — a
        # restarted follower sharing the leader's term must never push its
        # divergent same-term log at peers (it could truncate committed
        # entries, since conflict detection is by term)
        self.won_term = -1
        # appended to while the controller lock is held → distinct lock
        # class nested strictly inside "controller" (repro.analysis.ranks)
        self.log = StreamLog(clock=clock, lock_class="ctl-log")
        self.log.create_topic(METADATA_TOPIC, LogConfig(num_partitions=1))
        self._terms: list[int] = []  # term of live entry i - snap_index
        self.commit_count = 0  # entries [0, commit_count) are committed
        self.snap_index = 0  # entries below this are folded into the snapshot
        self.snap_term = 0  # term of entry snap_index - 1
        self.snap_commands: list[MetadataCommand] = []
        self.alive = True
        self.reachable = True

    @property
    def up(self) -> bool:
        return self.alive and self.reachable

    def end(self) -> int:
        return self.snap_index + len(self._terms)

    def last_term(self) -> int:
        return self._terms[-1] if self._terms else self.snap_term

    def term_at(self, index: int) -> int:
        """Term of entry ``index`` — the boundary entry just below the
        snapshot answers from ``snap_term``; anything deeper is folded
        away (and never needed: folded entries are committed, and
        committed prefixes agree by Leader Completeness)."""
        if index == self.snap_index - 1:
            return self.snap_term
        return self._terms[index - self.snap_index]

    def append(self, term: int, cmd: MetadataCommand) -> int:
        """Append one entry; returns its index (== StreamLog offset)."""
        _p, offset = self.log.produce(METADATA_TOPIC, cmd.to_bytes(term))
        assert offset == self.end()
        self._terms.append(term)
        return offset

    def entry(self, index: int) -> LogEntry:
        if index < self.snap_index:
            raise LookupError(
                f"entry {index} folded into snapshot @ {self.snap_index}"
            )
        rec = self.log.read_one(METADATA_TOPIC, 0, index)
        term, cmd = MetadataCommand.from_bytes(rec.value)
        return LogEntry(term=term, index=index, command=cmd)

    def entries(
        self, start: int | None = None, stop: int | None = None
    ) -> Iterator[LogEntry]:
        """Live (non-folded) entries in ``[start, stop)``; ``start``
        defaults to the snapshot boundary."""
        start = self.snap_index if start is None else start
        stop = self.end() if stop is None else stop
        for i in range(max(start, self.snap_index), stop):
            yield self.entry(i)

    def truncate(self, index: int) -> None:
        """Drop entries at ``index`` and beyond (conflict reconciliation).
        Never reaches into the snapshot: folded entries are committed,
        and Raft never truncates committed entries."""
        assert index >= self.snap_index
        self.log.truncate_to(METADATA_TOPIC, 0, index)
        del self._terms[index - self.snap_index:]
        self.commit_count = min(self.commit_count, index)

    def install_snapshot(
        self, index: int, term: int, commands: list[MetadataCommand]
    ) -> None:
        """Replace this node's log wholesale with a leader's snapshot
        (Raft InstallSnapshot): the local log restarts empty at ``index``
        — StreamLog offsets stay Raft indexes — and AppendEntries copies
        the live suffix afterwards."""
        self.snap_index = index
        self.snap_term = term
        self.snap_commands = list(commands)
        self.log.reset_to(METADATA_TOPIC, 0, index)
        self._terms = []
        self.commit_count = index  # a snapshot only ever covers committed

    def compact_to_snapshot(
        self, upto: int, folded: list[MetadataCommand]
    ) -> None:
        """Fold this node's own prefix ``[snap_index, upto)`` into the
        snapshot and physically drop it from the log: the live suffix is
        re-appended into a log restarted at ``upto``, so offsets still
        equal Raft indexes. Caller provides the folded commands and
        guarantees the prefix is committed and applied."""
        boundary = self.term_at(upto - 1)
        windows = []  # fetch is capped per segment: gather the suffix
        pos, end = upto, self.end()
        while pos < end:
            vals, keys, ts, prods, offs, nxt, _ = self.log.replica_fetch(
                METADATA_TOPIC, 0, pos, end - pos
            )
            if nxt <= pos:
                break
            if vals:
                windows.append((vals, keys, ts, prods, offs))
            pos = nxt
        self.log.reset_to(METADATA_TOPIC, 0, upto)
        for vals, keys, ts, prods, offs in windows:
            self.log.replica_append(
                METADATA_TOPIC, 0, vals, keys, ts, prods=prods, offsets=offs
            )
        self._terms = self._terms[upto - self.snap_index:]
        self.snap_commands = folded
        self.snap_term = boundary
        self.snap_index = upto


class QuorumController:
    """N-node Raft-style quorum over the cluster metadata log.

    All public methods are safe to call from data-plane threads: the
    single internal lock is a leaf in the cluster lock hierarchy
    (``metadata lock → partition lock → controller lock``) — no method
    ever calls back into cluster or partition state.

    This is an in-process model of the consensus protocol, not a wire
    implementation: RPCs are direct method calls gated by a visibility
    rule (two nodes exchange messages iff both are alive and both are
    reachable), which is exactly the level the chaos suite needs to
    prove split-brain safety and failover liveness.
    """

    def __init__(
        self,
        num_nodes: int = 3,
        *,
        lease_s: float = 1.0,
        clock: Callable[[], float] | None = None,
    ):
        if num_nodes < 1:
            raise ValueError("need at least one controller node")
        self._clock = clock or time.time
        self.lease_s = lease_s
        self.nodes: dict[int, ControllerNode] = {
            i: ControllerNode(i, clock=self._clock) for i in range(num_nodes)
        }
        self._majority = num_nodes // 2 + 1
        self.leader_id: int | None = None
        self._lease_until = 0.0
        self.elections = 0  # completed leadership changes (observability)
        self.term_changes = 0  # election rounds that bumped the term
        self.quorum_rpcs = 0  # AppendEntries-shaped node-to-node calls
        self.snapshots_taken = 0  # leader-side log folds
        self.snapshot_installs = 0  # InstallSnapshot pushes to followers
        # last-observed leader for read-only metadata queries: unlike
        # ``leader_id`` (reset to None on fencing/deposal) this sticks
        # around, so reads keep routing to one node instead of probing
        # all N — falling back to a full probe only when the observed
        # leader can no longer serve. The counters prove the reduction.
        self._observed_leader: int | None = None
        self.observed_reads = 0  # reads served by the observed leader alone
        self.probe_reads = 0  # reads that fell back to probing every node
        self._applied: set[int] = set()  # entry indexes handed to the SM
        self._lock = make_rlock("controller")
        # test hook: crash the leader mid-commit ("append": before any
        # replication; "replicate": after reaching exactly one follower)
        self.crash_leader_after: str | None = None

    # ------------------------------------------------------------- topology
    @staticmethod
    def _visible(a: ControllerNode, b: ControllerNode) -> bool:
        if a is b:
            return a.alive
        return a.alive and b.alive and a.reachable and b.reachable

    def leader(self) -> int | None:
        with self._lock:
            return self.leader_id

    def term(self) -> int:
        """Current controller term — an observed-leader read: served from
        the last-observed leader's state alone when that node is still the
        serving leader (one node touched), probing every node only when it
        is not. A serving leader's term is the quorum's term (any higher
        term would have fenced it), so the routed answer is never stale."""
        with self._lock:
            obs = self._observed_node_locked()
            if obs is not None:
                self.observed_reads += 1
                return obs.term
            self.probe_reads += 1
            return max(n.term for n in self.nodes.values())

    def _observed_node_locked(self) -> ControllerNode | None:
        """The last-observed leader, iff it can still serve reads (up and
        the elected leader for its own term)."""
        if self._observed_leader is None:
            return None
        obs = self.nodes.get(self._observed_leader)
        if obs is not None and obs.up and obs.won_term == obs.term:
            return obs
        return None

    def apply_lag(self) -> int:
        """Committed-but-unapplied metadata entries (state-machine backlog
        a ``controller_tick`` still has to drain)."""
        with self._lock:
            ldr = (
                self.nodes.get(self.leader_id)
                if self.leader_id is not None
                else None
            )
            if ldr is None or not ldr.up:
                return 0
            return sum(
                1
                for i in range(ldr.snap_index, ldr.commit_count)
                if i not in self._applied
            )

    def describe(self) -> dict:
        with self._lock:
            return {
                "leader": self.leader_id,
                "elections": self.elections,
                "term_changes": self.term_changes,
                "quorum_rpcs": self.quorum_rpcs,
                "observed_reads": self.observed_reads,
                "probe_reads": self.probe_reads,
                "snapshots_taken": self.snapshots_taken,
                "snapshot_installs": self.snapshot_installs,
                "lease_until": self._lease_until,
                "nodes": {
                    n.node_id: {
                        "term": n.term,
                        "end": n.end(),
                        "commit": n.commit_count,
                        "snap_index": n.snap_index,
                        "alive": n.alive,
                        "reachable": n.reachable,
                    }
                    for n in self.nodes.values()
                },
            }

    # ---------------------------------------------------------- chaos hooks
    def kill_node(self, node_id: int) -> None:
        """Crash a controller node (durable state survives for restart)."""
        with self._lock:
            self.nodes[node_id].alive = False

    def restart_node(self, node_id: int) -> None:
        with self._lock:
            self.nodes[node_id].alive = True

    def partition_node(self, node_id: int) -> None:
        """Isolate a node from every peer (it may still act locally)."""
        with self._lock:
            self.nodes[node_id].reachable = False

    def heal_node(self, node_id: int) -> None:
        with self._lock:
            self.nodes[node_id].reachable = True

    # ------------------------------------------------------------ elections
    def _try_elect_locked(self, candidate_id: int | None = None) -> bool:
        """One election round. Without an explicit candidate, up nodes run
        in most-up-to-date-log-first order (then lowest id — deterministic),
        so the first eligible candidate wins whenever a majority is up."""
        if candidate_id is not None:
            cands = [self.nodes[candidate_id]]
        else:
            cands = sorted(
                (n for n in self.nodes.values() if n.up),
                key=lambda n: (-n.last_term(), -n.end(), n.node_id),
            )
        for cand in cands:
            if not cand.alive:
                continue
            visible = [n for n in self.nodes.values() if self._visible(cand, n)]
            if len(visible) < self._majority:
                continue  # pre-vote: cannot win, don't disturb terms
            term = max(n.term for n in visible) + 1
            self.term_changes += 1
            votes = 0
            for n in visible:
                # grant iff the candidate's log is at least as up-to-date
                # (Raft §5.4.1) — the voter's term advances either way
                grant = (cand.last_term(), cand.end()) >= (n.last_term(), n.end())
                n.term = term
                n.voted_for = cand.node_id if grant else None
                votes += 1 if grant else 0
            if votes < self._majority:
                continue
            self.leader_id = cand.node_id
            self._observed_leader = cand.node_id
            cand.won_term = term
            self.elections += 1
            self._lease_until = self._clock() + self.lease_s
            # no-op barrier in the new term: when it commits, every entry
            # inherited from prior terms commits with it
            cand.append(term, MetadataCommand(kind="noop"))
            self._heartbeat_locked(cand)
            return True
        if candidate_id is None:
            self.leader_id = None
        return False

    def try_elect(self, candidate_id: int) -> bool:
        """Run an election round with an explicit candidate (chaos tests:
        a partitioned minority node must fail here)."""
        with self._lock:
            return self._try_elect_locked(candidate_id)

    def _ensure_leader_locked(self) -> ControllerNode:
        ldr = self.nodes.get(self.leader_id) if self.leader_id is not None else None
        if ldr is not None and ldr.up and ldr.won_term == ldr.term:
            return ldr
        if (
            ldr is not None
            and ldr.alive
            and not ldr.reachable
            and self._clock() < self._lease_until
        ):
            # a partitioned (not crashed) leader may still be serving its
            # own minority view: its lease must expire before a new leader
            # can be chosen (no dual-leader window)
            raise ControllerUnavailable(
                f"controller {ldr.node_id} unreachable; lease not expired"
            )
        self._try_elect_locked()
        if self.leader_id is None:
            raise ControllerUnavailable("no controller quorum")
        return self.nodes[self.leader_id]

    def ensure_leader(self) -> int:
        """Elect (if needed) and return the current leader node id."""
        with self._lock:
            return self._ensure_leader_locked().node_id

    # ---------------------------------------------------------- replication
    def _replicate_to_locked(self, ldr: ControllerNode, f: ControllerNode) -> bool:
        """Bring follower ``f`` up to ``ldr``'s log (AppendEntries):
        truncate the conflicting suffix, copy missing entries, propagate
        the commit index. Returns False when unreachable or fenced."""
        self.quorum_rpcs += 1
        if not self._visible(ldr, f):
            return False
        if f.term > ldr.term:
            return False  # higher term: the caller must step down
        f.term = ldr.term
        if ldr.snap_index > f.snap_index and (
            f.end() < ldr.snap_index
            or f.term_at(ldr.snap_index - 1) != ldr.snap_term
        ):
            # the follower is missing — or conflicts inside — the prefix
            # the leader folded away: InstallSnapshot, then AppendEntries
            # resumes for the live suffix
            self.snapshot_installs += 1
            f.install_snapshot(
                ldr.snap_index, ldr.snap_term, ldr.snap_commands
            )
        # longest common prefix by entry term (logs are small — the
        # in-memory term index makes this a list comparison). Entries
        # below both snapshot boundaries are committed on both sides and
        # agree by Leader Completeness; the comparison starts above them.
        lo = max(ldr.snap_index, f.snap_index)
        n = min(f.end(), ldr.end())
        common = n
        for i in range(lo, n):
            if f.term_at(i) != ldr.term_at(i):
                common = i
                break
        if f.end() > common:
            f.truncate(common)
        if common < ldr.end():
            pos, end = common, ldr.end()
            while pos < end:  # fetch is capped per segment: loop
                values, keys, timestamps, prods, offs, nxt, sbase = (
                    ldr.log.replica_fetch(METADATA_TOPIC, 0, pos, end - pos)
                )
                if nxt <= pos:
                    break
                if values:
                    f.log.replica_append(
                        METADATA_TOPIC, 0, values, keys, timestamps,
                        prods=prods, offsets=offs, seg_base=sbase,
                    )
                pos = nxt
            f._terms.extend(ldr._terms[common - ldr.snap_index:])
        # never below the snapshot boundary (a snapshot covers committed
        # entries only — a new leader whose commit index lags behind an
        # old quorum's snapshot catches up at its first barrier commit)
        f.commit_count = max(f.snap_index, min(ldr.commit_count, f.end()))
        return True

    def _heartbeat_locked(self, ldr: ControllerNode) -> bool:
        """One majority round from ``ldr``: replicate the log, advance the
        commit index, renew the lease. Returns True on majority ack."""
        acks = 1
        for n in self.nodes.values():
            if n is ldr:
                continue
            if self._visible(ldr, n) and n.term > ldr.term:
                # fenced: a higher-term leader exists somewhere
                ldr.term = n.term
                if self.leader_id == ldr.node_id:
                    self.leader_id = None
                return False
            if self._replicate_to_locked(ldr, n):
                acks += 1
        if acks < self._majority:
            return False
        if ldr._terms and ldr._terms[-1] == ldr.term:
            # every entry is on a majority, and the tail is own-term: the
            # whole log commits (the no-op barrier guarantees this holds
            # from the first round of any new term)
            ldr.commit_count = ldr.end()
        if self.leader_id == ldr.node_id:
            self._lease_until = max(
                self._lease_until, self._clock() + self.lease_s
            )
        return True

    def tick(self) -> bool:
        """One controller heartbeat: renew the lease, catch followers up,
        and run an election when the leader is dead (immediately) or
        unreachable (after lease expiry). Returns True when leadership
        changed — the cluster then completes pending partition elections.
        Driven by :class:`~repro.core.cluster.ReplicationService`."""
        with self._lock:
            ldr = (
                self.nodes.get(self.leader_id)
                if self.leader_id is not None
                else None
            )
            if ldr is not None and ldr.up and ldr.won_term == ldr.term:
                self._heartbeat_locked(ldr)
                if self.leader_id == ldr.node_id:
                    # steady-state housekeeping: fold a long applied
                    # prefix so restarts replay a snapshot + short
                    # suffix, not the full history
                    if ldr.commit_count - ldr.snap_index > _SNAPSHOT_ENTRIES:
                        self._snapshot_locked(ldr, _SNAPSHOT_RETAIN)
                    return False
                # fenced mid-heartbeat: fall through to re-elect
            elif (
                ldr is not None
                and ldr.alive
                and not ldr.reachable
                and self._clock() < self._lease_until
            ):
                return False  # partitioned leader still holds its lease
            old = self.leader_id
            self._try_elect_locked()
            return self.leader_id is not None and self.leader_id != old

    # --------------------------------------------------------------- submit
    def submit(self, cmd: MetadataCommand) -> LogEntry:
        """Append ``cmd`` to the current leader's log and replicate it to
        a majority. Returns the committed entry; the caller applies it to
        cluster state. Raises :class:`ControllerUnavailable` when no
        leader can be established or the command cannot reach a majority
        — in that case the command is NOT committed and must not be
        applied."""
        with self._lock:
            ldr = self._ensure_leader_locked()
            return self._submit_from_locked(ldr, cmd)

    def submit_from(self, node_id: int, cmd: MetadataCommand) -> LogEntry:
        """Submit acting as a specific node (chaos tests: a deposed leader
        attempting a late write must be fenced)."""
        with self._lock:
            node = self.nodes[node_id]
            if not node.alive:
                raise ControllerUnavailable(f"controller {node_id} is dead")
            return self._submit_from_locked(node, cmd)

    def _submit_from_locked(
        self, ldr: ControllerNode, cmd: MetadataCommand
    ) -> LogEntry:
        if ldr.won_term != ldr.term:
            # not the elected leader for its current term (e.g. a restarted
            # follower that missed same-term commits): letting it replicate
            # outward could truncate committed entries on its peers
            raise ControllerUnavailable(
                f"controller {ldr.node_id} is not the leader for term "
                f"{ldr.term}"
            )
        term = ldr.term
        index = ldr.append(term, cmd)
        if self.crash_leader_after == "append":
            # die before any replication: the entry lives only on this
            # node and will be truncated by the next leader's heartbeat
            self.crash_leader_after = None
            ldr.alive = False
            raise ControllerUnavailable(
                f"controller {ldr.node_id} crashed before replicating"
            )
        acks = 1
        for n in self.nodes.values():
            if n is ldr:
                continue
            if self._visible(ldr, n) and n.term > ldr.term:
                # fenced: step down, refuse the write
                ldr.term = n.term
                if self.leader_id == ldr.node_id:
                    self.leader_id = None
                raise ControllerUnavailable(
                    f"controller {ldr.node_id} deposed (term {n.term} observed)"
                )
            if self._replicate_to_locked(ldr, n):
                acks += 1
                if self.crash_leader_after == "replicate":
                    # die after reaching one follower but before commit:
                    # the entry is on a majority-electable node, so the
                    # next leader inherits and commits it
                    self.crash_leader_after = None
                    ldr.alive = False
                    raise ControllerUnavailable(
                        f"controller {ldr.node_id} crashed mid-commit"
                    )
        if acks < self._majority:
            raise ControllerUnavailable(
                f"metadata command reached {acks}/{len(self.nodes)} nodes; "
                f"majority is {self._majority}"
            )
        ldr.commit_count = ldr.end()
        if self.leader_id == ldr.node_id:
            self._lease_until = max(
                self._lease_until, self._clock() + self.lease_s
            )
        self._applied.add(index)  # the submitting caller applies it now
        return LogEntry(term=term, index=index, command=cmd)

    # -------------------------------------------------------- state machine
    def take_unapplied(self) -> list[LogEntry]:
        """Committed entries not yet handed to the state machine, in log
        order (controller-failover backlog: committed by a dead leader,
        or inherited and committed via the no-op barrier). Entries are
        marked as handed out; application itself is idempotent
        (``pversion`` guards), so a duplicate hand-out would be harmless."""
        with self._lock:
            ldr = (
                self.nodes.get(self.leader_id)
                if self.leader_id is not None
                else None
            )
            if ldr is None or not ldr.up:
                return []
            out = []
            # folded entries (below snap_index) are applied by the
            # snapshot-creation precondition — only the live tail can
            # hold backlog
            for i in range(ldr.snap_index, ldr.commit_count):
                if i in self._applied:
                    continue
                entry = ldr.entry(i)
                self._applied.add(i)
                if not _is_barrier(entry.command):
                    out.append(entry)
            return out

    def committed_commands(self) -> list[MetadataCommand]:
        """The committed metadata log (minus no-ops), from the leader:
        the snapshot's folded commands followed by the live committed
        suffix — the replay a fresh state machine consumes."""
        with self._lock:
            ldr = (
                self.nodes.get(self.leader_id)
                if self.leader_id is not None
                else None
            )
            if ldr is None:
                return []
            out = [c for c in ldr.snap_commands if not _is_barrier(c)]
            out.extend(
                e.command
                for e in ldr.entries(ldr.snap_index, ldr.commit_count)
                if not _is_barrier(e.command)
            )
            return out

    # ------------------------------------------------------------- snapshots
    def snapshot(self, retain: int = _SNAPSHOT_RETAIN) -> bool:
        """Fold the leader's applied committed prefix into a snapshot,
        keeping the newest ``retain`` committed entries live. Returns
        True when a fold happened. Followers receive the snapshot via
        InstallSnapshot on their next AppendEntries only if they diverge
        below the boundary; an up-to-date follower just keeps its own
        (longer) log until it snapshots too."""
        with self._lock:
            ldr = (
                self.nodes.get(self.leader_id)
                if self.leader_id is not None
                else None
            )
            if ldr is None or not ldr.up or ldr.won_term != ldr.term:
                return False
            return self._snapshot_locked(ldr, retain)

    def _snapshot_locked(self, ldr: ControllerNode, retain: int) -> bool:
        limit = ldr.commit_count - retain
        # fold only entries the state machine has consumed: a snapshot
        # claims its prefix is applied, so stop at the first un-applied
        upto = ldr.snap_index
        while upto < limit and upto in self._applied:
            upto += 1
        if upto <= ldr.snap_index:
            return False
        folded = _fold_commands(
            ldr.snap_commands
            + [e.command for e in ldr.entries(ldr.snap_index, upto)]
        )
        ldr.compact_to_snapshot(upto, folded)
        self.snapshots_taken += 1
        return True
