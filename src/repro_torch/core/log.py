"""Distributed log — the Kafka-ML data substrate, JAX-host-native.

Implements the semantics Kafka-ML relies on (paper §II, §V):

* topics split into **partitions**; each partition is an append-only log of
  records addressed by a monotonically increasing **offset**;
* records are retained after consumption (the *distributed log*), so
  consumers can re-read ranges — this is what lets Kafka-ML replay a
  training stream to a new deployment with a tens-of-bytes control message
  instead of re-sending the data;
* **retention policies**: ``delete`` with ``retention_bytes`` /
  ``retention_ms`` (paper §V lists exactly these two knobs) and, since
  storage engine v2 (DESIGN.md §11), ``compact`` for keyed topics — a
  cleaner rewrites sealed segments keeping the latest record per key
  (tombstones are empty-valued keyed records, removed after a grace
  window), while surviving records keep their original offsets;
* **per-segment sparse indexes**: offset/timestamp index entries every
  ``index_interval_bytes`` (``offset_for_timestamp`` lookups) and an
  aborted-transaction index (Kafka's ``.txnindex``) so read_committed's
  abort prefilter touches only the segments a read actually spans;
* **state snapshots**: each partition snapshots its producer/transaction
  state at segment rolls and compaction horizons, so post-truncation
  rebuilds restore the newest snapshot at or below the truncation point
  and replay only the suffix — byte-identical to a full replay, and the
  only correct rebuild on a compacted log (cleaned records no longer
  replay);
* message-set (batched) appends amortize per-record overhead — the paper's
  "message set abstraction";
* zero-copy reads: records are returned as memoryviews into segment
  buffers ("zero-copy optimizations" in paper §II);
* **idempotent producers** (exactly-once across client retries): each
  partition keeps a producer-state table (pid → epoch, last sequence,
  recent batch runs) derived from (pid, epoch, seq) stamps embedded in
  the records themselves, so ``producer_append`` resolves a retried
  batch to its *original* offsets instead of re-appending, the table
  replicates with the records, and it is rebuilt from the retained log
  after truncation (see DESIGN.md §7);
* **transactions** (DESIGN.md §8): transactional records carry a txn
  flag next to their producer stamp, and COMMIT/ABORT **control
  records** (markers) written by the transaction coordinator resolve
  them. Each partition tracks its open transactions (pid → first
  offset) and its aborted ranges — both, like producer state, derived
  purely from the records in the log, so replicas and post-truncation
  rebuilds agree. ``last_stable_offset`` (LSO) is the first offset of
  the earliest still-open transaction; ``read(...,
  isolation="read_committed")`` caps at the LSO and filters out
  markers and aborted records.

The log is an in-process, host-memory structure (segments are bytearrays)
with optional disk spill. On a TPU pod the broker is colocated with the
host, so a network hop becomes a RAM hop; every *semantic* (offsets,
retention, replay, consumer groups) is preserved — see DESIGN.md §2.
"""

from __future__ import annotations

import bisect
import itertools
import os
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Callable, Iterator, Protocol, Sequence

import numpy as np

from repro_torch.analysis.witness import make_rlock

__all__ = [
    "METADATA_TOPIC",
    "LogConfig",
    "OffsetOutOfRange",
    "OutOfOrderSequence",
    "ProducerFenced",
    "Record",
    "RecordBatch",
    "StreamBackend",
    "StreamLog",
    "TopicPartition",
]

# The cluster-metadata topic (KRaft's ``@metadata``): each controller
# node's replicated metadata log is an ordinary StreamLog topic of this
# name — offsets are Raft log indexes and ``truncate_to`` is Raft's
# conflict-suffix truncation. See repro.core.controller.
METADATA_TOPIC = "__cluster_metadata"


class OffsetOutOfRange(LookupError):
    """Requested offset is below the log start (evicted) or past the end."""


class ProducerFenced(RuntimeError):
    """An idempotent append carried a producer epoch older than the one the
    partition (or cluster) has seen — a *zombie*: a prior incarnation of a
    producer whose id was re-initialized with a bumped epoch. Fatal to the
    producer instance (Kafka's PRODUCER_FENCED); deliberately NOT a
    ``ClusterError`` subclass, so client retry loops never re-send a fenced
    batch."""


class OutOfOrderSequence(RuntimeError):
    """An idempotent append's sequence number is neither the next expected
    one, a retry resolvable inside the dedup window, nor a fresh epoch —
    either a gap (records lost between producer and broker) or a duplicate
    too old for the bounded window (Kafka's OUT_OF_ORDER_SEQUENCE_NUMBER /
    DUPLICATE_SEQUENCE_NUMBER). Fatal: acking it could hide loss or
    re-append data."""


# Per-producer dedup window: how many distinct (non-mergeable) batch runs
# each partition remembers per producer id. A synchronous producer has one
# batch in flight, so its retry always hits the newest run; 8 leaves slack
# for pipelined producers (Kafka keeps 5 batch metadata entries).
_MAX_PRODUCER_RUNS = 8

# Producer-state snapshots retained per partition (beyond the pinned
# snapshot at the compaction point, which is load-bearing and never
# evicted — see _Partition._trim_snapshots).
_MAX_PRODUCER_SNAPSHOTS = 8

# Per-record control/transaction flag values (the ``ctrls`` arrays):
# 0 = plain record, 1 = transactional data record, 2 = COMMIT marker,
# 3 = ABORT marker. Markers are control records: they occupy offsets and
# replicate like data, but consumers never see them.
CTRL_NONE = 0
CTRL_TXN_DATA = 1
CTRL_COMMIT = 2
CTRL_ABORT = 3

# marker payloads (self-describing; never delivered to consumers)
_COMMIT_MARKER = b"\x00txn:commit"
_ABORT_MARKER = b"\x00txn:abort"


class _ProducerState:
    """Dedup state for one producer id on one partition.

    ``runs`` is a bounded list of ``[first_seq, last_seq, first_offset]``
    spans that are contiguous in *both* sequence and offset, so a retried
    batch fully inside a run maps back to its original offsets by
    arithmetic (``first_offset + (seq - first_seq)``). Because runs are
    derived purely from the records in the log (in log order), a leader
    and its followers — and a truncated log after a rebuild — always agree
    on the same table without shipping snapshots.
    """

    __slots__ = ("epoch", "last_seq", "runs", "last_ts")

    def __init__(self, epoch: int):
        self.epoch = epoch
        self.last_seq = -1
        self.runs: list[list[int]] = []
        # newest record timestamp this pid appended — the retention-clock
        # expiry key (record timestamps replicate verbatim, so every
        # replica ages the same pid out at the same stream time)
        self.last_ts = 0

    def note(
        self, first_seq: int, last_seq: int, first_offset: int, ts: int = 0
    ) -> None:
        """Record an appended span (contiguous in seq and offset)."""
        if ts > self.last_ts:
            self.last_ts = ts
        if self.runs:
            r = self.runs[-1]
            if (
                first_seq == r[1] + 1
                and first_offset == r[2] + (r[1] - r[0]) + 1
            ):
                r[1] = last_seq  # extends the newest run
                self.last_seq = max(self.last_seq, last_seq)
                return
        self.runs.append([first_seq, last_seq, first_offset])
        del self.runs[:-_MAX_PRODUCER_RUNS]
        self.last_seq = max(self.last_seq, last_seq)

    def find(self, seq: int, n: int) -> tuple[int, int] | None:
        """Original (first, last) offsets of a retried batch ``[seq,
        seq+n)``, or None if it is not fully inside a cached run."""
        for r in reversed(self.runs):
            if r[0] <= seq and seq + n - 1 <= r[1]:
                first = r[2] + (seq - r[0])
                return first, first + n - 1
        return None

    def clone(self) -> "_ProducerState":
        """Deep copy for producer-state snapshots (runs are mutable)."""
        c = _ProducerState(self.epoch)
        c.last_seq = self.last_seq
        c.last_ts = self.last_ts
        c.runs = [list(r) for r in self.runs]
        return c


def default_partition(
    keys: Sequence[bytes | None] | None, nparts: int, now_ms: int
) -> int:
    """Default partitioner shared by every backend: key-hash when the batch
    is keyed, else a time-slot (sticky round-robin-ish). Keeping one
    implementation means a key maps to the same partition on a bare
    StreamLog and on a BrokerCluster.

    The key hash is CRC32, not Python's ``hash()``: ``hash(bytes)`` is
    salted per process (PYTHONHASHSEED), so the same key would land on
    different partitions across producer processes and restarts. A stable
    hash is what makes key→partition routing a durable contract (Kafka
    uses murmur2 for the same reason).
    """
    if keys is not None and keys and keys[0] is not None:
        return zlib.crc32(bytes(keys[0])) % nparts
    return now_ms % nparts


@dataclass(frozen=True)
class TopicPartition:
    """Identifies one partition of one topic (Kafka's TopicPartition)."""

    topic: str
    partition: int

    def __str__(self) -> str:  # [topic:partition] per the paper's format
        return f"{self.topic}:{self.partition}"


@dataclass(frozen=True)
class Record:
    """One record as seen by a consumer."""

    topic: str
    partition: int
    offset: int
    value: memoryview  # zero-copy view into the segment buffer
    key: bytes | None
    timestamp_ms: int

    def value_bytes(self) -> bytes:
        return bytes(self.value)


@dataclass
class LogConfig:
    """Per-topic configuration (mirrors Kafka topic configs)."""

    num_partitions: int = 1
    # delete-retention knobs (paper §V): None ⇒ not applicable
    retention_bytes: int | None = None
    retention_ms: int | None = None
    segment_bytes: int = 8 * 1024 * 1024  # roll segments at this size
    # cleanup policy: "delete" evicts whole head segments by size/age;
    # "compact" (keyed topics, DESIGN.md §11) rewrites sealed segments
    # keeping the latest record per key — offsets stay stable, reads skip
    # the holes. Size/age eviction is disabled under compact.
    cleanup: str = "delete"
    # compact only: how long a tombstone (empty value, non-None key)
    # survives after it becomes the latest record for its key, measured
    # in *stream time* (the max retained record timestamp below the
    # compaction horizon) so every replica cleans identically
    tombstone_retention_ms: int = 24 * 60 * 60 * 1000
    # compact only: dirty (newly appended) bytes that trigger the inline
    # cleaner on a bare log; None ⇒ one segment's worth
    min_cleanable_bytes: int | None = None
    # sparse index granularity: one offset/time index entry per this many
    # payload bytes in a segment (Kafka's index.interval.bytes)
    index_interval_bytes: int = 4096
    # replication: honored by repro.core.cluster.BrokerCluster; a bare
    # single-host StreamLog keeps these as bookkeeping only. None means
    # "backend default" (1 on a bare log; the cluster's configured defaults
    # on a BrokerCluster) — so a config written for partitioning/retention
    # never silently opts a cluster topic out of replication.
    replication_factor: int | None = None
    min_insync_replicas: int | None = None  # acks=all needs this many in ISR
    # disk spill: sealed (rolled) segments move their payload to an
    # mmap-backed file under spill_dir; reads stay zero-copy (memoryview
    # over the map). Host RAM then holds only the active segment + indexes.
    spill_dir: str | None = None


class _Segment:
    """A contiguous chunk of the partition log.

    Layout: one shared ``bytearray`` holding concatenated record payloads;
    numpy index arrays map relative record index -> (start, length, key
    range, timestamp). Batched appends write once into the buffer.
    """

    __slots__ = (
        "base_offset",
        "buf",
        "buf_len",
        "key_buf",
        "starts",
        "lengths",
        "key_starts",
        "key_lengths",
        "timestamps",
        "pids",
        "peps",
        "pseqs",
        "ctrls",
        "markers",
        "count",
        "created_ms",
        "_spill_file",
        "logical_bytes",
        "offsets",
        "index_every",
        "index_offsets",
        "index_times",
        "_index_next",
        "max_ts",
        "txn_index",
    )

    def __init__(
        self, base_offset: int, created_ms: int, index_every: int = 4096
    ):
        self.base_offset = base_offset
        # the payload buffer over-allocates (doubling growth) and tracks the
        # written prefix in buf_len: appends are a single in-place slice
        # assignment instead of a resize, so a hot 8 MiB segment doesn't
        # re-memcpy itself every few batches (bytearray's native growth
        # factor is ~1.125x) and appends can't hit BufferError from a
        # consumer's outstanding zero-copy view (equal-length slice writes
        # never resize an exported buffer)
        self.buf = bytearray()
        self.buf_len = 0
        self.key_buf = bytearray()
        # python lists while hot; frozen to numpy on roll
        self.starts: list[int] = []
        self.lengths: list[int] = []
        self.key_starts: list[int] = []
        self.key_lengths: list[int] = []
        self.timestamps: list[int] = []
        # per-record producer metadata (pid < 0 ⇒ non-idempotent record):
        # batches carry their (pid, epoch, seq) into the log itself, so a
        # replica — or a rebuild after truncation — derives exactly the
        # same producer-state table the leader built incrementally.
        # Lazily allocated (None until the segment's first stamped
        # record, backfilled with sentinels then), so purely
        # non-idempotent partitions pay nothing per record.
        self.pids: list[int] | None = None
        self.peps: list[int] | None = None
        self.pseqs: list[int] | None = None
        # per-record control/transaction flags (CTRL_*), lazily allocated
        # like the producer metadata: None until the segment holds its
        # first transactional or marker record. ``markers`` counts the
        # control markers among them, so reads of marker-free spans keep
        # the contiguous fast path even on fully-transactional topics
        # (whose every record carries a ctrl flag).
        self.ctrls: list[int] | None = None
        self.markers = 0
        self.count = 0
        self.created_ms = created_ms
        self._spill_file = None
        # retained payload bytes when the physical buffers can't shrink
        # (truncation inside a sealed mmap-backed segment); None = physical
        self.logical_bytes: int | None = None
        # per-record logical offsets; None ⇒ contiguous from base_offset.
        # Materialized the first time a compaction rewrite (or a replica
        # fetch of compacted records) leaves holes in the offset sequence.
        self.offsets: list[int] | None = None
        # sparse offset/time index (DESIGN.md §11): one entry per
        # ~index_every payload bytes. index_offsets holds (rel_record,
        # byte_pos); index_times holds (timestamp_ms, rel_record), kept
        # non-decreasing in timestamp (out-of-order stamps are skipped,
        # Kafka's .timeindex rule).
        self.index_every = index_every
        self.index_offsets: list[tuple[int, int]] = []
        self.index_times: list[tuple[int, int]] = []
        self._index_next = index_every
        self.max_ts = 0  # newest record timestamp (segment-skip key)
        # aborted-transaction index (Kafka's .txnindex): (pid, first,
        # marker) ranges overlapping this segment, stamped when an ABORT
        # marker lands — read_committed's prefilter consults only the
        # segments a read spans instead of the partition-wide abort list
        self.txn_index: list[tuple[int, int, int]] = []

    @property
    def size_bytes(self) -> int:
        if self.logical_bytes is not None:
            return self.logical_bytes
        return self.buf_len + len(self.key_buf)

    @property
    def last_offset(self) -> int:
        if self.offsets:
            return self.offsets[-1]
        return self.base_offset + self.count - 1

    @property
    def next_offset(self) -> int:
        return self.last_offset + 1

    def off(self, rel: int) -> int:
        """Logical offset of relative record ``rel``."""
        if self.offsets is not None:
            return self.offsets[rel]
        return self.base_offset + rel

    def rel_range(self, lo_off: int, hi_off: int) -> tuple[int, int]:
        """Relative record window covering logical offsets
        ``[lo_off, hi_off)`` — bisect on the offsets array when the
        segment has holes, arithmetic when it is contiguous."""
        if self.offsets is None:
            lo = max(lo_off - self.base_offset, 0)
            hi = max(min(hi_off - self.base_offset, self.count), lo)
            return lo, hi
        lo = bisect.bisect_left(self.offsets, lo_off)
        hi = bisect.bisect_left(self.offsets, hi_off)
        return lo, hi

    def append_batch(
        self,
        values: Sequence[bytes | bytearray | memoryview],
        keys: Sequence[bytes | None] | None,
        timestamp_ms: int | Sequence[int],
        prods: tuple[Sequence[int], Sequence[int], Sequence[int]] | None = None,
        offsets: Sequence[int] | None = None,
    ) -> None:
        """Append one message set in bulk: one ``join`` into the shared
        buffer plus list extends, instead of a per-record Python loop —
        the hot path of every produce and every replica push.

        ``prods`` is per-record producer metadata ``(pids, epochs, seqs)``
        (parallel sequences); None extends the non-idempotent sentinel.
        ``offsets`` assigns explicit (ascending) logical offsets — the
        compaction rewrite / gapped-replica-fetch path; a contiguous run
        starting at the segment's next offset stays on the dense layout."""
        n = len(values)
        if n == 0:
            return
        if offsets is not None:
            if (
                self.offsets is None
                and offsets[0] == self.next_offset
                and offsets[-1] - offsets[0] + 1 == n
            ):
                offsets = None  # contiguous continuation: stay dense
            elif self.offsets is None:
                # first hole: materialize the dense prefix
                self.offsets = list(
                    range(self.base_offset, self.base_offset + self.count)
                )
        if self.offsets is not None:
            if offsets is None:
                start = self.next_offset
                self.offsets.extend(range(start, start + n))
            else:
                self.offsets.extend(offsets)
        pos = self.buf_len
        lens = list(map(len, values))
        starts = list(itertools.accumulate(lens, initial=pos))
        end = starts.pop()  # accumulate also yields the end position
        if end > len(self.buf):
            # preallocate with doubling growth (O(log) total re-copies)
            grow = bytes(max(end - len(self.buf), len(self.buf)))
            try:
                self.buf += grow
            except BufferError:
                # a consumer's zero-copy view pins the current buffer:
                # rebuild instead of resizing (old views stay valid on the
                # old buffer; appends continue on the new one)
                self.buf = self.buf[:] + grow
        self.buf[pos:end] = b"".join(values)
        self.buf_len = end
        self.starts.extend(starts)
        self.lengths.extend(lens)
        kpos = len(self.key_buf)
        if keys is None:
            self.key_starts.extend([kpos] * n)
            self.key_lengths.extend([-1] * n)
        else:
            for k in keys:
                if k is None:
                    self.key_starts.append(kpos)
                    self.key_lengths.append(-1)
                else:
                    self.key_starts.append(kpos)
                    self.key_lengths.append(len(k))
                    self.key_buf += k
                    kpos += len(k)
        if isinstance(timestamp_ms, int):
            self.timestamps.extend([timestamp_ms] * n)
            if timestamp_ms > self.max_ts:
                self.max_ts = timestamp_ms
        else:
            self.timestamps.extend(timestamp_ms)
            m = max(timestamp_ms)
            if m > self.max_ts:
                self.max_ts = m
        # sparse offset/time index entries: one per ~index_every payload
        # bytes. Amortized — between crossings there is zero per-record
        # work, and a crossing costs one bisect per entry, not a scan.
        if starts and starts[-1] >= self._index_next:
            ts_all = self.timestamps
            while self._index_next <= starts[-1]:
                i = bisect.bisect_left(starts, self._index_next)
                rel = self.count + i
                self.index_offsets.append((rel, starts[i]))
                t = ts_all[rel]
                if not self.index_times or t >= self.index_times[-1][0]:
                    self.index_times.append((t, rel))
                self._index_next = starts[i] + self.index_every
        ctrls = prods[3] if prods is not None and len(prods) > 3 else None
        if prods is not None:
            if self.pids is None:
                # first stamped record: backfill the unstamped prefix
                self.pids = [-1] * self.count
                self.peps = [-1] * self.count
                self.pseqs = [-1] * self.count
            self.pids.extend(prods[0])
            self.peps.extend(prods[1])
            self.pseqs.extend(prods[2])
        elif self.pids is not None:
            self.pids.extend(itertools.repeat(-1, n))
            self.peps.extend(itertools.repeat(-1, n))
            self.pseqs.extend(itertools.repeat(-1, n))
        if ctrls is not None and (self.ctrls is not None or any(ctrls)):
            if self.ctrls is None:
                self.ctrls = [CTRL_NONE] * self.count
            self.ctrls.extend(ctrls)
            self.markers += sum(1 for x in ctrls if x >= CTRL_COMMIT)
        elif self.ctrls is not None:
            self.ctrls.extend(itertools.repeat(CTRL_NONE, n))
        self.count += n

    def record(self, topic: str, partition: int, rel: int) -> Record:
        start = self.starts[rel]
        length = self.lengths[rel]
        klen = self.key_lengths[rel]
        key = (
            None
            if klen < 0
            else bytes(self.key_buf[self.key_starts[rel] : self.key_starts[rel] + klen])
        )
        return Record(
            topic=topic,
            partition=partition,
            offset=self.off(rel),
            value=memoryview(self.buf)[start : start + length],
            key=key,
            timestamp_ms=self.timestamps[rel],
        )

    def spill(self, path: str) -> None:
        """Seal this segment's payload to an mmap-backed file (zero-copy
        reads continue through the map); frees the heap buffer."""
        import mmap

        with open(path, "wb") as f:
            f.write(bytes(memoryview(self.buf)[: self.buf_len]))
            f.flush()
        if self.buf_len == 0:
            return
        fh = open(path, "rb")
        mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
        self.buf = mm  # memoryview(mmap) slices stay zero-copy
        self._spill_file = (fh, path)

    def drop_spill(self) -> None:
        sp = getattr(self, "_spill_file", None)
        if sp is not None:
            fh, path = sp
            try:
                self.buf.close() if hasattr(self.buf, "close") else None
            except BufferError:
                pass  # outstanding zero-copy views keep the map alive
            try:
                fh.close()
                os.unlink(path)
            except OSError:
                pass


@dataclass
class RecordBatch:
    """A batch of records read from one partition — supports vectorized decode.

    ``values`` are zero-copy memoryviews; ``to_matrix`` stacks fixed-size
    payloads into a single (n, record_bytes) uint8 array in one pass, the
    fast path used by the training data pipeline.
    """

    topic: str
    partition: int
    first_offset: int
    values: list[memoryview]
    timestamps: list[int]
    # read_committed reads skip control markers and aborted records, so
    # the delivered records may be non-contiguous: ``offsets`` then holds
    # each record's true offset and ``scanned`` how many raw offsets the
    # read consumed (next_offset = first_offset + scanned, so a poll
    # advances past a marker-only span instead of re-reading it forever).
    # Both stay None on the contiguous (raw) read path.
    offsets: list[int] | None = None
    scanned: int | None = None
    # zero-copy framing (DESIGN.md §10): records of one segment are always
    # tightly packed, so the contiguous read path also hands out one
    # ``(payload_view, record_count)`` memoryview per segment span covering
    # the delivered records back to back. Fixed-layout decoders
    # (repro.data.formats) turn a span directly into per-field strided
    # ndarray views — no per-record Python, no copy. None on filtered
    # (marker/aborted-skipping) reads, where delivery is non-contiguous.
    spans: list[tuple[memoryview, int]] | None = None

    def __len__(self) -> int:
        return len(self.values)

    @property
    def next_offset(self) -> int:
        if self.scanned is not None:
            return self.first_offset + self.scanned
        return self.first_offset + len(self.values)

    def framed(self, record_bytes: int) -> list[tuple[memoryview, int]] | None:
        """The batch's contiguous spans, validated for fixed-layout decode
        at ``record_bytes`` per record: every delivered record accounted
        for, every span exactly ``count * record_bytes`` long. None when
        the batch came off a filtered read (no spans) or the records are
        not the expected fixed size — callers then fall back to the
        copying :meth:`to_matrix` path."""
        if self.spans is None or record_bytes <= 0:
            return None
        if sum(n for _, n in self.spans) != len(self.values):
            return None
        for mv, n in self.spans:
            if mv.nbytes != n * record_bytes:
                return None
        return self.spans

    def to_matrix(self) -> np.ndarray:
        if not self.values:
            return np.zeros((0, 0), dtype=np.uint8)
        n = len(self.values[0])
        if any(len(v) != n for v in self.values):
            raise ValueError("to_matrix requires fixed-size records")
        spans = self.framed(n)
        if spans is not None:
            # contiguous fixed-size records: bulk row-block copies (one
            # per segment span) instead of a per-record loop
            out = np.empty((len(self.values), n), dtype=np.uint8)
            row = 0
            for mv, cnt in spans:
                out[row : row + cnt] = np.frombuffer(mv, np.uint8).reshape(cnt, n)
                row += cnt
            return out
        out = np.empty((len(self.values), n), dtype=np.uint8)
        for i, v in enumerate(self.values):
            out[i] = np.frombuffer(v, dtype=np.uint8)
        return out


class _Partition:
    def __init__(self, topic: str, index: int, cfg: LogConfig, clock: Callable[[], int],
                 lock_class: str = "log-part"):
        self.topic = topic
        self.index = index
        self.cfg = cfg
        self.clock = clock
        self.segments: list[_Segment] = [
            _Segment(0, clock(), index_every=cfg.index_interval_bytes)
        ]
        self.log_start_offset = 0  # first retained offset
        # pid -> dedup state; derived purely from the records in the log
        # (their embedded (pid, epoch, seq) metadata), kept incrementally
        # on every append and rebuilt from the retained log after
        # truncation — so leader, followers and a reconciled rejoiner all
        # hold the same table. The window is additionally bounded by
        # retention: a pid whose records were all evicted starts fresh
        # (Kafka's producer-id expiry).
        self.producers: dict[int, _ProducerState] = {}
        # transaction state, derived purely from the records (txn flags +
        # control markers), exactly like the producer table above:
        #   txn_open: pid -> (first offset of its open txn, producer epoch)
        #   aborted:  [(pid, first_offset, marker_offset), ...] — records
        #             of `pid` in [first, marker) belong to an aborted
        #             transaction and are invisible at read_committed
        self.txn_open: dict[int, tuple[int, int]] = {}
        self.aborted: list[tuple[int, int, int]] = []
        # earliest time the retention-clock pid expiry could next fire
        # (min last_ts + retention_ms, recomputed by each sweep): keeps
        # the expiry scan off the per-append hot path
        self._pid_deadline = 0
        # producer-state snapshots (DESIGN.md §11): sorted list of
        # (offset, producers, txn_open, aborted) — the state derived from
        # records strictly below ``offset``. Taken at every segment roll
        # and at every compaction horizon; _rebuild_producer_state
        # restores the newest snapshot at or below the rebuild point and
        # replays only the suffix.
        self.snapshots: list[tuple] = []
        # everything below this offset has been compacted (latest-per-key
        # holds); the leader propagates it so followers clean identically
        self.compact_point = 0
        self._dirty_bytes = 0  # appended since the last cleaner pass
        # _derive_state_at replays history against swapped-in state; the
        # flag suppresses side effects (txn_index stamping) during it
        self._derive_mode = False
        self.lock = make_rlock(lock_class, name=f"{lock_class}:{topic}:{index}")

    # ------------------------------------------------------------------ write
    def append_batch(
        self,
        values: Sequence[bytes],
        keys: Sequence[bytes | None] | None,
        timestamps: Sequence[int] | None = None,
        prods: tuple | None = None,
        producer: tuple[int, int, int] | None = None,
        txn: bool = False,
        offsets: Sequence[int] | None = None,
        seg_base: int | None = None,
    ) -> tuple[int, int]:
        """Append a message set; returns (first_offset, last_offset).

        ``timestamps`` is passed by replication only: a follower re-appends
        leader records with their original timestamps so replicas agree on
        time-based retention and on what consumers observe after failover.

        Producer metadata rides the same way: ``producer=(pid, epoch,
        base_seq)`` stamps one batch (leader append / direct ISR push —
        sequences run ``base_seq..base_seq+n-1``), while ``prods`` carries
        per-record metadata fetched from another replica's log. Either
        path updates this partition's dedup table as a side effect; the
        *checks* (fencing, dedup, gap detection) live in
        :meth:`idempotent_append` — replication never re-validates, leader
        order is law.

        ``offsets`` (replication only) re-appends records at their
        leader-assigned logical offsets — non-contiguous when the leader
        compacted the fetched range; the segment then tracks explicit
        per-record offsets and reads skip the holes. ``seg_base`` is the
        source segment's base offset (replication only): a batch from a
        segment beyond the local tail rolls a new local segment at that
        base, keeping replica segment layouts convergent.
        """
        with self.lock:
            now = self.clock()
            n = len(values)
            if producer is not None:
                pid, pep, seq = producer
                # lazy C-level iterables: the segment extends consume them
                # without materializing intermediate lists (hot path);
                # the ctrl column is only materialized for transactional
                # batches, so plain idempotent produce stays flag-free
                prods = (
                    itertools.repeat(pid, n),
                    itertools.repeat(pep, n),
                    range(seq, seq + n),
                    [CTRL_TXN_DATA] * n if txn else None,
                )
            seg = self.segments[-1]
            first_new = offsets[0] if offsets else None
            # the source segment's base, when replicating: replica
            # fetches never span leader segments, so a batch from a
            # segment beyond the local tail IS a leader roll boundary —
            # rolling with it keeps replica segment layouts (and thereby
            # compact_to horizons, clamped to local bases) convergent
            boundary = None
            if seg_base is not None and seg_base > seg.last_offset:
                boundary = seg_base
            elif first_new is not None and first_new > seg.last_offset + 1:
                # gapped batch jumping past the tail (compaction hole)
                boundary = first_new
            if seg.count == 0 and boundary is not None:
                # empty active segment behind the boundary (a reset
                # follower re-fetching a cleaned range): re-base it so
                # the hole isn't charged to this segment's raw window
                seg.base_offset = boundary
            elif seg.count > 0 and (
                seg.size_bytes >= self.cfg.segment_bytes
                or boundary is not None
            ):
                if self.cfg.spill_dir is not None:  # seal -> mmap-backed file
                    os.makedirs(self.cfg.spill_dir, exist_ok=True)
                    seg.spill(os.path.join(
                        self.cfg.spill_dir,
                        f"{self.topic}-{self.index}-{seg.base_offset}.seg",
                    ))
                new_base = boundary
                if new_base is None:
                    new_base = (
                        first_new if first_new is not None
                        else seg.last_offset + 1
                    )
                # the producer/txn state at a roll is exactly the state
                # derived from records below the new segment: snapshot it,
                # so rebuilds replay at most one segment's worth of suffix
                self._take_snapshot_locked(new_base)
                seg = _Segment(
                    new_base, now, index_every=self.cfg.index_interval_bytes
                )
                self.segments.append(seg)
            first = offsets[0] if offsets else seg.next_offset
            seg.append_batch(
                values, keys, now if timestamps is None else timestamps,
                prods, offsets=offsets,
            )
            if producer is not None:
                # one contiguous batch: a single run merge, off the
                # per-record path (the acks=all hot path pushes batches)
                ts = timestamps if timestamps is None or isinstance(
                    timestamps, int
                ) else (timestamps[-1] if len(timestamps) else None)
                self._note_producer_run(
                    pid, pep, seq, seq + n - 1, first,
                    now if ts is None else ts,
                )
                if txn:
                    self._open_txn(pid, pep, first)
            elif prods is not None:
                self._note_producer_records(
                    prods, first, now if timestamps is None else timestamps,
                    offsets=offsets,
                )
            self._enforce_retention(now)
            if self.cfg.cleanup == "compact":
                self._dirty_bytes += sum(map(len, values))
                thresh = self.cfg.min_cleanable_bytes
                if thresh is None:
                    thresh = self.cfg.segment_bytes
                if self._dirty_bytes >= thresh and len(self.segments) > 1:
                    self._dirty_bytes = 0
                    self._compact_locked(self.segments[-1].base_offset)
            return first, seg.last_offset

    # ------------------------------------------------------ producer state
    def _producer_state(self, pid: int, epoch: int) -> _ProducerState | None:
        """State for ``pid`` at ``epoch``; a newer epoch resets the dedup
        window (an epoch bump restarts sequence numbering), an older one
        returns None (the record predates the current incarnation)."""
        st = self.producers.get(pid)
        if st is None or epoch > st.epoch:
            st = _ProducerState(epoch)
            self.producers[pid] = st
        elif epoch < st.epoch:
            return None
        return st

    def _note_producer_run(
        self,
        pid: int,
        epoch: int,
        first_seq: int,
        last_seq: int,
        first_off: int,
        ts: int = 0,
    ) -> None:
        st = self._producer_state(pid, epoch)
        if st is not None:
            st.note(first_seq, last_seq, first_off, ts)

    def _note_producer_records(
        self,
        prods: tuple,
        first_off: int,
        timestamps: Sequence[int] | int = 0,
        offsets: Sequence[int] | None = None,
    ) -> None:
        """Replication path: fold per-record metadata into the table.
        Consecutive records merge into the same runs the source built, so
        replica tables converge on the leader's. Control flags replay the
        transaction state machine the same way: a txn-flagged record
        opens its pid's transaction, a marker closes (or aborts) it.
        ``offsets`` carries explicit per-record offsets when the fetched
        range had compaction holes (records are then not at
        ``first_off + i``)."""
        pids, peps, pseqs = prods[0], prods[1], prods[2]
        ctrls = prods[3] if len(prods) > 3 else None
        scalar_ts = timestamps if isinstance(timestamps, int) else None
        for i, pid in enumerate(pids):
            if pid < 0:
                continue
            off = offsets[i] if offsets is not None else first_off + i
            ctrl = ctrls[i] if ctrls is not None else CTRL_NONE
            if ctrl >= CTRL_COMMIT:
                self._close_txn(
                    pid, peps[i], off, abort=ctrl == CTRL_ABORT
                )
                continue
            ts = scalar_ts if scalar_ts is not None else timestamps[i]
            self._note_producer_run(
                pid, peps[i], pseqs[i], pseqs[i], off, ts
            )
            if ctrl == CTRL_TXN_DATA:
                self._open_txn(pid, peps[i], off)

    def _rebuild_producer_state(self) -> None:
        """Re-derive the dedup table — and the transaction state — after
        ``truncate_to``: state for truncated records must disappear —
        their batches are gone, so a retry must re-append, not dedup
        against offsets that no longer hold them, and a truncated marker
        must re-open the transaction it closed.

        Storage engine v2 (DESIGN.md §11): instead of replaying the full
        retained log, restore the newest producer-state snapshot at or
        below the new end and replay only the suffix — equivalent by
        construction (a snapshot *is* the replay state at its offset),
        and the only correct rebuild once compaction has physically
        removed stamped records below the compaction point (the pinned
        snapshot at ``compact_point`` covers them)."""
        end = self.end_offset
        # snapshots describing truncated-away state are no longer valid
        self._drop_snapshots(lambda off: off > end)
        start, self.producers, self.txn_open, self.aborted = (
            self._state_from_snapshot(end)
        )
        self._pid_deadline = 0  # rebuilt state may hold older timestamps
        # re-derive the per-segment aborted-txn index alongside the state
        for seg in self.segments:
            seg.txn_index.clear()
        for ent in self.aborted:
            self._stamp_txn_index(*ent)
        self._replay_records(start, end)
        # trim state below the log start exactly like incremental
        # retention would have: a restored snapshot may predate evictions
        self._expire_producers()

    def _replay_records(self, start: int, stop: int) -> None:
        """Replay producer/txn metadata of records in ``[start, stop)``
        into the current state (the shared engine of rebuilds and
        point-in-time derivations)."""
        for seg, lo, hi in self._iter_spans(start, stop - start):
            pids = seg.pids
            if pids is None:
                continue  # segment never saw a stamped record
            ctrls = seg.ctrls
            for r in range(lo, hi):
                if pids[r] < 0:
                    continue
                off = seg.off(r)
                ctrl = ctrls[r] if ctrls is not None else CTRL_NONE
                if ctrl >= CTRL_COMMIT:
                    self._close_txn(
                        pids[r], seg.peps[r], off, abort=ctrl == CTRL_ABORT
                    )
                    continue
                self._note_producer_run(
                    pids[r], seg.peps[r], seg.pseqs[r], seg.pseqs[r],
                    off, seg.timestamps[r],
                )
                if ctrl == CTRL_TXN_DATA:
                    self._open_txn(pids[r], seg.peps[r], off)

    # ------------------------------------------------- producer snapshots
    def _snapshot_file(self, offset: int) -> str | None:
        if self.cfg.spill_dir is None:
            return None
        return os.path.join(
            self.cfg.spill_dir,
            f"{self.topic}-{self.index}-{offset:020d}.snapshot",
        )

    def _take_snapshot_locked(self, offset: int) -> None:
        """Snapshot the producer/transaction state as of ``offset`` (the
        state derived from records strictly below it). Called at segment
        rolls; compaction inserts interior snapshots via
        :meth:`_snapshot_state_at`."""
        snap = (
            offset,
            {pid: st.clone() for pid, st in self.producers.items()},
            dict(self.txn_open),
            list(self.aborted),
        )
        i = bisect.bisect_left([s[0] for s in self.snapshots], offset)
        if i < len(self.snapshots) and self.snapshots[i][0] == offset:
            self.snapshots[i] = snap
        else:
            self.snapshots.insert(i, snap)
        self._write_snapshot_file(snap)
        self._trim_snapshots()

    def _write_snapshot_file(self, snap: tuple) -> None:
        """Durable snapshot format (DESIGN.md §11) — best-effort JSON
        sidecar next to the spilled segments; the in-memory copy is
        authoritative for this in-process broker."""
        path = self._snapshot_file(snap[0])
        if path is None:
            return
        offset, producers, txn_open, aborted = snap
        payload = {
            "offset": offset,
            "producers": {
                str(pid): {
                    "epoch": st.epoch,
                    "last_seq": st.last_seq,
                    "last_ts": st.last_ts,
                    "runs": [list(r) for r in st.runs],
                }
                for pid, st in producers.items()
            },
            "txn_open": {
                str(pid): list(v) for pid, v in txn_open.items()
            },
            "aborted": [list(a) for a in aborted],
        }
        try:
            import json

            os.makedirs(self.cfg.spill_dir, exist_ok=True)
            with open(path, "w") as f:
                json.dump(payload, f, sort_keys=True)
        except OSError:
            pass  # snapshot files are an optimization, never correctness

    def _drop_snapshots(self, drop: Callable[[int], bool]) -> None:
        kept = []
        for snap in self.snapshots:
            if not drop(snap[0]):
                kept.append(snap)
                continue
            path = self._snapshot_file(snap[0])
            if path is not None:
                try:
                    os.unlink(path)
                except OSError:
                    pass
        self.snapshots = kept

    def _trim_snapshots(self) -> None:
        """Bound the snapshot list. Snapshots below the newest one at or
        below the compaction point are unreachable (cluster truncation
        never targets below the compact point — the horizon is capped at
        the LSO ≤ HW, and every truncation target is ≥ the HW the
        snapshot's replica had); the one AT the compaction point is
        load-bearing (records below it no longer replay) and is never
        evicted by the size cap."""
        pin = None
        for snap in reversed(self.snapshots):
            if snap[0] <= self.compact_point:
                pin = snap[0]
                break
        if pin is not None:
            self._drop_snapshots(lambda off: off < pin)
        while len(self.snapshots) > _MAX_PRODUCER_SNAPSHOTS:
            victim = None
            for snap in self.snapshots:
                if snap[0] != pin:
                    victim = snap[0]
                    break
            if victim is None:
                break
            self._drop_snapshots(lambda off: off == victim)

    def _state_from_snapshot(self, upto: int) -> tuple[int, dict, dict, list]:
        """Newest snapshot at or below ``upto`` as freshly cloned state:
        ``(start_offset, producers, txn_open, aborted)``; empty state at
        the log start when no snapshot qualifies."""
        for snap in reversed(self.snapshots):
            if snap[0] <= upto:
                offset, producers, txn_open, aborted = snap
                return (
                    offset,
                    {pid: st.clone() for pid, st in producers.items()},
                    dict(txn_open),
                    list(aborted),
                )
        return self.log_start_offset, {}, {}, []

    def _derive_state_at(self, upto: int) -> tuple[dict, dict, list]:
        """Producer/txn state as of ``upto`` (records strictly below it),
        computed from the nearest snapshot plus suffix replay — without
        disturbing the live state."""
        saved = (
            self.producers, self.txn_open, self.aborted, self._pid_deadline
        )
        self._derive_mode = True
        try:
            start, self.producers, self.txn_open, self.aborted = (
                self._state_from_snapshot(upto)
            )
            self._replay_records(start, upto)
            derived = (self.producers, self.txn_open, self.aborted)
        finally:
            self._derive_mode = False
            (
                self.producers, self.txn_open, self.aborted,
                self._pid_deadline,
            ) = saved
        return derived

    def _snapshot_state_at(self, offset: int) -> None:
        """Ensure a snapshot exists at exactly ``offset`` — compaction
        calls this for its horizon BEFORE cleaning, because the cleaned
        records' producer stamps are what a later full replay would have
        needed."""
        for snap in self.snapshots:
            if snap[0] == offset:
                return
        producers, txn_open, aborted = self._derive_state_at(offset)
        snap = (offset, producers, txn_open, aborted)
        i = bisect.bisect_left([s[0] for s in self.snapshots], offset)
        self.snapshots.insert(i, snap)
        self._write_snapshot_file(snap)

    # ------------------------------------------------------ transactions
    def _open_txn(self, pid: int, epoch: int, offset: int) -> None:
        """First transactional record of a (pid, epoch) transaction pins
        the partition's LSO at its offset until a marker resolves it."""
        cur = self.txn_open.get(pid)
        if cur is None:
            self.txn_open[pid] = (offset, epoch)
        elif epoch > cur[1]:
            # a newer incarnation appended before the old txn's marker
            # arrived (abnormal interleaving): keep the earliest offset —
            # the LSO must not advance past unresolved records
            self.txn_open[pid] = (cur[0], epoch)

    def _close_txn(
        self, pid: int, epoch: int, marker_off: int, *, abort: bool
    ) -> None:
        cur = self.txn_open.get(pid)
        if cur is None or epoch < cur[1]:
            return  # stale marker: never resolves a newer incarnation
        del self.txn_open[pid]
        # the pid is no longer pinned: re-arm the retention-clock expiry
        # sweep so a long-pinned idle pid is reconsidered promptly
        self._pid_deadline = 0
        if abort:
            self.aborted.append((pid, cur[0], marker_off))
            if not self._derive_mode:
                self._stamp_txn_index(pid, cur[0], marker_off)

    def _stamp_txn_index(self, pid: int, first: int, marker: int) -> None:
        """Record an aborted range on every segment it overlaps (the
        per-segment ``.txnindex``): read_committed's prefilter then
        consults only the spanned segments, not the partition-wide list."""
        ent = (pid, first, marker)
        for si in range(self._segment_for(first), len(self.segments)):
            seg = self.segments[si]
            if seg.base_offset > marker:
                break
            if seg.last_offset >= first and ent not in seg.txn_index:
                seg.txn_index.append(ent)

    def append_control(
        self, pid: int, epoch: int, *, abort: bool
    ) -> int | None:
        """Write a COMMIT/ABORT marker resolving ``pid``'s open
        transaction; returns the marker's offset, or None when the pid
        has no open transaction at ``epoch`` or newer here — which makes
        coordinator-recovery re-drives idempotent (the second marker
        write for an already-resolved partition is a no-op, not a
        duplicate marker)."""
        with self.lock:
            cur = self.txn_open.get(pid)
            if cur is None or cur[1] > epoch:
                return None
            value = _ABORT_MARKER if abort else _COMMIT_MARKER
            ctrl = CTRL_ABORT if abort else CTRL_COMMIT
            first, _last = self.append_batch(
                [value], None, prods=([pid], [epoch], [-1], [ctrl])
            )
            return first

    def last_stable_offset(self) -> int:
        """First offset of the earliest open transaction (Kafka's LSO):
        records at or above it are not yet stable — their transaction may
        still abort — so read_committed consumers stop here."""
        with self.lock:
            if not self.txn_open:
                return self.end_offset
            return min(first for first, _ in self.txn_open.values())

    def idempotent_append(
        self,
        values: Sequence[bytes],
        keys: Sequence[bytes | None] | None,
        timestamps: Sequence[int] | int | None,
        pid: int,
        epoch: int,
        seq: int,
        txn: bool = False,
    ) -> tuple[int, int, bool]:
        """Leader-side idempotent append: dedup + fencing + gap detection.

        Returns ``(first, last, duplicate)``. A retried batch whose
        sequences are already in the log returns the **original** offsets
        with ``duplicate=True`` instead of re-appending — the exactly-once
        contract across client retries. Raises :class:`ProducerFenced` for
        a stale epoch and :class:`OutOfOrderSequence` for a gap or a
        duplicate older than the dedup window.
        """
        with self.lock:
            n = len(values)
            st = self.producers.get(pid)
            if st is not None:
                if epoch < st.epoch:
                    raise ProducerFenced(
                        f"{self.topic}:{self.index} producer {pid} epoch "
                        f"{epoch} fenced by newer epoch {st.epoch}"
                    )
                if epoch == st.epoch and st.last_seq >= 0:
                    hit = st.find(seq, n)
                    if hit is not None:
                        return hit[0], hit[1], True
                    if seq <= st.last_seq:
                        raise OutOfOrderSequence(
                            f"{self.topic}:{self.index} producer {pid} "
                            f"sequence {seq} already appended but outside "
                            f"the dedup window (last_seq {st.last_seq})"
                        )
                    if seq != st.last_seq + 1:
                        raise OutOfOrderSequence(
                            f"{self.topic}:{self.index} producer {pid} "
                            f"sequence gap: expected {st.last_seq + 1}, "
                            f"got {seq}"
                        )
            first, last = self.append_batch(
                values, keys, timestamps, producer=(pid, epoch, seq), txn=txn
            )
            return first, last, False

    # ------------------------------------------------------------------- read
    @property
    def end_offset(self) -> int:
        # taken under the partition lock so a concurrent append's segment
        # roll can't be observed half-applied (the lock is reentrant, so
        # read paths that already hold it are unaffected)
        with self.lock:
            return self.segments[-1].next_offset

    def _bounded_count(self, offset: int, max_records: int) -> int:
        """Validate ``offset`` against [log start, end]; return how many
        *raw* offsets a read starting there may cover. On a compacted
        partition the window may contain holes, so the delivered record
        count can be smaller."""
        if offset < self.log_start_offset:
            raise OffsetOutOfRange(
                f"{self.topic}:{self.index} offset {offset} < log start "
                f"{self.log_start_offset} (evicted by retention)"
            )
        end = self.end_offset
        if offset > end:
            raise OffsetOutOfRange(
                f"{self.topic}:{self.index} offset {offset} > end {end}"
            )
        return min(max_records, end - offset)

    def _iter_spans(self, offset: int, n: int):
        """Yield ``(segment, rel_start, rel_stop)`` spans covering the raw
        offset window ``[offset, offset + n)`` — the one segment walk
        shared by consumer reads, replication fetches, and state replay.
        Compacted segments contribute only the records they still hold
        (``rel_range`` bisects their explicit offsets array)."""
        hi_off = offset + n
        if n <= 0:
            return
        for si in range(self._segment_for(offset), len(self.segments)):
            seg = self.segments[si]
            if seg.base_offset >= hi_off:
                break
            lo, hi = seg.rel_range(offset, hi_off)
            if hi > lo:
                yield seg, lo, hi

    def read(
        self, offset: int, max_records: int, isolation: str | None = None
    ) -> RecordBatch:
        if isolation == "read_committed":
            return self._read_committed(offset, max_records)
        with self.lock:
            n = self._bounded_count(offset, max_records)
            spans = list(self._iter_spans(offset, n))
            expect = offset  # raw-contiguity check: a dropped or re-based
            contiguous = True  # segment leaves a hole no span covers
            for seg, lo, hi in spans:
                if seg.off(lo) != expect:
                    contiguous = False
                    break
                expect = seg.off(hi - 1) + 1
            if not contiguous or any(
                seg.markers or seg.offsets is not None
                for seg, _, _ in spans
            ):
                # a control marker may sit in range — consumers never see
                # control records at ANY isolation level (a raw reader
                # handed marker bytes as a data record would crash on
                # them); read_uncommitted still delivers not-yet-resolved
                # and aborted transactional data. Compacted (gapped)
                # segments also take this path: their records need
                # explicit per-record offsets. Marker-free dense spans
                # (the overwhelming majority) stay on the contiguous
                # fast path below.
                return self._read_filtered(
                    offset, n, spans, skip_aborted=False
                )
            values: list[memoryview] = []
            timestamps: list[int] = []
            payload_spans: list[tuple[memoryview, int]] = []
            for seg, lo, hi in spans:
                mv = memoryview(seg.buf)
                for r in range(lo, hi):
                    start = seg.starts[r]
                    values.append(mv[start : start + seg.lengths[r]])
                    timestamps.append(seg.timestamps[r])
                # records of one segment are tightly packed (starts are
                # cumulative lengths), so the whole [lo, hi) span is ONE
                # contiguous byte range — exported as a single view for
                # zero-copy fixed-layout decode (RecordBatch.framed)
                end = seg.starts[hi - 1] + seg.lengths[hi - 1]
                payload_spans.append((mv[seg.starts[lo] : end], hi - lo))
            return RecordBatch(
                topic=self.topic,
                partition=self.index,
                first_offset=offset,
                values=values,
                timestamps=timestamps,
                spans=payload_spans,
            )

    def _read_committed(self, offset: int, max_records: int) -> RecordBatch:
        """Read capped at the LSO, with control markers and aborted
        records filtered out."""
        with self.lock:
            n = self._bounded_count(offset, max_records)
            n = min(n, max(self.last_stable_offset() - offset, 0))
            return self._read_filtered(
                offset, n, list(self._iter_spans(offset, n)),
                skip_aborted=True,
            )

    def _read_filtered(
        self, offset: int, n: int, spans: list, skip_aborted: bool
    ) -> RecordBatch:
        """Read with control markers filtered out — plus, at
        read_committed (``skip_aborted``), aborted transactions' records.
        The returned batch carries explicit per-record ``offsets`` and
        the raw ``scanned`` count, so the consumer's next position
        advances past filtered spans. Caller holds the partition lock."""
        values: list[memoryview] = []
        timestamps: list[int] = []
        offsets: list[int] = []
        abort_ranges: dict[int, list[tuple[int, int]]] = {}
        if skip_aborted:
            hi_off = offset + n
            # per-segment aborted-txn index (Kafka's .txnindex): only the
            # segments this read spans are consulted, so the prefilter
            # cost is bounded by the window — not by the partition's full
            # abort history. A range spanning several segments is stamped
            # on each; the ``seen`` set dedupes it.
            seen: set[tuple[int, int, int]] = set()
            for seg, _, _ in spans:
                for ent in seg.txn_index:
                    if (
                        ent[1] < hi_off
                        and ent[2] > offset
                        and ent not in seen
                    ):
                        seen.add(ent)
                        abort_ranges.setdefault(ent[0], []).append(
                            (ent[1], ent[2])
                        )
        for seg, lo, hi in spans:
            mv = memoryview(seg.buf)
            ctrls = seg.ctrls
            for r in range(lo, hi):
                ctrl = ctrls[r] if ctrls is not None else CTRL_NONE
                if ctrl >= CTRL_COMMIT:
                    continue  # control marker: never delivered
                if skip_aborted and ctrl == CTRL_TXN_DATA:
                    off = seg.off(r)
                    ab = abort_ranges.get(seg.pids[r])
                    if ab is not None and any(a <= off < b for a, b in ab):
                        continue  # aborted transaction's record
                start = seg.starts[r]
                values.append(mv[start : start + seg.lengths[r]])
                timestamps.append(seg.timestamps[r])
                offsets.append(seg.off(r))
        return RecordBatch(
            topic=self.topic,
            partition=self.index,
            first_offset=offset,
            values=values,
            timestamps=timestamps,
            offsets=offsets,
            scanned=n,
        )

    def offset_for_timestamp(self, ts_ms: int) -> int | None:
        """First retained offset with timestamp >= ``ts_ms`` via the
        sparse time index: segments whose ``max_ts`` is too old are
        skipped whole; within a candidate segment the index entry just
        below the target bounds a short forward scan."""
        with self.lock:
            for seg in self.segments:
                if seg.count == 0 or seg.max_ts < ts_ms:
                    continue
                lo = 0
                i = bisect.bisect_left(seg.index_times, (ts_ms,)) - 1
                if i >= 0:
                    lo = seg.index_times[i][1]
                tss = seg.timestamps
                for r in range(lo, seg.count):
                    if tss[r] >= ts_ms:
                        return seg.off(r)
            return None

    def _segment_for(self, offset: int) -> int:
        bases = [s.base_offset for s in self.segments]
        i = bisect.bisect_right(bases, offset) - 1
        return max(i, 0)

    def fetch_raw(
        self, offset: int, max_records: int
    ) -> tuple[
        list[bytes],
        list[bytes | None],
        list[int],
        tuple[list[int], list[int], list[int], list[int]] | None,
        list[int] | None,
        int,
        int | None,
    ]:
        """Replication fetch: materialized ``(values, keys, timestamps,
        producer metadata, offsets, next_offset, seg_base)`` so a follower can
        re-append them verbatim to its copy of the partition — including
        the (pid, epoch, seq) stamps its dedup table is derived from, and
        the control flags its transaction state is derived from.

        ``offsets`` is None for a dense window and the per-record logical
        offsets when the window has compaction holes; ``next_offset`` is
        the raw end of the covered window (the follower's next fetch
        position — it can advance past a fully-compacted gap even when no
        records were returned); ``seg_base`` the base offset of the
        segment the window came from (None for a pure-hole window).

        Like Kafka's fetch protocol, one response never spans segment
        files: the window is capped at the end of the first spanned
        segment. The follower rolls its own segments at the fetched
        ``seg_base`` boundaries (see :meth:`append_batch`), so replica
        segment layouts converge — which keeps ``compact_to`` horizons
        (clamped to local segment bases) in step across replicas."""
        with self.lock:
            n = self._bounded_count(offset, max_records)
            wbase: int | None = None
            if n > 0:
                i = self._segment_for(offset)
                seg0 = self.segments[i]
                if seg0.base_offset > offset:
                    # fully-compacted hole before the first retained
                    # segment: cover the hole only, so next_offset lands
                    # exactly on that segment's base
                    n = min(n, seg0.base_offset - offset)
                elif seg0.last_offset < offset:
                    # hole at this segment's raw tail: advance to the
                    # next segment's base
                    nxt = (
                        self.segments[i + 1].base_offset
                        if i + 1 < len(self.segments)
                        else offset + n
                    )
                    n = min(n, nxt - offset)
                elif seg0.last_offset < offset + n - 1:
                    n = seg0.last_offset - offset + 1
                    wbase = seg0.base_offset
                else:
                    wbase = seg0.base_offset
            values: list[bytes] = []
            keys: list[bytes | None] = []
            timestamps: list[int] = []
            pids: list[int] = []
            peps: list[int] = []
            pseqs: list[int] = []
            ctrls: list[int] = []
            spans = list(self._iter_spans(offset, n))
            # None unless some record in range is stamped, so followers of
            # purely non-idempotent partitions append lazily too
            stamped = any(seg.pids is not None for seg, _, _ in spans)
            gapped = any(seg.offsets is not None for seg, _, _ in spans)
            offs: list[int] | None = [] if gapped else None
            for seg, lo, hi in spans:
                for r in range(lo, hi):
                    start = seg.starts[r]
                    values.append(bytes(seg.buf[start : start + seg.lengths[r]]))
                    klen = seg.key_lengths[r]
                    ks = seg.key_starts[r]
                    keys.append(
                        None if klen < 0 else bytes(seg.key_buf[ks : ks + klen])
                    )
                    timestamps.append(seg.timestamps[r])
                if offs is not None:
                    offs.extend(seg.off(r) for r in range(lo, hi))
                if not stamped:
                    continue
                if seg.pids is None:
                    pids.extend(itertools.repeat(-1, hi - lo))
                    peps.extend(itertools.repeat(-1, hi - lo))
                    pseqs.extend(itertools.repeat(-1, hi - lo))
                else:
                    pids.extend(seg.pids[lo:hi])
                    peps.extend(seg.peps[lo:hi])
                    pseqs.extend(seg.pseqs[lo:hi])
                if seg.ctrls is None:
                    ctrls.extend(itertools.repeat(CTRL_NONE, hi - lo))
                else:
                    ctrls.extend(seg.ctrls[lo:hi])
            return (
                values, keys, timestamps,
                (pids, peps, pseqs, ctrls) if stamped else None,
                offs, offset + n, wbase,
            )

    def reset_to(self, offset: int) -> int:
        """Discard the entire partition contents and restart the log at
        ``offset`` (a follower that fell behind the leader's retention point
        re-fetches from the leader's log start)."""
        with self.lock:
            for s in self.segments:
                s.drop_spill()
            self.segments = [
                _Segment(offset, self.clock(), index_every=self.cfg.index_interval_bytes)
            ]
            self.log_start_offset = offset
            # the log is empty: dedup and transaction state rebuild as
            # records re-fetch (replica_append carries their metadata)
            self.producers = {}
            self.txn_open = {}
            self.aborted = []
            self._pid_deadline = 0
            self._drop_snapshots(lambda _off: True)
            self.compact_point = 0
            self._dirty_bytes = 0
            return offset

    def truncate_to(self, offset: int) -> int:
        """Discard every record at ``offset`` and beyond (post-failover log
        reconciliation: a deposed leader truncates to the new leader's end
        before re-fetching). Returns the new end offset — which on a
        compacted partition may sit below ``offset`` when the records just
        under the truncation point were compacted away."""
        with self.lock:
            if offset >= self.end_offset:
                return self.end_offset
            if offset < self.log_start_offset:
                # nothing retained below the truncation point — reset the
                # partition; the follower re-fetches from `offset` upward
                return self.reset_to(offset)
            while self.segments and self.segments[-1].base_offset >= offset:
                self.segments.pop().drop_spill()
            if not self.segments:
                self.segments = [
                    _Segment(
                        offset, self.clock(),
                        index_every=self.cfg.index_interval_bytes,
                    )
                ]
                self._rebuild_producer_state()
                return offset
            seg = self.segments[-1]
            if seg.offsets is not None:
                rel = bisect.bisect_left(seg.offsets, offset)
            else:
                rel = offset - seg.base_offset
            if rel < seg.count:
                if isinstance(seg.buf, bytearray):
                    # drop the truncated records' payload too, or it stays
                    # resident and skews size_bytes/retention accounting.
                    # Rebuild rather than resize in place: outstanding
                    # zero-copy reads may hold memoryview exports of the
                    # old buffer, and resizing an exported bytearray raises
                    # BufferError. The old buffer lives until those views
                    # are dropped; new appends go to the rebuilt one.
                    seg.buf = seg.buf[: seg.starts[rel]]
                    seg.buf_len = seg.starts[rel]
                    seg.key_buf = seg.key_buf[: seg.key_starts[rel]]
                else:
                    # sealed mmap segment: can't shrink the map — record the
                    # retained payload so size_bytes/retention stay honest
                    seg.logical_bytes = seg.starts[rel] + seg.key_starts[rel]
                del seg.starts[rel:]
                del seg.lengths[rel:]
                del seg.key_starts[rel:]
                del seg.key_lengths[rel:]
                del seg.timestamps[rel:]
                if seg.pids is not None:
                    del seg.pids[rel:]
                    del seg.peps[rel:]
                    del seg.pseqs[rel:]
                if seg.ctrls is not None:
                    seg.markers -= sum(
                        1 for x in seg.ctrls[rel:] if x >= CTRL_COMMIT
                    )
                    del seg.ctrls[rel:]
                if seg.offsets is not None:
                    del seg.offsets[rel:]
                # the sparse indexes cover only retained records; the next
                # index entry re-arms off the last survivor's byte position
                seg.index_offsets = [e for e in seg.index_offsets if e[0] < rel]
                seg.index_times = [e for e in seg.index_times if e[1] < rel]
                seg._index_next = (
                    seg.index_offsets[-1][1] + seg.index_every
                    if seg.index_offsets
                    else seg.index_every
                )
                seg.max_ts = max(seg.timestamps[:rel], default=0)
                seg.count = rel
            if seg._spill_file is not None:
                # sealed/spilled segments are read-only maps — appendable
                # writes need a fresh heap-backed active segment
                self.segments.append(
                    _Segment(
                        offset, self.clock(),
                        index_every=self.cfg.index_interval_bytes,
                    )
                )
            # dedup state for the truncated suffix must not survive it: a
            # deposed leader that rejoins (leader-epoch reconciliation)
            # re-derives the table from what the log still holds, so its
            # table converges with the new leader's as it re-fetches
            self._rebuild_producer_state()
            return self.end_offset

    # -------------------------------------------------------------- compaction
    def compact(self, horizon: int | None = None) -> dict:
        """Run the cleaner up to ``horizon`` (default: everything below
        the active segment). Returns the cleaner stats dict."""
        with self.lock:
            if horizon is None:
                horizon = self.segments[-1].base_offset
            return self._compact_locked(horizon)

    def compact_to(self, horizon: int) -> dict:
        """Follower-side cleaning: apply the leader's compact point. The
        keep rule is a pure function of (retained records, horizon,
        config), so replicas with the same log prefix converge on the
        same surviving records — idempotent and monotone (a lower or
        repeated horizon is a no-op)."""
        with self.lock:
            return self._compact_locked(horizon)

    def _compact_locked(self, horizon: int) -> dict:
        """One cleaner pass: rewrite every sealed segment wholly below
        ``horizon`` keeping only (a) keyless records and control markers,
        (b) the newest record of each key, (c) unexpired tombstones.
        Logical offsets are preserved (the rewritten segments carry
        explicit ``offsets`` arrays with holes); the producer/txn state
        the removed records would have replayed into is pinned by a
        snapshot at the horizon first."""
        stats = {
            "horizon": self.compact_point,
            "removed_records": 0,
            "removed_bytes": 0,
            "rewritten_segments": 0,
        }
        if self.cfg.cleanup != "compact" or len(self.segments) < 2:
            return stats
        # never clean unstable records (their txn may abort) nor the
        # active segment; then clamp down to a segment boundary so the
        # latest-per-key guarantee below the compact point is exact
        horizon = min(
            horizon, self.last_stable_offset(), self.segments[-1].base_offset
        )
        bound = self.log_start_offset
        for seg in self.segments:
            if seg.base_offset <= horizon:
                bound = seg.base_offset
            else:
                break
        horizon = bound
        if horizon <= self.compact_point:
            return stats
        # the cleaned records' producer stamps must survive their removal:
        # pin the replay state at the horizon before touching anything
        self._snapshot_state_at(horizon)
        # pass 1: newest offset per key below the horizon, and the stream
        # clock (newest record timestamp) the tombstone grace runs on —
        # both derived from replicated record data only, so every replica
        # computes the same keep set
        latest: dict[bytes, int] = {}
        stream_ts = 0
        for seg, lo, hi in self._iter_spans(
            self.log_start_offset, horizon - self.log_start_offset
        ):
            kb = seg.key_buf
            kls = seg.key_lengths
            kss = seg.key_starts
            tss = seg.timestamps
            for r in range(lo, hi):
                if tss[r] > stream_ts:
                    stream_ts = tss[r]
                klen = kls[r]
                if klen < 0:
                    continue
                ks = kss[r]
                latest[bytes(kb[ks : ks + klen])] = seg.off(r)
        grace = self.cfg.tombstone_retention_ms
        # pass 2: rewrite the segments below the horizon
        out: list[_Segment] = []
        for seg in self.segments:
            if seg.base_offset >= horizon:
                out.append(seg)
                continue
            keep: list[int] = []
            drop_bytes = 0
            kls = seg.key_lengths
            kss = seg.key_starts
            lens = seg.lengths
            for r in range(seg.count):
                klen = kls[r]
                if klen < 0:
                    keep.append(r)  # keyless record or control marker
                    continue
                ks = kss[r]
                key = bytes(seg.key_buf[ks : ks + klen])
                if latest.get(key) != seg.off(r):
                    drop_bytes += lens[r] + klen  # superseded
                    continue
                if lens[r] == 0 and stream_ts - seg.timestamps[r] > grace:
                    drop_bytes += klen  # tombstone past its grace window
                    continue
                keep.append(r)
            if len(keep) == seg.count:
                out.append(seg)
                continue
            stats["removed_records"] += seg.count - len(keep)
            stats["removed_bytes"] += drop_bytes
            stats["rewritten_segments"] += 1
            spill_path = (
                seg._spill_file[1] if seg._spill_file is not None else None
            )
            new = self._rewrite_segment(seg, keep)
            seg.drop_spill()
            if new.count == 0:
                continue  # a fully-compacted segment disappears
            if spill_path is not None:
                try:
                    new.spill(spill_path)
                except OSError:
                    pass  # stays heap-backed; correctness is unaffected
            out.append(new)
        self.segments = out
        self.compact_point = horizon
        stats["horizon"] = horizon
        self._trim_snapshots()
        return stats

    def _rewrite_segment(self, seg: _Segment, keep: list[int]) -> _Segment:
        """Copy the ``keep`` records (by relative index) into a fresh
        segment at the same base offset, with explicit logical offsets.
        The old segment — and any zero-copy views pinning its buffer —
        is left untouched; readers that grabbed views before the swap
        keep reading valid (pre-compaction) bytes."""
        new = _Segment(
            seg.base_offset, seg.created_ms, index_every=seg.index_every
        )
        if keep:
            mv = memoryview(seg.buf)
            values = [
                bytes(mv[seg.starts[r] : seg.starts[r] + seg.lengths[r]])
                for r in keep
            ]
            keys = [
                None
                if seg.key_lengths[r] < 0
                else bytes(
                    seg.key_buf[
                        seg.key_starts[r]
                        : seg.key_starts[r] + seg.key_lengths[r]
                    ]
                )
                for r in keep
            ]
            ts = [seg.timestamps[r] for r in keep]
            offs = [seg.off(r) for r in keep]
            prods = None
            if seg.pids is not None:
                prods = (
                    [seg.pids[r] for r in keep],
                    [seg.peps[r] for r in keep],
                    [seg.pseqs[r] for r in keep],
                    [seg.ctrls[r] for r in keep]
                    if seg.ctrls is not None
                    else None,
                )
            new.append_batch(values, keys, ts, prods, offsets=offs)
        new.txn_index = list(seg.txn_index)
        return new

    # -------------------------------------------------------------- retention
    def _enforce_retention(self, now_ms: int) -> None:
        cfg = self.cfg
        if cfg.cleanup == "compact":
            # compacted topics never delete by age or size — the cleaner
            # bounds growth by rewriting history to latest-per-key instead
            # (Kafka's cleanup.policy=compact)
            return
        evicted = False
        # never evict the active (last) segment
        while len(self.segments) > 1:
            head = self.segments[0]
            evict = False
            if cfg.retention_bytes is not None:
                total = sum(s.size_bytes for s in self.segments)
                if total > cfg.retention_bytes:
                    evict = True
            if not evict and cfg.retention_ms is not None:
                # age by the segment's newest record timestamp (Kafka's
                # retention.ms semantics). Record timestamps replicate
                # verbatim, so leader and followers expire the same
                # records at the same time regardless of when each broker
                # physically fetched them; created_ms is only a fallback
                # for empty segments.
                age_ref = head.timestamps[-1] if head.timestamps else head.created_ms
                if now_ms - age_ref > cfg.retention_ms:
                    evict = True
            if not evict:
                break
            self.segments.pop(0).drop_spill()
            self.log_start_offset = self.segments[0].base_offset
            evicted = True
        if evicted:
            self._expire_producers()
            # snapshots strictly below the log start describe evicted
            # history no rebuild will ever ask for
            self._drop_snapshots(lambda off: off < self.log_start_offset)
        if (
            cfg.retention_ms is not None
            and self.producers
            and now_ms > self._pid_deadline
        ):
            # retention-clock pid expiry: a long-idle producer id is
            # forgotten once its newest record timestamp ages past
            # retention_ms — even while its records still sit in the
            # never-evicted active segment. Keyed to record timestamps
            # (which replicate verbatim), not to table size or local
            # fetch time, so every replica expires the same pids at the
            # same stream time (Kafka's producer-id expiration). The
            # sweep runs only when the cached deadline (earliest possible
            # expiry) passes — never on every append. New pids appended
            # after a sweep carry newer timestamps than its minimum on
            # the leader; a follower replaying older stamps may retain a
            # pid up to one retention period longer (extra dedup state:
            # the safe direction).
            min_ts = None
            for pid in list(self.producers):
                st = self.producers[pid]
                if pid in self.txn_open:
                    # an open txn pins its pid; excluded from the
                    # deadline too (its stale last_ts would otherwise
                    # drag the deadline into the past and re-run this
                    # sweep on every append) — _close_txn re-arms the
                    # sweep when the pin comes off
                    continue
                if now_ms - st.last_ts > cfg.retention_ms:
                    del self.producers[pid]
                elif min_ts is None or st.last_ts < min_ts:
                    min_ts = st.last_ts
            self._pid_deadline = (
                min_ts if min_ts is not None else now_ms
            ) + cfg.retention_ms

    def _expire_producers(self) -> None:
        """Age producer state out with retention: drop runs whose records
        were evicted (trimming a run that straddles the log start), and
        forget pids with nothing retained (Kafka's producer-id expiry).
        Keeps the incrementally-built table identical to what a rebuild
        from the retained log would produce, so leader and followers
        stay in agreement even when one of them reconciled via
        ``truncate_to``/``reset_to`` and the other never did."""
        lso = self.log_start_offset
        for pid in list(self.producers):
            st = self.producers[pid]
            kept: list[list[int]] = []
            for r in st.runs:
                end_off = r[2] + (r[1] - r[0])
                if end_off < lso:
                    continue  # fully evicted
                if r[2] < lso:  # straddles the log start: trim the head
                    r[0] += lso - r[2]
                    r[2] = lso
                kept.append(r)
            if kept:
                st.runs = kept
            else:
                del self.producers[pid]
        # aborted ranges whose marker fell below the log start describe
        # only evicted records; open transactions clamp their start to
        # the log start (the records below it are gone either way)
        self.aborted = [a for a in self.aborted if a[2] >= lso]
        for pid, (first, epoch) in list(self.txn_open.items()):
            if first < lso:
                self.txn_open[pid] = (lso, epoch)

    def size_bytes(self) -> int:
        with self.lock:
            return sum(s.size_bytes for s in self.segments)


class StreamLog:
    """The broker: a set of topics, each a list of partitions.

    Thread-safe. Also hosts the consumer-offset store (Kafka's
    ``__consumer_offsets``) used by :mod:`repro.core.consumer`.
    """

    def __init__(self, clock: Callable[[], float] | None = None,
                 lock_class: str = "log"):
        self._topics: dict[str, list[_Partition]] = {}
        self._configs: dict[str, LogConfig] = {}
        # the controller's internal metadata log nests inside the
        # controller lock, so it carries a distinct lock class
        # ("ctl-log") ranked above it — see repro.analysis.ranks
        self._lock_class = lock_class
        self._lock = make_rlock(lock_class, name=f"{lock_class}@{id(self):x}")
        self._clock = clock or time.time
        # consumer group -> TopicPartition -> committed offset
        self._committed: dict[str, dict[TopicPartition, int]] = {}
        # attachable observability registry (repro.core.metrics
        # MetricsRegistry) — None by default, so a bare log pays one
        # attribute load per append/read; BrokerCluster attaches its
        # cluster-wide registry to every broker's log
        self.metrics = None
        # bound hot-path handles, cached per attached registry: the
        # append/read fast path must not pay a series-key format + dict
        # lookup per call (that alone blows the ≤5% overhead budget)
        self._mcache: tuple | None = None

    def _hot_metrics(self, m) -> tuple:
        """(registry, append_hist, append_ctr, read_hist, read_ctr) for
        the currently attached registry; rebuilt if it was swapped."""
        cache = self._mcache
        if cache is None or cache[0] is not m:
            cache = self._mcache = (
                m,
                m.histogram("log_append_seconds", sample=8),
                m.counter("log_append_records_total"),
                m.histogram("log_read_seconds", sample=8),
                m.counter("log_read_records_total"),
            )
        return cache

    def _now_ms(self) -> int:
        return int(self._clock() * 1000)

    # ------------------------------------------------------------------ admin
    def create_topic(self, name: str, cfg: LogConfig | None = None) -> None:
        with self._lock:
            if name in self._topics:
                raise ValueError(f"topic {name!r} already exists")
            cfg = cfg or LogConfig()
            self._configs[name] = cfg
            self._topics[name] = [
                _Partition(name, i, cfg, self._now_ms,
                           lock_class=self._lock_class + "-part")
                for i in range(cfg.num_partitions)
            ]

    def ensure_topic(self, name: str, cfg: LogConfig | None = None) -> None:
        with self._lock:
            if name not in self._topics:
                self.create_topic(name, cfg)

    def topics(self) -> list[str]:
        with self._lock:
            return sorted(self._topics)

    def num_partitions(self, topic: str) -> int:
        return len(self._partitions(topic))

    def delete_topic(self, name: str) -> None:
        with self._lock:
            self._topics.pop(name, None)
            self._configs.pop(name, None)

    def _partitions(self, topic: str) -> list[_Partition]:
        try:
            return self._topics[topic]
        except KeyError:
            raise KeyError(f"unknown topic {topic!r}") from None

    def _partition(self, topic: str, partition: int) -> _Partition:
        parts = self._partitions(topic)
        if not 0 <= partition < len(parts):
            raise IndexError(f"{topic} has no partition {partition}")
        return parts[partition]

    # ---------------------------------------------------------------- produce
    def produce(
        self,
        topic: str,
        value: bytes,
        *,
        key: bytes | None = None,
        partition: int | None = None,
    ) -> tuple[int, int]:
        """Append one record; returns (partition, offset)."""
        (p, first, _last) = self._produce_batch(topic, [value], [key], partition)
        return p, first

    def produce_batch(
        self,
        topic: str,
        values: Sequence[bytes],
        *,
        keys: Sequence[bytes | None] | None = None,
        partition: int | None = None,
    ) -> tuple[int, int, int]:
        """Append a message set to one partition.

        Returns ``(partition, first_offset, last_offset)``. Batching is the
        paper's "message set abstraction": one index/lock round per batch.
        """
        return self._produce_batch(topic, values, keys, partition)

    def _produce_batch(
        self,
        topic: str,
        values: Sequence[bytes],
        keys: Sequence[bytes | None] | None,
        partition: int | None,
    ) -> tuple[int, int, int]:
        parts = self._partitions(topic)
        if partition is None:
            partition = default_partition(keys, len(parts), self._now_ms())
        part = parts[partition]
        m = self.metrics
        if m is None or not m.enabled:
            first, last = part.append_batch(values, keys)
            return partition, first, last
        _, h_app, c_app, _, _ = self._hot_metrics(m)
        t0 = time.perf_counter()
        first, last = part.append_batch(values, keys)
        h_app.record(time.perf_counter() - t0)
        c_app.inc(len(values))
        return partition, first, last

    # ---------------------------------------------------------------- consume
    def read(
        self,
        topic: str,
        partition: int,
        offset: int,
        max_records: int = 1024,
        isolation: str | None = None,
    ) -> RecordBatch:
        m = self.metrics
        if m is None or not m.enabled:
            return self._partition(topic, partition).read(
                offset, max_records, isolation
            )
        _, _, _, h_read, c_read = self._hot_metrics(m)
        t0 = time.perf_counter()
        batch = self._partition(topic, partition).read(
            offset, max_records, isolation
        )
        h_read.record(time.perf_counter() - t0)
        c_read.inc(len(batch))
        return batch

    def read_one(self, topic: str, partition: int, offset: int) -> Record:
        """Point read of a single record, key included (the metadata-log
        replay path: a controller deserializes one committed command).
        Raises :class:`OffsetOutOfRange` when ``offset`` is past the end
        or was compacted away."""
        part = self._partition(topic, partition)
        with part.lock:
            if part._bounded_count(offset, 1) < 1:
                raise OffsetOutOfRange(
                    f"{topic}:{partition} offset {offset} is past the end"
                )
            seg = part.segments[part._segment_for(offset)]
            if seg.offsets is not None:
                rel = bisect.bisect_left(seg.offsets, offset)
                if rel >= seg.count or seg.offsets[rel] != offset:
                    raise OffsetOutOfRange(
                        f"{topic}:{partition} offset {offset} compacted away"
                    )
            else:
                rel = offset - seg.base_offset
                if rel < 0 or rel >= seg.count:
                    raise OffsetOutOfRange(
                        f"{topic}:{partition} offset {offset} compacted away"
                    )
            return seg.record(topic, partition, rel)

    def offset_for_timestamp(
        self, topic: str, partition: int, ts_ms: int
    ) -> int | None:
        """First retained offset whose record timestamp is >= ``ts_ms``
        (Kafka's ListOffsets-by-timestamp), answered from the sparse time
        index: whole segments are skipped by their ``max_ts``, then the
        per-segment index bisects to a nearby record and a short forward
        scan finishes. Like Kafka's ``.timeindex``, out-of-order
        timestamps BEFORE the indexed position are not revisited. None
        when no retained record is that new."""
        return self._partition(topic, partition).offset_for_timestamp(ts_ms)

    def read_range(
        self, topic: str, partition: int, offset: int, length: int
    ) -> RecordBatch:
        """Read the raw offset window ``[offset, offset + length)``.

        This is the paper's §V access pattern: a control message names
        ``[topic:partition:offset:length]`` and the training job reads
        that exact slice of the distributed log. The window is counted in
        raw offsets — a control marker inside it occupies its offset but
        is (like for every consumer) not delivered, so the batch may hold
        fewer than ``length`` records; stream ranges emitted by ``ingest``
        name data records only and always deliver exactly ``length``.
        """
        batch = self.read(topic, partition, offset, length)
        covered = batch.scanned if batch.scanned is not None else len(batch)
        if covered < length:
            raise OffsetOutOfRange(
                f"{topic}:{partition} range [{offset}, {offset+length}) extends past "
                f"end {self.end_offset(topic, partition)}"
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
        return self._partition(topic, partition).log_start_offset

    def end_offset(self, topic: str, partition: int) -> int:
        return self._partition(topic, partition).end_offset

    # ------------------------------------------------------------ replication
    # Broker-to-broker primitives used by repro.core.cluster: a follower
    # fetches raw (value, key) pairs from the leader's log and re-appends
    # them locally; a deposed leader truncates to the new leader's end.
    def replica_fetch(
        self, topic: str, partition: int, offset: int, max_records: int = 4096
    ) -> tuple[
        list[bytes],
        list[bytes | None],
        list[int],
        tuple[list[int], list[int], list[int], list[int]] | None,
        list[int] | None,
        int,
        int | None,
    ]:
        """Fetch raw records for replication: ``(values, keys,
        timestamps, prods, offsets, next_offset, seg_base)``. ``offsets``
        is None for a dense window; ``next_offset`` always advances past
        the covered window, including fully-compacted gaps; ``seg_base``
        is the source segment's base (one response never spans segment
        files — feed it back to :meth:`replica_append` so the replica
        rolls its segments on the leader's boundaries)."""
        return self._partition(topic, partition).fetch_raw(offset, max_records)

    def replica_append(
        self,
        topic: str,
        partition: int,
        values: Sequence[bytes],
        keys: Sequence[bytes | None] | None,
        timestamps: Sequence[int] | int,
        prods: tuple | None = None,
        producer: tuple[int, int, int] | None = None,
        txn: bool = False,
        offsets: Sequence[int] | None = None,
        seg_base: int | None = None,
    ) -> tuple[int, int]:
        """Append records with explicit timestamps (scalar or per-record).

        Used by replication — a follower re-appends fetched leader records
        verbatim so consumers see identical ``Record.timestamp_ms`` before
        and after failover, and ``retention_ms`` (keyed to record
        timestamps in ``_enforce_retention``) expires the same records on
        every replica — and by the cluster's leader-side append, which
        stamps the batch once and pushes the same timestamps to the ISR.

        Producer metadata travels the same two ways: ``prods`` per-record
        (fetched via :meth:`replica_fetch`) or ``producer`` batch-level
        (the acks=all direct ISR push, one run-merge instead of a
        per-record loop). Either keeps the follower's dedup table in step
        with the leader's, so exactly-once survives failover.

        ``offsets`` re-appends the records at their leader-assigned
        logical offsets — required when the fetched range had compaction
        holes — and ``seg_base`` rolls local segments on the leader's
        boundaries (both see :meth:`replica_fetch`)."""
        m = self.metrics
        if m is None or not m.enabled:
            return self._partition(topic, partition).append_batch(
                values, keys, timestamps, prods=prods, producer=producer,
                txn=txn, offsets=offsets, seg_base=seg_base,
            )
        _, h_app, c_app, _, _ = self._hot_metrics(m)
        t0 = time.perf_counter()
        out = self._partition(topic, partition).append_batch(
            values, keys, timestamps, prods=prods, producer=producer,
            txn=txn, offsets=offsets, seg_base=seg_base,
        )
        h_app.record(time.perf_counter() - t0)
        c_app.inc(len(values))
        return out

    def producer_append(
        self,
        topic: str,
        partition: int,
        values: Sequence[bytes],
        keys: Sequence[bytes | None] | None,
        timestamps: Sequence[int] | int,
        pid: int,
        epoch: int,
        seq: int,
        txn: bool = False,
    ) -> tuple[int, int, bool]:
        """Leader-side idempotent append: returns ``(first, last,
        duplicate)``; a retried batch resolves to its original offsets
        with ``duplicate=True`` instead of re-appending. See
        :meth:`_Partition.idempotent_append` for the fencing/ordering
        rules. ``txn=True`` additionally marks the records transactional:
        they stay above the LSO — invisible to read_committed consumers —
        until a control marker resolves their transaction."""
        m = self.metrics
        if m is None or not m.enabled:
            return self._partition(topic, partition).idempotent_append(
                values, keys, timestamps, pid, epoch, seq, txn=txn
            )
        _, h_app, c_app, _, _ = self._hot_metrics(m)
        t0 = time.perf_counter()
        out = self._partition(topic, partition).idempotent_append(
            values, keys, timestamps, pid, epoch, seq, txn=txn
        )
        h_app.record(time.perf_counter() - t0)
        if not out[2]:  # a dedup hit appended nothing
            c_app.inc(len(values))
        return out

    def append_control(
        self, topic: str, partition: int, pid: int, epoch: int, *, abort: bool
    ) -> int | None:
        """Write a COMMIT/ABORT control marker resolving ``pid``'s open
        transaction on the partition; None when nothing is open (the
        idempotent re-drive path of coordinator recovery)."""
        return self._partition(topic, partition).append_control(
            pid, epoch, abort=abort
        )

    def last_stable_offset(self, topic: str, partition: int) -> int:
        """The partition's LSO — the read_committed visibility bound."""
        return self._partition(topic, partition).last_stable_offset()

    def stats(self) -> dict[str, int]:
        """Aggregate substrate stats: segment/retention state and
        producer-state (dedup) table size across every partition.
        Evaluated lazily by metrics gauge callbacks at snapshot time —
        never on the append hot path."""
        out = {
            "partitions": 0,
            "segments": 0,
            "size_bytes": 0,
            "retained_records": 0,
            "producer_state_entries": 0,
            "open_txns": 0,
            "producer_snapshots": 0,
            "index_entries": 0,
        }
        with self._lock:
            parts = [p for ps in self._topics.values() for p in ps]
        for part in parts:
            with part.lock:
                out["partitions"] += 1
                out["segments"] += len(part.segments)
                out["size_bytes"] += sum(s.size_bytes for s in part.segments)
                out["retained_records"] += (
                    part.end_offset - part.log_start_offset
                )
                out["producer_state_entries"] += len(part.producers)
                out["open_txns"] += len(part.txn_open)
                out["producer_snapshots"] += len(part.snapshots)
                out["index_entries"] += sum(
                    len(s.index_offsets) + len(s.index_times)
                    for s in part.segments
                )
        return out

    def open_txns(self, topic: str, partition: int) -> dict[int, int]:
        """pid -> first offset of its open transaction (test/observability
        hook)."""
        part = self._partition(topic, partition)
        with part.lock:
            return {pid: first for pid, (first, _) in part.txn_open.items()}

    def aborted_ranges(self, topic: str, partition: int) -> list[tuple[int, int, int]]:
        """(pid, first, marker_offset) aborted spans (test hook)."""
        part = self._partition(topic, partition)
        with part.lock:
            return list(part.aborted)

    def producer_state(
        self, topic: str, partition: int
    ) -> dict[int, tuple[int, int]]:
        """Snapshot of the partition's dedup table: pid -> (epoch,
        last_seq). Observability/test hook."""
        part = self._partition(topic, partition)
        with part.lock:
            return {
                pid: (st.epoch, st.last_seq)
                for pid, st in part.producers.items()
            }

    # ------------------------------------------------------------- compaction
    def compact(
        self, topic: str, partition: int, horizon: int | None = None
    ) -> dict:
        """Run the log cleaner on one partition (no-op unless its topic
        was created with ``cleanup="compact"``). Returns cleaner stats:
        ``{"horizon", "removed_records", "removed_bytes",
        "rewritten_segments"}``."""
        return self._partition(topic, partition).compact(horizon)

    def compact_to(self, topic: str, partition: int, horizon: int) -> dict:
        """Apply a leader's compact point on a replica (deterministic —
        see :meth:`_Partition.compact_to`)."""
        return self._partition(topic, partition).compact_to(horizon)

    def compact_point(self, topic: str, partition: int) -> int:
        """Everything below this offset is compacted (latest-per-key)."""
        return self._partition(topic, partition).compact_point

    def producer_snapshots(self, topic: str, partition: int) -> list[int]:
        """Offsets of the retained producer-state snapshots (test hook)."""
        part = self._partition(topic, partition)
        with part.lock:
            return [s[0] for s in part.snapshots]

    def txn_index(
        self, topic: str, partition: int
    ) -> list[list[tuple[int, int, int]]]:
        """Per-segment aborted-transaction index contents (test hook)."""
        part = self._partition(topic, partition)
        with part.lock:
            return [list(seg.txn_index) for seg in part.segments]

    def truncate_to(self, topic: str, partition: int, offset: int) -> int:
        """Discard records at ``offset`` and beyond; returns the real new
        end offset (below ``offset`` when the tail was compacted)."""
        return self._partition(topic, partition).truncate_to(offset)

    def reset_to(self, topic: str, partition: int, offset: int) -> int:
        """Restart the partition empty at ``offset`` (replica catch-up
        from below the leader's log start)."""
        return self._partition(topic, partition).reset_to(offset)

    def size_bytes(self, topic: str, partition: int | None = None) -> int:
        parts = self._partitions(topic)
        if partition is not None:
            return parts[partition].size_bytes()
        return sum(p.size_bytes() for p in parts)

    # -------------------------------------------------- consumer offset store
    def commit_offset(self, group: str, tp: TopicPartition, offset: int) -> None:
        with self._lock:
            self._committed.setdefault(group, {})[tp] = offset

    def committed_offset(self, group: str, tp: TopicPartition) -> int | None:
        with self._lock:
            return self._committed.get(group, {}).get(tp)


class StreamBackend(Protocol):
    """Structural type of a data substrate the upper layers accept.

    Both the single-broker :class:`StreamLog` and the replicated
    :class:`repro.core.cluster.BrokerCluster` satisfy it, so the pipeline
    (:mod:`repro.data.pipeline`), consumer groups
    (:mod:`repro.core.consumer`), control plane (:mod:`repro.core.control`),
    trainer and serving engine all run unchanged against either.
    """

    def ensure_topic(self, name: str, cfg: LogConfig | None = None) -> None: ...

    def create_topic(self, name: str, cfg: LogConfig | None = None) -> None: ...

    def topics(self) -> list[str]: ...

    def num_partitions(self, topic: str) -> int: ...

    def produce(
        self,
        topic: str,
        value: bytes,
        *,
        key: bytes | None = None,
        partition: int | None = None,
    ) -> tuple[int, int]: ...

    def produce_batch(
        self,
        topic: str,
        values: Sequence[bytes],
        *,
        keys: Sequence[bytes | None] | None = None,
        partition: int | None = None,
    ) -> tuple[int, int, int]: ...

    def read(
        self,
        topic: str,
        partition: int,
        offset: int,
        max_records: int = 1024,
        isolation: str | None = None,
    ) -> RecordBatch: ...

    def read_range(
        self, topic: str, partition: int, offset: int, length: int
    ) -> RecordBatch: ...

    def iter_range(
        self, topic: str, partition: int, offset: int, length: int, chunk: int = 4096
    ) -> Iterator[RecordBatch]: ...

    def start_offset(self, topic: str, partition: int) -> int: ...

    def end_offset(self, topic: str, partition: int) -> int: ...

    def commit_offset(self, group: str, tp: TopicPartition, offset: int) -> None: ...

    def committed_offset(self, group: str, tp: TopicPartition) -> int | None: ...
