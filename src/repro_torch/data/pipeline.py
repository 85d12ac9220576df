"""Log -> device data pipeline (port of ``repro.data.pipeline``).

The producer side (:func:`ingest`), the consumer side
(:class:`StreamDataset`, :class:`StreamingBatchIterator`,
:class:`BatchIterator`), the exactly-once read-process-write stage
(:class:`TransactionalProcessor`) and the bounded background prefetch
(:class:`PrefetchIterator`, :func:`prefetch_iter`) are the JAX package's
own definitions, copied verbatim: none of them touches a device, and
``tests/test_torch_copies.py`` holds each to its original.

:func:`device_feed` is rewritten for the card. The mesh placement
(``ShardedFeeder``) is not ported: it belongs to the multi-GPU work.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Iterator, Mapping, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.cluster import (
    BrokerCluster,
    ClusterConsumer,
    ClusterError,
    ClusterProducer,
    InvalidTxnState,
)
from repro_torch.core.control import ControlMessage, StreamRange, send_control
from repro_torch.core.log import LogConfig, StreamBackend, TopicPartition
from repro_torch.core.metrics import default_registry
from repro_torch.data.formats import AvroCodec, RawCodec, codec_from_control

__all__ = [
    "BatchIterator",
    "PrefetchIterator",
    "ShortStreamError",
    "StreamDataset",
    "StreamingBatchIterator",
    "TransactionalProcessor",
    "device_feed",
    "ingest",
    "prefetch_iter",
]


class ShortStreamError(ValueError):
    """The stream (or split) holds fewer records than one batch.

    Raised by :class:`BatchIterator` / :class:`StreamingBatchIterator`
    when ``n < batch_size`` — with drop-remainder batching such a source
    would silently yield *zero* batches, so it fails loudly instead.
    Actionable fixes: lower ``batch_size``, ingest more records, or (for
    the eval split) lower ``validation_rate``. Subclasses ``ValueError``
    for backward compatibility with callers that caught the old untyped
    error.
    """

    def __init__(self, n: int, batch_size: int, *, split: str | None = None):
        what = f"{split} split" if split else "dataset"
        super().__init__(
            f"{what} of {n} records < batch_size {batch_size}: "
            f"drop-remainder batching would yield no batches "
            f"(lower batch_size, ingest more records"
            + (", or lower validation_rate)" if split == "eval" else ")")
        )
        self.n = n
        self.batch_size = batch_size


# ------------------------------------------------------------------ prefetch
class PrefetchIterator:
    """Bounded background prefetch over any iterator.

    A worker thread drains ``it`` into a ``depth``-bounded queue; consuming
    this iterator pops from the queue, so producing item ``i+1`` overlaps
    consuming item ``i`` (log reads / host decode overlap device steps).
    Worker exceptions re-raise at the consumer's ``next()`` — a failed
    source never silently truncates the stream. ``close()`` stops the
    worker even if it is blocked on a full queue (e.g. the consumer
    abandoned an infinite stream mid-epoch); abandoning the iterator
    without close() also stops it, via the garbage collector — the pump
    is a staticmethod sharing only the queue/event/error box, never
    ``self``, so a running worker does not pin the iterator alive.
    """

    _DONE = object()

    def __init__(self, it: Iterator[Any], depth: int = 2,
                 name: str = "prefetch"):
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._errbox: list[BaseException] = []
        self._finished = False
        self._closed = False
        # source failures re-raise at the consumer, but are also counted
        # (daemon_errors{daemon=...}) so chaos runs can assert zero
        # unexpected background errors without re-driving every stream
        errors = default_registry().counter("daemon_errors_total", daemon=name)
        self._thread = threading.Thread(
            target=self._pump,
            args=(iter(it), self._queue, self._stop, self._errbox, self._DONE,
                  errors),
            name=f"prefetch:{name}",
            daemon=True,
        )
        self._thread.start()

    @staticmethod
    def _pump(
        it: Iterator[Any],
        q: "queue.Queue",
        stop: threading.Event,
        errbox: list[BaseException],
        done: Any,
        errors: Any,
    ) -> None:
        def put(item: Any) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        try:
            for item in it:
                if not put(item):
                    return
        except BaseException as e:  # propagated to the consumer
            errors.inc()
            errbox.append(e)
        put(done)

    def __iter__(self) -> "PrefetchIterator":
        return self

    def __next__(self) -> Any:
        # terminal states (source exhausted, error already delivered, or
        # close()d) keep raising StopIteration instead of blocking on a
        # queue no live worker will ever feed again
        while not self._finished:
            try:
                item = self._queue.get(timeout=0.05)
            except queue.Empty:
                if self._stop.is_set():
                    self._finished = True
                elif not self._thread.is_alive() and self._queue.empty():
                    # a dead worker can't put again, so empty() is stable:
                    # anything it produced before exiting (including the
                    # _DONE sentinel carrying an error) was already drained
                    self._finished = True
            else:
                if item is not self._DONE:
                    return item
                self._finished = True
                if self._errbox:
                    raise self._errbox.pop()
        raise StopIteration

    def close(self, timeout: float = 5.0) -> None:
        """Stop the worker deterministically (idempotent): signal stop,
        unblock a worker stuck on a full queue, and join with a timeout
        — after close() returns no pump thread of this iterator is
        running (or it is reported leaked by the witness teardown)."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._finished = True
        while True:  # unblock a worker stuck on put()
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout)

    def __del__(self):  # abandoned without close(): full deterministic stop
        try:
            self.close(timeout=1.0)
        except Exception:
            pass


def prefetch_iter(it: Iterator[Any], depth: int,
                  name: str = "prefetch") -> Iterator[Any]:
    """Wrap ``it`` with a bounded background prefetch; ``depth <= 0`` is
    a no-op passthrough (fully synchronous iteration)."""
    if depth <= 0:
        return iter(it)
    return PrefetchIterator(it, depth, name=name)


# --------------------------------------------------------------------- ingest
def ingest(
    log: StreamBackend,
    topic: str,
    codec: RawCodec | AvroCodec,
    arrays: Mapping[str, np.ndarray],
    deployment_id: str,
    *,
    validation_rate: float = 0.0,
    partition: int | None = None,
    message_set_size: int = 1024,
    num_threads: int = 1,
    idempotent: bool = False,
    transactional: bool = False,
    send_control_message: bool = True,
) -> ControlMessage:
    """Producer library: encode + stream a dataset, then announce it.

    Returns the control message (already sent to the control topic unless
    ``send_control_message=False``). The data lives only in the log —
    no file system (paper contribution #2).

    ``num_threads > 1`` splits the encoded dataset into contiguous shards
    and streams them from producer threads in parallel, each to its own
    partition (``shard i -> partition i``) — on a cluster the appends
    land on distinct partition locks and don't contend. Shard ranges are
    emitted in shard order, so reading the control message back
    reconstructs the original record order (the ``validation_rate`` tail
    split is unchanged). The thread count is capped at the partition
    count, and a pinned ``partition=`` forces single-threaded streaming:
    threads sharing one partition would serialize on its lock anyway
    while interleaving their chunks, fragmenting the range list the
    control message carries.

    ``idempotent=True`` (clusters only; a bare in-process ``StreamLog``
    has no retry loop to dedup) streams through per-thread idempotent
    :class:`~repro.core.cluster.ClusterProducer` instances and sends the
    control message through one of them, so a retried append — a leader
    died after committing but before acking — cannot re-enter the
    training stream as a duplicate record, and the emitted ranges always
    name each record's single, original offset (paper §V: every retry
    duplicate is a *training-data* duplicate).

    ``transactional=True`` (clusters only) goes one further: the whole
    stream — every data record AND its control-message announce — is one
    transaction. A ``read_committed`` training job therefore observes
    either the complete stream or nothing: a crash mid-ingest aborts,
    leaving no partial stream and no dangling announce to train on.
    Transactions are single-producer, so the stream runs on one thread
    (``num_threads`` is ignored) under ``transactional.id``
    ``ingest-<deployment_id>``; re-running the ingest fences — and
    aborts — a crashed predecessor's unfinished transaction.
    """
    if transactional and not hasattr(log, "init_producer"):
        # never degrade silently: the caller asked for an all-or-nothing
        # publish a bare StreamLog cannot provide
        raise ValueError(
            "ingest(transactional=True) requires a BrokerCluster backend "
            "(transactions live in the cluster coordinator)"
        )
    log.ensure_topic(topic)
    encoded = codec.encode_batch(arrays)
    total = len(encoded)
    use_txn = transactional
    use_idem = (idempotent or use_txn) and hasattr(log, "init_producer")

    # ingest throughput metrics (no-op on backends without a registry)
    _m = getattr(log, "metrics", None)
    _instrument = _m is not None and _m.enabled
    _t0 = time.perf_counter() if _instrument else 0.0

    def _done(msg: ControlMessage) -> ControlMessage:
        if _instrument:
            dt = time.perf_counter() - _t0
            _m.counter("ingest_records_total", topic=topic).inc(total)
            _m.histogram("ingest_seconds").record(dt)
            if dt > 0:
                _m.gauge("ingest_records_per_s", topic=topic).set(total / dt)
        return msg

    def produce_span(
        span: Sequence[bytes],
        part: int | None,
        producer: "ClusterProducer | None" = None,
    ) -> tuple[list[StreamRange], "ClusterProducer | None"]:
        if producer is None and use_idem:
            producer = ClusterProducer(log, idempotent=True)
        append = producer.send_batch if producer is not None else (
            lambda t, chunk, partition: log.produce_batch(
                t, chunk, partition=partition
            )
        )
        out: list[StreamRange] = []
        cur: tuple[int, int, int] | None = None  # (partition, first, last)
        i = 0
        while i < len(span):
            chunk = span[i : i + message_set_size]
            p, first, last = append(topic, chunk, partition=part)
            if cur is not None and cur[0] == p and first == cur[2] + 1:
                cur = (p, cur[1], last)
            else:
                if cur is not None:
                    out.append(
                        StreamRange(topic, cur[0], cur[1], cur[2] - cur[1] + 1)
                    )
                cur = (p, first, last)
            # stick to the chosen partition for the rest of the span so the
            # range list stays compact (Kafka sticky partitioner)
            part = p
            i += message_set_size
        if cur is not None:
            out.append(StreamRange(topic, cur[0], cur[1], cur[2] - cur[1] + 1))
        return out, producer

    if use_txn:
        # one transaction = one producer: the data records and the
        # control-message announce commit (or abort) together
        producer = ClusterProducer(
            log, transactional_id=f"ingest-{deployment_id}"
        )
        producer.begin_txn()
        try:
            ranges, _ = produce_span(encoded, partition, producer)
            msg = ControlMessage(
                deployment_id=deployment_id,
                topic=topic,
                input_format=codec.FORMAT,
                input_config=codec.input_config(),
                validation_rate=validation_rate,
                total_msg=total,
                ranges=ranges,
            )
            if send_control_message:
                send_control(log, msg, producer=producer)
            producer.commit_txn()
        except BaseException:
            try:
                producer.abort_txn()
            except Exception:
                pass  # outcome resolves via coordinator recovery
            raise
        return _done(msg)

    num_threads = max(1, min(num_threads, total or 1))
    if partition is not None:
        num_threads = 1  # one partition serializes appends anyway
    else:
        num_threads = min(num_threads, log.num_partitions(topic))
    if num_threads == 1:
        ranges, control_producer = produce_span(encoded, partition)
    else:
        per = -(-total // num_threads)  # ceil: contiguous, balanced shards
        spans = [encoded[i : i + per] for i in range(0, total, per)]
        with ThreadPoolExecutor(
            max_workers=len(spans), thread_name_prefix="ingest"
        ) as pool:
            futs = [
                pool.submit(produce_span, span, i)
                for i, span in enumerate(spans)
            ]
            results = [f.result() for f in futs]
        # shard order == original record order (shards are contiguous)
        ranges = [r for rs, _ in results for r in rs]
        control_producer = results[0][1]

    msg = ControlMessage(
        deployment_id=deployment_id,
        topic=topic,
        input_format=codec.FORMAT,
        input_config=codec.input_config(),
        validation_rate=validation_rate,
        total_msg=total,
        ranges=ranges,
    )
    if send_control_message:
        # the announce rides the same exactly-once path as the data: a
        # duplicated control message would re-trigger training
        send_control(log, msg, producer=control_producer)
    return _done(msg)


# ------------------------------------------------- transactional transform
class TransactionalProcessor:
    """Exactly-once read-process-write: consume a topic, transform each
    record with ``fn``, produce the results — input offsets and output
    records committed in ONE transaction (Kafka Streams' exactly-once
    processing mode, DESIGN.md §8).

    Each cycle is atomic: either the transformed records land on the
    output topic AND the input offsets advance, or neither happens. A
    crash anywhere inside a cycle — including between "produce output"
    and "commit offsets", the window where a plain at-least-once
    processor duplicates (produce-first) or drops (commit-first) a step —
    aborts or completes via coordinator recovery, and the re-run resumes
    from the committed offsets with the aborted outputs invisible to
    ``read_committed`` consumers downstream.

    The input is read ``read_committed`` too, so chained processors
    compose into an end-to-end exactly-once pipeline. Zombie fencing
    comes from the transactional id: a re-created processor with the same
    id bumps the producer epoch, and the predecessor's unfinished
    transaction is aborted, its late appends fenced.
    """

    def __init__(
        self,
        cluster: BrokerCluster,
        transactional_id: str,
        input_topic: str,
        output_topic: str,
        fn,
        *,
        group_id: str | None = None,
        max_records: int = 256,
    ):
        self.cluster = cluster
        self.input_topic = input_topic
        self.output_topic = output_topic
        self.fn = fn
        self.group_id = group_id or f"txn-{transactional_id}"
        self.max_records = max_records
        # output mirrors the input's partitioning (partition p in → p out,
        # so per-partition record order is preserved through the stage)
        cluster.ensure_topic(output_topic, LogConfig(
            num_partitions=cluster.num_partitions(input_topic)
        ))
        self.producer = ClusterProducer(
            cluster, transactional_id=transactional_id
        )
        self.consumer = ClusterConsumer(
            cluster, group_id=self.group_id, isolation_level="read_committed"
        )

    def _position(self, tp: TopicPartition) -> int:
        off = self.consumer.committed(tp)
        if off is None:
            off = self.cluster.start_offset(tp.topic, tp.partition)
        return off

    def process_once(self) -> int:
        """One atomic cycle over every input partition; returns the
        number of input offsets consumed (0 = caught up — includes
        filtered control markers and aborted records, so progress never
        reads as zero while the input still advances)."""
        if self.producer.in_txn:
            # a previous cycle died with its abort unresolved (quorum
            # outage): retry the abort now; InvalidTxnState means the
            # outcome is already decided and is resolved just below
            try:
                self.producer.abort_txn()
            except InvalidTxnState:
                pass
        st = self.cluster.txn_state(self.producer.producer_id)
        if st in ("prepare_commit", "prepare_abort"):
            # a predecessor's outcome is durably decided but its offsets
            # may not be applied yet — finish it BEFORE reading committed
            # positions, or this cycle would re-fetch (and re-produce)
            # the very batch a prepared commit covers. resolve_txn runs
            # at the transaction's own recorded epoch, so this also
            # covers a RESTARTED processor whose producer epoch already
            # moved past the transaction it inherited.
            self.cluster.resolve_txn(self.producer.producer_id)
        in_txn = False
        done = 0
        offsets: dict[TopicPartition, int] = {}
        try:
            for p in range(self.cluster.num_partitions(self.input_topic)):
                tp = TopicPartition(self.input_topic, p)
                pos = self._position(tp)
                batch = self.consumer.fetch(
                    self.input_topic, p, pos, self.max_records
                )
                if len(batch) == 0 and (batch.scanned or 0) == 0:
                    continue
                if not in_txn:
                    self.producer.begin_txn()
                    in_txn = True
                if len(batch):
                    outs = [self.fn(bytes(v)) for v in batch.values]
                    self.producer.send_batch(
                        self.output_topic, outs, partition=p
                    )
                # progress is measured in *consumed* input offsets, not
                # delivered records: a window holding only an aborted
                # transaction's records (filtered out) still advances,
                # so run_to_end keeps draining past it
                done += batch.next_offset - pos
                offsets[tp] = batch.next_offset
            if in_txn:
                # one AddOffsetsToTxn for the whole cycle (one quorum
                # round-trip), not one per partition
                self.producer.send_offsets_to_txn(self.group_id, offsets)
                self.producer.commit_txn()
        except BaseException:
            if in_txn:
                try:
                    self.producer.abort_txn()
                except Exception:
                    # a prepared commit cannot be aborted (its outcome is
                    # durably decided: InvalidTxnState) and a quorum
                    # outage resolves via coordinator recovery — either
                    # way the re-run resumes from the recovered offsets
                    pass
            raise
        return done

    def run_to_end(self, max_cycles: int = 1000) -> int:
        """Drain the input: cycles until one processes nothing."""
        total = 0
        for _ in range(max_cycles):
            got = self.process_once()
            if got == 0:
                return total
            total += got
        return total


# -------------------------------------------------------------- StreamDataset
class StreamDataset:
    """Materialize the stream a control message points at (Algorithm 1).

    ``read()`` decodes every range; ``split()`` applies ``validation_rate``
    — the paper trains on the leading ``1 - rate`` fraction and evaluates on
    the tail.
    """

    def __init__(self, log: StreamBackend, msg: ControlMessage):
        self.log = log
        self.msg = msg
        self.codec = codec_from_control(msg.input_format, msg.input_config)

    def read(self) -> dict[str, np.ndarray]:
        mats = []
        for r in self.msg.ranges:
            for batch in self.log.iter_range(r.topic, r.partition, r.offset, r.length):
                mats.append(batch.to_matrix())
        if not mats:
            return {f.name: np.zeros((0,) + f.shape, f.dtype) for f in self.codec.fields}
        mat = np.concatenate(mats, axis=0)
        return self.codec.decode_matrix(mat)

    def split(self) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
        full = self.read()
        n = self.msg.total_msg
        n_train = n - int(round(n * self.msg.validation_rate))
        train = {k: v[:n_train] for k, v in full.items()}
        evald = {k: v[n_train:] for k, v in full.items()}
        return train, evald

    def stream(
        self,
        batch_size: int,
        *,
        split: str = "train",
        epochs: int | None = 1,
        fetch_records: int = 4096,
        prefetch: int = 0,
    ) -> "StreamingBatchIterator":
        """Streaming (bounded-memory) counterpart of ``split()`` +
        :class:`BatchIterator`; see :class:`StreamingBatchIterator`."""
        return StreamingBatchIterator(
            self.log,
            self.msg,
            batch_size,
            split=split,
            epochs=epochs,
            fetch_records=fetch_records,
            prefetch=prefetch,
        )


def _window_ranges(
    ranges: Sequence[StreamRange], start: int, count: int
) -> list[StreamRange]:
    """Sub-ranges covering records ``[start, start + count)`` of the
    concatenated range list — the record-index → log-offset arithmetic
    behind splits and fast-forward (ranges emitted by ``ingest`` name
    data records only, so record index maps 1:1 onto raw offsets)."""
    out: list[StreamRange] = []
    pos = 0
    end = start + count
    for r in ranges:
        lo = max(start, pos)
        hi = min(end, pos + r.length)
        if lo < hi:
            out.append(
                StreamRange(r.topic, r.partition, r.offset + (lo - pos), hi - lo)
            )
        pos += r.length
    return out


# ----------------------------------------------------- StreamingBatchIterator
class StreamingBatchIterator:
    """Minibatches straight off the stream, with bounded host memory.

    The materialized path (``StreamDataset.read()`` → ``BatchIterator``)
    concatenates the *entire* stream on the host before the first record
    reaches a device. This iterator instead polls the consumer
    incrementally — ``fetch_records`` records per poll via
    ``log.iter_range`` (on a cluster that is the leader-routed,
    failover-retrying fetch path) — zero-copy decodes each fetched batch
    (:meth:`~repro.data.formats._PackedCodec.decode_frames`), and
    assembles drop-remainder batches of ``batch_size``. Peak host
    footprint is O(``fetch_records`` + ``batch_size``) records, not
    O(stream).

    **Determinism** (the checkpoint/resume contract): batches are emitted
    in range order — exactly the record order ``StreamDataset.read()``
    materializes — so the sequence is byte-identical to
    ``BatchIterator(shuffle=False)`` over the same split, epoch after
    epoch. ``fast_forward(k)`` therefore needs no reads at all: it is
    pure offset arithmetic, and resume after ``k`` steps re-polls only
    from the k-th batch's position onward.

    **Batch assembly is copy-light**: a batch that falls inside one
    fetched chunk is a pure row-slice view of the decoded (itself
    zero-copy) chunk; only a batch straddling a chunk boundary pays one
    per-field concatenate of ``batch_size`` rows. There is never a
    stream-sized concatenate.

    ``split`` selects the paper's take/split window: ``"train"`` = the
    leading ``1 - validation_rate`` fraction, ``"eval"`` = the tail,
    ``"all"`` = everything (serving replay). ``epochs=None`` streams
    forever (re-polling the log each epoch — stream reuse, paper §V).
    """

    def __init__(
        self,
        log: StreamBackend,
        msg: ControlMessage,
        batch_size: int,
        *,
        split: str = "train",
        epochs: int | None = 1,
        fetch_records: int = 4096,
        prefetch: int = 0,
    ):
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        if fetch_records <= 0:
            raise ValueError(f"fetch_records must be positive, got {fetch_records}")
        total = msg.total_msg
        # same rounding as StreamDataset.split(): train = leading n_train
        n_eval = int(round(total * msg.validation_rate))
        n_train = total - n_eval
        windows = {"train": (0, n_train), "eval": (n_train, n_eval), "all": (0, total)}
        if split not in windows:
            raise ValueError(f"split must be one of {sorted(windows)}, got {split!r}")
        start, count = windows[split]
        if count < batch_size:
            raise ShortStreamError(count, batch_size, split=split)
        self.log = log
        self.msg = msg
        self.codec = codec_from_control(msg.input_format, msg.input_config)
        self.batch_size = batch_size
        self.split_name = split
        self.n = count
        self.epochs = epochs
        self.fetch_records = fetch_records
        self.prefetch = prefetch
        self._ranges = _window_ranges(msg.ranges, start, count)
        self._skip = 0
        self._prefetchers: list[PrefetchIterator] = []

    def steps_per_epoch(self) -> int:
        return self.n // self.batch_size

    def fast_forward(self, n_batches: int) -> None:
        """Skip the first ``n_batches`` of the sequence without reading
        them — pure arithmetic (checkpoint resume at step k re-polls the
        log only from batch k's record position onward). Cumulative
        across calls; applies to the next ``iter()``."""
        if n_batches < 0:
            raise ValueError(f"n_batches must be >= 0, got {n_batches}")
        self._skip += n_batches

    # ------------------------------------------------------------- internals
    def _chunks(
        self, skip_records: int, count: int
    ) -> Iterator[dict[str, np.ndarray]]:
        """Poll + decode records ``[skip_records, skip_records + count)``
        of this split's window, one bounded fetch at a time."""
        for r in _window_ranges(self._ranges, skip_records, count):
            for batch in self.log.iter_range(
                r.topic, r.partition, r.offset, r.length, chunk=self.fetch_records
            ):
                yield self.codec.decode_frames(batch)

    def _epoch(self, start_batch: int) -> Iterator[dict[str, np.ndarray]]:
        bs = self.batch_size
        usable = self.steps_per_epoch() * bs  # drop-remainder tail never read
        skip = start_batch * bs
        parts: list[dict[str, np.ndarray]] = []  # decoded, not-yet-emitted
        head = 0  # rows of parts[0] already emitted
        avail = 0  # unemitted rows buffered across parts
        for chunk in self._chunks(skip, usable - skip):
            rows = next(iter(chunk.values())).shape[0]
            if rows == 0:
                continue
            parts.append(chunk)
            avail += rows
            while avail >= bs:
                first = parts[0]
                first_rows = next(iter(first.values())).shape[0]
                if first_rows - head >= bs:
                    # common case: the batch is a pure view into one chunk
                    batch = {k: v[head : head + bs] for k, v in first.items()}
                    head += bs
                else:
                    # chunk-boundary batch: one batch_size-row concat
                    need, pieces = bs, []
                    while need:
                        cur = parts[0]
                        cur_rows = next(iter(cur.values())).shape[0]
                        take = min(need, cur_rows - head)
                        pieces.append(
                            {k: v[head : head + take] for k, v in cur.items()}
                        )
                        head += take
                        need -= take
                        if head == cur_rows:
                            parts.pop(0)
                            head = 0
                    batch = {
                        k: np.concatenate([p[k] for p in pieces], axis=0)
                        for k in pieces[0]
                    }
                if parts and head == next(iter(parts[0].values())).shape[0]:
                    parts.pop(0)
                    head = 0
                avail -= bs
                yield batch

    def _batches(self) -> Iterator[dict[str, np.ndarray]]:
        skip = self._skip
        spe = self.steps_per_epoch()
        epoch = 0
        while self.epochs is None or epoch < self.epochs:
            if skip >= spe:
                skip -= spe  # whole epoch fast-forwarded: zero reads
            else:
                yield from self._epoch(skip)
                skip = 0
            epoch += 1

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        it = prefetch_iter(self._batches(), self.prefetch, name="stream-batch")
        if isinstance(it, PrefetchIterator):
            # deterministic shutdown: close() (or GC of this iterator)
            # joins every pump thread this object spawned, so witness
            # teardown never sees leaked prefetch workers
            self._prefetchers = [p for p in self._prefetchers
                                 if p._thread.is_alive()]
            self._prefetchers.append(it)
        return it

    def close(self, timeout: float = 5.0) -> None:
        """Stop any background prefetch workers spawned by iteration."""
        prefetchers, self._prefetchers = self._prefetchers, []
        for p in prefetchers:
            p.close(timeout)

    def __del__(self):
        try:
            self.close(timeout=1.0)
        except Exception:
            pass


# -------------------------------------------------------------- BatchIterator
class BatchIterator:
    """Shuffled, epoch'd minibatches over host arrays (drop-remainder).

    ``prefetch=k`` assembles up to ``k`` batches ahead on a background
    thread (bounded queue), overlapping the gather/copy work with the
    consumer's device steps. The batch *sequence* is identical either way
    — prefetch changes when batches are built, not which or in what order
    — so checkpoint/resume fast-forwarding stays deterministic.

    A source shorter than one batch raises :class:`ShortStreamError`
    (drop-remainder batching would otherwise silently yield nothing).

    ``arrays`` may also be a :class:`StreamingBatchIterator`: iteration
    then delegates to the streaming source (which must be constructed
    with the same ``batch_size``; ``shuffle`` must be False — a stream
    is strictly sequential, and global shuffle would require exactly the
    full materialization streaming exists to avoid). The stream's own
    ``epochs``/``prefetch`` configuration governs delegated iteration.
    """

    def __init__(
        self,
        arrays: "Mapping[str, np.ndarray] | StreamingBatchIterator",
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        epochs: int | None = None,
        prefetch: int = 0,
    ):
        self._stream: StreamingBatchIterator | None = None
        self._prefetchers: list[PrefetchIterator] = []
        if isinstance(arrays, StreamingBatchIterator):
            if shuffle:
                raise ValueError(
                    "a streaming source is strictly sequential: pass "
                    "shuffle=False (global shuffle requires materializing "
                    "the stream — use StreamDataset.read())"
                )
            if batch_size != arrays.batch_size:
                raise ValueError(
                    f"batch_size {batch_size} != streaming source's "
                    f"{arrays.batch_size}"
                )
            self._stream = arrays
            self.n = arrays.n
            self.arrays = {}
            self.batch_size = batch_size
            self.shuffle = False
            self.rng = np.random.default_rng(seed)
            self.epochs = arrays.epochs
            self.prefetch = 0  # the stream applies its own prefetch
            return
        sizes = {v.shape[0] for v in arrays.values()}
        if len(sizes) != 1:
            raise ValueError(f"ragged field sizes {sizes}")
        self.n = sizes.pop()
        if self.n < batch_size:
            raise ShortStreamError(self.n, batch_size)
        self.arrays = dict(arrays)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.epochs = epochs
        self.prefetch = prefetch

    def _epochs(self) -> Iterator[dict[str, np.ndarray]]:
        epoch = 0
        while self.epochs is None or epoch < self.epochs:
            idx = (
                self.rng.permutation(self.n) if self.shuffle else np.arange(self.n)
            )
            for s in range(0, self.n - self.batch_size + 1, self.batch_size):
                sel = idx[s : s + self.batch_size]
                yield {k: v[sel] for k, v in self.arrays.items()}
            epoch += 1

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        if self._stream is not None:
            return iter(self._stream)
        it = prefetch_iter(self._epochs(), self.prefetch, name="batch")
        if isinstance(it, PrefetchIterator):
            self._prefetchers = [p for p in self._prefetchers
                                 if p._thread.is_alive()]
            self._prefetchers.append(it)
        return it

    def close(self, timeout: float = 5.0) -> None:
        """Stop background prefetch workers (and a delegated stream's)."""
        prefetchers, self._prefetchers = self._prefetchers, []
        for p in prefetchers:
            p.close(timeout)
        if self._stream is not None:
            self._stream.close(timeout)

    def __del__(self):
        try:
            self.close(timeout=1.0)
        except Exception:
            pass

    def steps_per_epoch(self) -> int:
        return self.n // self.batch_size


# ----------------------------------------------------------------- device_feed
class _CudaFeed:
    """The caller's side of :func:`device_feed` on the card: each batch's
    copies were issued on a copy stream, and before a batch is handed out
    the caller's current stream waits on that copy's event and takes the
    tensors over (``record_stream``), so the caching allocator cannot
    reuse their memory while the copy stream or the caller still runs."""

    def __init__(self, placed: Iterator[tuple[dict, torch.cuda.Event]], device: torch.device):
        self._placed = placed
        self._device = device

    def __iter__(self) -> "_CudaFeed":
        return self

    def __next__(self) -> dict[str, torch.Tensor]:
        batch, ready = next(self._placed)
        stream = torch.cuda.current_stream(self._device)
        stream.wait_event(ready)
        for t in batch.values():
            t.record_stream(stream)
        return batch

    def close(self, timeout: float = 5.0) -> None:
        if isinstance(self._placed, PrefetchIterator):
            self._placed.close(timeout)
        else:  # depth <= 0: a plain generator
            self._placed.close()


def device_feed(
    it: Iterator[Mapping[str, np.ndarray]],
    *,
    device: str | torch.device | None = None,
    depth: int = 2,
) -> Iterator[dict[str, torch.Tensor]]:
    """Double-buffered device placement (DESIGN.md §10), on the card.

    Wraps a host-batch iterator so that the copy of batch ``i+1`` to the
    device (and, transitively, the consumer poll + zero-copy decode
    feeding it) is issued on a background thread while the caller's
    device step consumes batch ``i``. Each array goes through a pinned
    host buffer and is copied on a CUDA stream of its own; the caller's
    stream waits on that copy's event when the batch is handed out.
    ``depth=2`` is classic double buffering; ``depth <= 0`` is the serial
    path (placement on the caller's thread). ``device`` defaults to the
    card; ``device="cpu"`` hands out CPU tensors (no streams).

    The returned iterator has ``close()``: call it when abandoning an
    infinite stream mid-epoch.
    """
    dev = resolve_device(device)
    if dev.type != "cuda":
        # a copy: the decoded arrays may be read-only views of the log's buffers
        placed_cpu = ({k: torch.tensor(v) for k, v in b.items()} for b in it)
        return prefetch_iter(placed_cpu, depth, name="device_feed")
    copy_stream = torch.cuda.Stream(dev)

    def place(b: Mapping[str, np.ndarray]) -> tuple[dict, torch.cuda.Event]:
        with torch.cuda.device(dev), torch.cuda.stream(copy_stream):
            out = {
                k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(dev, non_blocking=True)
                for k, v in b.items()
            }
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        return out, ready

    return _CudaFeed(prefetch_iter((place(b) for b in it), depth, name="device_feed"), dev)
