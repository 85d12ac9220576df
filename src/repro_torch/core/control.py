"""Control plane — Kafka-ML control topic, control messages, control logger.

Paper §III-D: the *data* topics carry only encoded tensors; a separate
*control* topic tells deployed training jobs **when and where** a training
stream is available. A control message carries::

    deployment_id    which deployed configuration the stream targets
    topic            data topic holding the stream
    input_format     RAW | AVRO
    input_config     codec configuration (dtype/shape or schemes)
    validation_rate  fraction of the stream reserved for evaluation
    total_msg        number of messages in the stream

plus (paper §V) the exact log coordinates of the stream as a list of
``[topic:partition:offset:length]`` ranges, so a stream already in the
distributed log can be *re-used* by any later deployment by resending only
this tens-of-bytes message.

The :class:`ControlLogger` mirrors the paper's control-logger component: it
consumes every control message and records it in the registry so that
(1) streams can be replayed to new deployments, and (2) inference
deployments auto-configure their input format from the training stream's
metadata (paper §IV-E).

The control plane accepts any :class:`~repro.core.log.StreamBackend`. On a
:class:`~repro.core.cluster.BrokerCluster` the control topic is created at
the cluster's default replication factor, so control messages — and with
them the §V stream-replay capability — survive broker loss alongside the
data they describe.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Any

from repro_torch.core.log import OffsetOutOfRange, StreamBackend, TopicPartition

__all__ = [
    "CONTROL_TOPIC",
    "ControlLogger",
    "ControlMessage",
    "StreamRange",
]

CONTROL_TOPIC = "__kafka_ml_control"

_RANGE_RE = re.compile(r"^\[?([^:\[\]]+):(\d+):(\d+):(\d+)\]?$")


@dataclass(frozen=True)
class StreamRange:
    """``[topic:partition:offset:length]`` — the paper's §V coordinate format.

    Matches the TensorFlow/IO KafkaDataset connector string the paper uses,
    e.g. ``[kafka-ml:0:0:70000]`` = topic ``kafka-ml``, partition 0, offsets
    0..70000.
    """

    topic: str
    partition: int
    offset: int
    length: int

    def __str__(self) -> str:
        return f"[{self.topic}:{self.partition}:{self.offset}:{self.length}]"

    @property
    def tp(self) -> TopicPartition:
        return TopicPartition(self.topic, self.partition)

    @property
    def end(self) -> int:
        return self.offset + self.length

    @classmethod
    def parse(cls, s: str) -> "StreamRange":
        m = _RANGE_RE.match(s.strip())
        if not m:
            raise ValueError(f"bad stream range {s!r}; want [topic:partition:offset:length]")
        return cls(m.group(1), int(m.group(2)), int(m.group(3)), int(m.group(4)))


@dataclass
class ControlMessage:
    """One control-topic message (paper §III-D field list, verbatim)."""

    deployment_id: str
    topic: str
    input_format: str  # "RAW" | "AVRO"
    input_config: dict[str, Any]
    validation_rate: float
    total_msg: int
    ranges: list[StreamRange] = field(default_factory=list)

    def __post_init__(self) -> None:
        if not 0.0 <= self.validation_rate <= 1.0:
            raise ValueError(f"validation_rate {self.validation_rate} not in [0, 1]")
        if self.input_format not in ("RAW", "AVRO"):
            raise ValueError(f"unsupported input_format {self.input_format!r}")
        if self.ranges and sum(r.length for r in self.ranges) != self.total_msg:
            raise ValueError(
                f"total_msg={self.total_msg} != sum of range lengths "
                f"{sum(r.length for r in self.ranges)}"
            )

    # --------------------------------------------------------------- encoding
    def to_bytes(self) -> bytes:
        d = {
            "deployment_id": self.deployment_id,
            "topic": self.topic,
            "input_format": self.input_format,
            "input_config": self.input_config,
            "validation_rate": self.validation_rate,
            "total_msg": self.total_msg,
            "ranges": [str(r) for r in self.ranges],
        }
        return json.dumps(d, separators=(",", ":")).encode()

    @classmethod
    def from_bytes(cls, b: bytes | memoryview) -> "ControlMessage":
        d = json.loads(bytes(b).decode())
        return cls(
            deployment_id=d["deployment_id"],
            topic=d["topic"],
            input_format=d["input_format"],
            input_config=d["input_config"],
            validation_rate=float(d["validation_rate"]),
            total_msg=int(d["total_msg"]),
            ranges=[StreamRange.parse(r) for r in d.get("ranges", [])],
        )

    def retarget(self, deployment_id: str) -> "ControlMessage":
        """The §V reuse trick: same stream coordinates, new deployment."""
        return ControlMessage(
            deployment_id=deployment_id,
            topic=self.topic,
            input_format=self.input_format,
            input_config=self.input_config,
            validation_rate=self.validation_rate,
            total_msg=self.total_msg,
            ranges=list(self.ranges),
        )


def send_control(log: StreamBackend, msg: ControlMessage, producer=None) -> None:
    """Publish ``msg`` to the control topic.

    ``producer`` (an idempotent
    :class:`~repro.core.cluster.ClusterProducer`) makes the send
    exactly-once: a duplicated control message is not just log noise — a
    retry after a lost ack would re-announce the stream and re-trigger
    training on every job watching the deployment."""
    log.ensure_topic(CONTROL_TOPIC)
    if producer is not None:
        producer.send(
            CONTROL_TOPIC, msg.to_bytes(), key=msg.deployment_id.encode()
        )
    else:
        log.produce(CONTROL_TOPIC, msg.to_bytes(), key=msg.deployment_id.encode())


def poll_control(
    log: StreamBackend,
    deployment_id: str,
    from_offset: int = 0,
    isolation: str | None = None,
) -> tuple[ControlMessage | None, int]:
    """Scan the control topic for the first message targeting ``deployment_id``.

    Returns ``(msg_or_None, next_offset)`` — the training Job's
    ``readControlStreams`` loop from the paper's Algorithm 1.

    ``isolation="read_committed"`` hides control messages of uncommitted
    (or aborted) transactions — with a transactional ``ingest`` the
    stream announce becomes visible only once every record it names is
    durably committed, so a job can never train on a half-published
    stream.
    """
    log.ensure_topic(CONTROL_TOPIC)
    end = log.end_offset(CONTROL_TOPIC, 0)
    off = from_offset
    while off < end:
        batch = log.read(CONTROL_TOPIC, 0, off, 256, isolation=isolation)
        if not len(batch):
            if (batch.scanned or 0) == 0:
                # nothing visible: HW regression, or read_committed
                # blocked at the LSO by an open transaction
                break
            off = batch.next_offset  # marker-only span: skip past it
            continue
        for i, v in enumerate(batch.values):
            msg = ControlMessage.from_bytes(v)
            if msg.deployment_id == deployment_id:
                if batch.offsets is not None:
                    return msg, batch.offsets[i] + 1
                return msg, batch.first_offset + i + 1
        off = batch.next_offset
    return None, off


class ControlLogger:
    """Paper §IV-E: consumes control messages into the back-end registry.

    Keeps every control message ever seen so that (a) the Web-UI/API can
    list historical streams and replay them to new deployments, and (b)
    inference deployments inherit ``input_format``/``input_config`` from the
    stream their model was trained on.
    """

    def __init__(self, log: StreamBackend, isolation: str | None = None):
        self._log = log
        self._isolation = isolation
        self._next_offset = 0
        self._history: list[ControlMessage] = []

    def poll(self) -> list[ControlMessage]:
        self._log.ensure_topic(CONTROL_TOPIC)
        end = self._log.end_offset(CONTROL_TOPIC, 0)
        fresh: list[ControlMessage] = []
        while self._next_offset < end:
            batch = self._log.read(
                CONTROL_TOPIC, 0, self._next_offset, 256,
                isolation=self._isolation,
            )
            if not len(batch):
                if (batch.scanned or 0) == 0:
                    break  # HW regression or LSO-blocked open transaction
                self._next_offset = batch.next_offset
                continue
            fresh.extend(ControlMessage.from_bytes(v) for v in batch.values)
            self._next_offset = batch.next_offset
        self._history.extend(fresh)
        return fresh

    @property
    def history(self) -> list[ControlMessage]:
        self.poll()
        return list(self._history)

    def latest_for(self, deployment_id: str) -> ControlMessage | None:
        self.poll()
        for msg in reversed(self._history):
            if msg.deployment_id == deployment_id:
                return msg
        return None

    def _stream_committed(self, msg: ControlMessage) -> bool:
        """Whether every record ``msg`` names is visible at
        ``read_committed`` — i.e. the stream's ingest transaction (if
        any) durably committed.

        ``ingest`` emits only offset-contiguous ranges, so a range is
        committed iff exactly ``length`` records of ``[offset, end)``
        survive a read_committed scan: an aborted transaction's records
        are filtered out of such a read (count comes up short) and an
        *open* transaction blocks it at the LSO (no progress). Ranges
        that cannot be inspected at all (topic unknown to this backend,
        offsets already retention-expired) are skipped rather than
        failed: §V stream reuse is a metadata operation and replaying a
        coordinates-only announce predates this check — only a
        *provable* isolation violation vetoes the replay.
        """
        for r in msg.ranges:
            seen = 0
            off = r.offset
            while off < r.end:
                try:
                    batch = self._log.read(
                        r.topic, r.partition, off, r.end - off,
                        isolation="read_committed",
                    )
                except (KeyError, IndexError, OffsetOutOfRange):
                    seen = r.length  # uninspectable, not provably aborted
                    break
                if not len(batch) and (batch.scanned or 0) == 0:
                    return False  # LSO-blocked: transaction still open
                if batch.offsets is not None:
                    seen += sum(
                        1 for o in batch.offsets if r.offset <= o < r.end
                    )
                else:
                    seen += sum(
                        1 for i in range(len(batch))
                        if r.offset <= batch.first_offset + i < r.end
                    )
                if batch.next_offset <= off:
                    return False  # no progress: nothing visible here
                off = batch.next_offset
            if seen != r.length:
                return False  # aborted records were filtered out
        return True

    def replay(self, msg: ControlMessage, new_deployment_id: str) -> ControlMessage:
        """Re-send an historical stream to another deployment (§V, Fig. 8).

        Honors transactional isolation regardless of the logger's own
        isolation level: a logger polling at default isolation can hold
        an announce from an *aborted* transactional ingest in its
        history, and replaying it would hand a new deployment stream
        coordinates whose records no committed reader can see (a
        read_committed trainer hangs waiting for data that is filtered
        forever). Every range is therefore re-verified at
        ``read_committed`` before the announce is re-sent; replaying an
        aborted or still-open stream raises ``ValueError``.
        """
        if not self._stream_committed(msg):
            raise ValueError(
                f"cannot replay stream for deployment {msg.deployment_id!r}: "
                "its records are not fully visible at read_committed "
                "(aborted or still-open ingest transaction)"
            )
        retargeted = msg.retarget(new_deployment_id)
        send_control(self._log, retargeted)
        return retargeted
