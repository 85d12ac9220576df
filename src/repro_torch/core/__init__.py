"""Stream substrate the port needs: verbatim copies of ``repro.core``'s
log, metrics, quorum controller, replicated cluster and consumer groups
(only their import lines name ``repro_torch``)."""

from repro_torch.core.cluster import (
    METRICS_TOPIC,
    Broker,
    BrokerCluster,
    BrokerUnavailable,
    ClusterConsumer,
    ClusterError,
    ClusterProducer,
    InvalidTxnState,
    MetricsReporter,
    NotEnoughReplicasError,
    NotLeaderError,
    PartitionMeta,
    PartitionOffline,
    ReplicationService,
)
from repro_torch.core.consumer import (
    ConsumerGroup,
    GroupConsumer,
    RebalanceError,
    range_assign,
)
from repro_torch.core.controller import (
    ControllerNode,
    ControllerUnavailable,
    LogEntry,
    MetadataCommand,
    QuorumController,
)
from repro_torch.core.log import LogConfig, RecordBatch, StreamLog
from repro_torch.core.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Span,
    series_key,
)

__all__ = [
    "METRICS_TOPIC",
    "Broker",
    "BrokerCluster",
    "BrokerUnavailable",
    "ClusterConsumer",
    "ClusterError",
    "ClusterProducer",
    "ConsumerGroup",
    "ControllerNode",
    "ControllerUnavailable",
    "Counter",
    "Gauge",
    "GroupConsumer",
    "Histogram",
    "InvalidTxnState",
    "LogConfig",
    "LogEntry",
    "MetadataCommand",
    "MetricsRegistry",
    "MetricsReporter",
    "NotEnoughReplicasError",
    "NotLeaderError",
    "PartitionMeta",
    "PartitionOffline",
    "QuorumController",
    "RebalanceError",
    "RecordBatch",
    "ReplicationService",
    "Span",
    "StreamLog",
    "range_assign",
    "series_key",
]
