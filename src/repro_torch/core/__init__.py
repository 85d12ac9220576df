"""Stream substrate the port needs: the partitioned log (copy of ``repro.core.log``)."""

from repro_torch.core.log import LogConfig, RecordBatch, StreamLog

__all__ = ["LogConfig", "RecordBatch", "StreamLog"]
