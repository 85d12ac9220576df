from repro_torch.data.formats import AvroCodec, FieldSpec, RawCodec, codec_from_control
from repro_torch.data.pipeline import (
    BatchIterator,
    PrefetchIterator,
    ShortStreamError,
    StreamDataset,
    StreamingBatchIterator,
    TransactionalProcessor,
    device_feed,
    ingest,
    prefetch_iter,
)
