"""LM serving from a stream, alone or behind a consumer group (port of
``repro.serve.lm_engine`` and of ``repro.serve.engine``'s transactional
publisher)."""

from repro_torch.serve.engine import TxnOutputPublisher
from repro_torch.serve.lm_engine import (
    ContinuousLMEngine,
    KVBlockTable,
    LMEngine,
    LMServingGroup,
    LMServingWorker,
    Request,
    decode_completion,
    decode_request,
    encode_completion,
    encode_request,
    serve_stream,
    tenant_key,
)

__all__ = [
    "ContinuousLMEngine",
    "KVBlockTable",
    "LMEngine",
    "LMServingGroup",
    "LMServingWorker",
    "Request",
    "TxnOutputPublisher",
    "decode_completion",
    "decode_request",
    "encode_completion",
    "encode_request",
    "serve_stream",
    "tenant_key",
]
