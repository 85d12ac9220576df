"""LM serving from a stream (port of ``repro.serve.lm_engine``)."""

from repro_torch.serve.lm_engine import (
    ContinuousLMEngine,
    KVBlockTable,
    LMEngine,
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
    "Request",
    "decode_completion",
    "decode_request",
    "encode_completion",
    "encode_request",
    "serve_stream",
    "tenant_key",
]
