"""Serving from a stream (port of ``repro.serve``): the paper's
inference deployment (Algorithm 2) with its LM serve steps, and the LM
engines, alone or behind a consumer group."""

from repro_torch.serve.engine import (
    InferenceDeployment,
    InferenceReplica,
    TxnOutputPublisher,
    build_prefill_step,
    build_serve_step,
)
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
    "InferenceDeployment",
    "InferenceReplica",
    "KVBlockTable",
    "LMEngine",
    "LMServingGroup",
    "LMServingWorker",
    "Request",
    "TxnOutputPublisher",
    "build_prefill_step",
    "build_serve_step",
    "decode_completion",
    "decode_request",
    "encode_completion",
    "encode_request",
    "serve_stream",
    "tenant_key",
]
