"""Architecture registry: ``<arch id>`` -> ArchConfig (+ reduced smoke twin).

The port registers the architectures it can run: yi-6b, mamba2-2.7b,
recurrentgemma-9b, gemma2-2b, qwen2-7b, mistral-large-123b,
qwen3-moe-30b-a3b, arctic-480b, pixtral-12b and whisper-tiny: every
architecture of the JAX package.

Also the four input-shape cells of the reference (``SHAPES``) and
``input_specs``, which gives meta tensors (shapes and dtypes, no storage)
for the dry run (``repro_torch.launch.dryrun``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.configs import (
    arctic_480b,
    gemma2_2b,
    mamba2_2_7b,
    mistral_large_123b,
    pixtral_12b,
    qwen2_7b,
    qwen3_moe_30b_a3b,
    recurrentgemma_9b,
    whisper_tiny,
    yi_6b,
)
from repro_torch.models.model import ArchConfig

_MODULES = [
    yi_6b, mamba2_2_7b, recurrentgemma_9b, gemma2_2b, qwen2_7b, mistral_large_123b, qwen3_moe_30b_a3b, arctic_480b,
    pixtral_12b, whisper_tiny,
]

ARCHS: dict[str, Any] = {m.ID: m for m in _MODULES}


def names() -> list[str]:
    return list(ARCHS)


def get(arch_id: str) -> ArchConfig:
    return ARCHS[arch_id].config()


def get_reduced(arch_id: str) -> ArchConfig:
    return ARCHS[arch_id].reduced_config()


# ------------------------------------------------------------------- shapes
@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

# long_500k needs sub-quadratic attention over the context; pure
# full-attention archs are skipped (the reference's DESIGN.md §5).
LONG_CONTEXT_OK = {"mamba2-2.7b", "gemma2-2b", "recurrentgemma-9b"}


def cell_supported(arch_id: str, shape_name: str) -> tuple[bool, str]:
    if shape_name == "long_500k" and arch_id not in LONG_CONTEXT_OK:
        return False, "pure full attention: 500k context unsupported (DESIGN.md §5)"
    return True, ""


def input_specs(cfg: ArchConfig, shape: ShapeCell) -> dict[str, torch.Tensor]:
    """Meta tensors (shape and dtype, no storage) for every model input, in
    the dtypes the port's entry points take:

    * train/prefill: the full token batch (int32), with a patch frontend's
      precomputed patch embeddings or an encoder's frame embeddings
      (bf16) beside it;
    * decode: one new token per sequence (the KV cache is state, not
      input).
    """
    b, s = shape.global_batch, shape.seq_len

    def spec(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        if cfg.frontend == "patches":
            return {
                "tokens": spec((b, s - cfg.frontend_len), torch.int32),
                "patch_embeds": spec((b, cfg.frontend_len, cfg.d_model), torch.bfloat16),
            }
        if cfg.frontend == "frames":
            return {
                "tokens": spec((b, s), torch.int32),
                "frames": spec((b, cfg.enc_seq, cfg.d_model), torch.bfloat16),
            }
        return {"tokens": spec((b, s), torch.int32)}
    return {"tokens": spec((b, 1), torch.int32)}


def make_batch(cfg: ArchConfig, shape: ShapeCell, rng: np.random.Generator) -> dict:
    """A random batch matching ``input_specs`` as numpy arrays, drawn by the
    reference's calls on ``rng`` (so its values): tokens uniform over the
    vocab (int32), embeddings standard normal (float32)."""
    out = {}
    for k, t in input_specs(cfg, shape).items():
        if t.dtype == torch.int32:
            out[k] = rng.integers(0, cfg.vocab, size=tuple(t.shape)).astype(np.int32)
        else:
            out[k] = rng.normal(size=tuple(t.shape)).astype(np.float32)
    return out
