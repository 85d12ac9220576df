"""Architecture registry: ``<arch id>`` -> ArchConfig (+ reduced smoke twin).

The port registers the architectures it can run: yi-6b, mamba2-2.7b,
recurrentgemma-9b, gemma2-2b, qwen2-7b, mistral-large-123b,
qwen3-moe-30b-a3b, arctic-480b, pixtral-12b and whisper-tiny: every
architecture of the JAX package.
"""

from __future__ import annotations

from typing import Any

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
