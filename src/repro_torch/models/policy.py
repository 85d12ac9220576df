"""Single-device dtype policy (the mesh-free fields of ``repro.models.policy.Policy``).

``weights_int8`` serves int8 post-training-quantized weights
(``model.quantize_params``); ``kv_cache_dtype`` may be
``"float8_e4m3fn"``, which halves a bf16 decode cache. ``remat``
(``"none" | "block" | "full"``, JAX's field) recomputes each layer group's
forward in its backward while training: ``"full"`` saves nothing inside
the group, ``"block"`` saves the products without a batch dimension;
any other value runs as ``"none"`` (``StreamModel._run_stack``). It is
the last field, so the positional dtype arguments keep their places.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["Policy", "torch_dtype"]


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (the names JAX's Policy uses)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


@dataclass(frozen=True)
class Policy:
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    kv_cache_dtype: str = "bfloat16"
    weights_int8: bool = False
    remat: str = "none"  # none | block | full
