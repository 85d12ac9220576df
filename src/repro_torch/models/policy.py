"""Single-device dtype policy (the mesh-free fields of ``repro.models.policy.Policy``)."""

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
