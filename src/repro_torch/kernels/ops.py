"""Model-layout entry points to the kernels (port of ``repro.kernels.ops``).

The model keeps activations as (B, S, H, D) with grouped (GQA) K/V. The
JAX wrapper moves axes and repeats K/V heads before its kernel; here the
(B, H, S, D) views are strided views of the model's tensors and the
kernel reads the kv head of each query head itself, so nothing is
copied on the card.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention

__all__ = ["attention_op"]


def attention_op(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, Kv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
) -> torch.Tensor:
    """Attention in model layout; returns (B, S, H, D)."""
    out = flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, softcap=softcap,
    )
    return out.transpose(1, 2)
