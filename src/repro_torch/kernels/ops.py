"""Model-layout entry points to the kernels (port of ``repro.kernels.ops``).

The model keeps activations as (B, S, H, D) with grouped (GQA) K/V and
grouped SSD B/C. The JAX wrappers move axes and repeat K/V heads or B/C
groups before their kernels; here the (B, H, S, D) views are strided
views of the model's tensors and each kernel reads the kv head or group
of each head itself, so nothing is copied on the card (for mamba2's one
group over 80 heads a repeat would copy B and C 80 times).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import FlashAttention, flash_attention
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.kernels.ssd_scan import ssd_scan

__all__ = ["attention_op", "rglru_op", "ssd_op"]


def attention_op(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, Kv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
) -> torch.Tensor:
    """Attention in model layout; returns (B, S, H, D).

    When grad mode is on and an input requires grad, the call goes through
    :class:`FlashAttention`, whose backward is the backward kernel (the
    plain version on the CPU); otherwise it is the forward alone, as it
    serves."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        out = FlashAttention.apply(qt, kt, vt, causal, window, softcap)
    else:
        out = flash_attention(qt, kt, vt, causal=causal, window=window, softcap=softcap)
    return out.transpose(1, 2)


def ssd_op(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H), post-softplus
    A: torch.Tensor,  # (H,), negative
    Bm: torch.Tensor,  # (B, S, G, N)
    Cm: torch.Tensor,  # (B, S, G, N)
    init_state: torch.Tensor | None = None,  # (B, H, N, P) f32
    *,
    chunk: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD in model layout; returns (y (B, S, H, P) in x's dtype, final
    state (B, H, N, P) f32). dt and A enter in f32, so dA = dt * A is f32;
    x * dt is rounded to x's dtype before the scan's arithmetic."""
    y, st = ssd_scan(
        x.transpose(1, 2), dt.float().transpose(1, 2), A.float(),
        Bm.transpose(1, 2), Cm.transpose(1, 2), init_state, chunk=chunk,
    )
    return y.transpose(1, 2), st


def rglru_op(
    x: torch.Tensor,  # (B, S, C) gated input
    log_a: torch.Tensor,  # (B, S, C) log decay
    h0: torch.Tensor | None = None,  # (B, C)
) -> tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU recurrence; returns (h (B, S, C) f32, h_last (B, C) f32).

    Everything enters in f32, as the JAX wrapper casts it. Unlike that
    wrapper (whose kernel walks blocks of ``t_block`` steps and asserts
    they divide S) any S is taken: the kernel masks its ragged last time
    block, whose size is its own constant, so the caller chooses none.
    """
    return rglru_scan(x.float(), log_a.float(), None if h0 is None else h0.float())
