"""Plain PyTorch versions of the kernels (port of ``repro.kernels.ref``).

Each is the definitional oracle its kernel is held against, and the path a
kernel wrapper takes for a tensor that lies on the CPU.
"""

from __future__ import annotations

import math

import torch

__all__ = ["mha"]


def mha(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, H, S, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
) -> torch.Tensor:
    """Naive full-materialisation attention: f32 scores, -1e30 mask, f32 softmax."""
    s = q.shape[2]
    d = q.shape[3]
    sc = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    sc = sc / math.sqrt(d)
    if softcap is not None:
        sc = softcap * torch.tanh(sc / softcap)
    qp = torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(s, device=q.device)[None, :]
    ok = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= kp > qp - window
    sc = torch.where(ok[None, None], sc, torch.full_like(sc, -1e30))
    w = torch.softmax(sc, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(q.dtype)
