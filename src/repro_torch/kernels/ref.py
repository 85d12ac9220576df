"""Plain PyTorch versions of the kernels (port of ``repro.kernels.ref``).

Each is the definitional oracle its kernel is held against, and the path a
kernel wrapper takes for a tensor that lies on the CPU.
"""

from __future__ import annotations

import math

import torch

__all__ = ["mha", "ssd"]


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


def ssd(
    x: torch.Tensor,  # (B, H, S, P)
    dt: torch.Tensor,  # (B, H, S) f32, post-softplus
    A: torch.Tensor,  # (H,) f32, negative
    Bm: torch.Tensor,  # (B, H, S, N), one row per head (groups repeated)
    Cm: torch.Tensor,  # (B, H, S, N)
    init_state: torch.Tensor | None = None,  # (B, H, N, P) f32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential SSD recurrence (the definitional oracle):
    ``S_t = exp(dt_t A) S_{t-1} + B_t (dt_t x_t)^T``, ``y_t = C_t . S_t``.

    The state is f32; ``x * dt`` is formed in x's dtype (dt rounded to it
    first), as the JAX oracle does. Returns (y (B, H, S, P) in x's dtype,
    final state (B, H, N, P) f32).
    """
    b, h, s, p = x.shape
    n = Bm.shape[-1]
    if init_state is None:
        state = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    else:
        state = init_state.float()
    decay = torch.exp(dt * A[None, :, None])  # (B, H, S)
    xdt = (x * dt[..., None].to(x.dtype)).float()
    ys = []
    for t in range(s):
        upd = torch.einsum("bhn,bhp->bhnp", Bm[:, :, t].float(), xdt[:, :, t])
        state = state * decay[:, :, t, None, None] + upd
        ys.append(torch.einsum("bhn,bhnp->bhp", Cm[:, :, t].float(), state))
    return torch.stack(ys, dim=2).to(x.dtype), state
