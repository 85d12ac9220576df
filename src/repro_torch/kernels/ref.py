"""Plain PyTorch versions of the kernels (port of ``repro.kernels.ref``).

Each is the definitional oracle its kernel is held against, and the path a
kernel wrapper takes for a tensor that lies on the CPU.
"""

from __future__ import annotations

import math

import torch

__all__ = ["mha", "rglru", "scores", "ssd"]


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
    sc = scores(q, k, causal=causal, window=window, softcap=softcap)
    w = torch.softmax(sc, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(q.dtype)


def scores(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, H, S, D)
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
) -> torch.Tensor:
    """The f32 (B, H, S, S) scores ``mha`` takes its softmax of: scaled,
    capped, and -1e30 where the mask rules a pair out."""
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
    return torch.where(ok[None, None], sc, torch.full_like(sc, -1e30))


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


def rglru(
    x: torch.Tensor,  # (B, S, C) gated input
    log_a: torch.Tensor,  # (B, S, C) log decay, <= 0
    h0: torch.Tensor | None = None,  # (B, C)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential RG-LRU recurrence (the definitional oracle):
    ``h_t = a_t h_{t-1} + sqrt(max(1 - a_t a_t, 0)) x_t``, ``a = exp(log_a)``.

    The input weight is the ``a * a`` form of the JAX oracle (``ref.py:83``);
    the kernel follows the TPU kernel's ``exp(2 log_a)``, which differs from
    it in the last bits when a is near 1. The state is f32, or float64 when
    x is (a float64 run is the yardstick both are held to at long S).
    Returns (h (B, S, C), h_last (B, C)) in that dtype.
    """
    b, s, c = x.shape
    dt = torch.float64 if x.dtype == torch.float64 else torch.float32
    h = torch.zeros((b, c), dtype=dt, device=x.device) if h0 is None else h0.to(dt)
    a_all = torch.exp(log_a.to(dt))
    x = x.to(dt)
    hs = []
    for t in range(s):
        a = a_all[:, t]
        h = a * h + torch.sqrt(torch.clamp(1.0 - a * a, min=0.0)) * x[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h
