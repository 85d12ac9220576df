"""Plain PyTorch versions of the kernels (port of ``repro.kernels.ref``).

Each is the definitional oracle its kernel is held against, and the path a
kernel wrapper takes for a tensor that lies on the CPU. The global
gradient norm's (``global_norm``) is ``repro.train.optimizer``'s
``clip_by_global_norm:48`` up to its scale. The 8-bit AdamW update's
(``adamw8bit_update``) comes with the quantizers of
``repro.train.optimizer`` (``_quantize:68``, ``_dequantize:88``,
``_quantize_log:102``, ``_dequantize_log:125``), which the port's
``adamw8bit`` also uses for its state.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "QBLOCK", "V_FLOOR", "adamw8bit_update", "dequantize", "dequantize_log", "global_norm", "layer_slices", "mha",
    "pad_to_block", "quantize", "quantize_log", "rglru", "rglru_bwd", "scores", "ssd", "ssd_bwd",
]


def mha(
    q: torch.Tensor,  # (B, H, Sq, D)
    k: torch.Tensor,  # (B, H, Sk, D); Sk may differ from Sq (cross attention)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Naive full-materialisation attention: f32 scores, -1e30 mask, f32
    softmax; query i and key j sit at positions q_offset + i and j, as
    JAX's ``_chunked_attention`` places them (``q_pos``, ``k_pos``; a rank
    of the context-parallel attention holds the queries from q_offset)."""
    sc = scores(q, k, causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    w = torch.softmax(sc, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(q.dtype)


def scores(
    q: torch.Tensor,  # (B, H, Sq, D)
    k: torch.Tensor,  # (B, H, Sk, D)
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """The f32 (B, H, Sq, Sk) scores ``mha`` takes its softmax of: scaled,
    capped, and -1e30 where the mask rules a pair out (query i at position
    q_offset + i)."""
    sq, sk = q.shape[2], k.shape[2]
    d = q.shape[3]
    sc = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    sc = sc / math.sqrt(d)
    if softcap is not None:
        sc = softcap * torch.tanh(sc / softcap)
    qp = torch.arange(sq, device=q.device)[:, None] + q_offset
    kp = torch.arange(sk, device=q.device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
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


def ssd_bwd(
    x: torch.Tensor,  # (B, H, S, P)
    dt: torch.Tensor,  # (B, H, S) f32
    A: torch.Tensor,  # (H,) f32
    Bm: torch.Tensor,  # (B, G, S, N), grouped: head h reads group h // (H / G)
    Cm: torch.Tensor,  # (B, G, S, N)
    init_state: torch.Tensor | None,  # (B, H, N, P) f32
    dy: torch.Tensor,  # (B, H, S, P), y's gradient
    dfinal: torch.Tensor | None = None,  # (B, H, N, P) f32, the final state's gradient (None: zero)
) -> tuple[torch.Tensor | None, ...]:
    """The gradients (dx, ddt, dA, dBm, dCm, d init_state) of :func:`ssd`
    over grouped B and C: autograd through it with the groups repeated to
    the heads (so dBm and dCm sum over each group's heads). d init_state is
    None without an initial state."""
    rep = x.shape[1] // Bm.shape[1]
    leaves = [t.detach().requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
    st0 = init_state.detach().requires_grad_(True) if init_state is not None else None
    with torch.enable_grad():
        xx, dd, aa, bb, cc = leaves
        y, st = ssd(xx, dd, aa, bb.repeat_interleave(rep, 1), cc.repeat_interleave(rep, 1), st0)
        outs, douts = [y], [dy]
        if dfinal is not None:
            outs.append(st)
            douts.append(dfinal)
        wrt = leaves + ([st0] if st0 is not None else [])
        grads = torch.autograd.grad(outs, wrt, douts, allow_unused=True)
    grads = [torch.zeros_like(t) if gr is None else gr for t, gr in zip(wrt, grads)]
    return (*grads[:5], grads[5] if st0 is not None else None)


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


def rglru_bwd(
    x: torch.Tensor,  # (B, S, C) gated input
    log_a: torch.Tensor,  # (B, S, C) log decay, <= 0
    h0: torch.Tensor | None,  # (B, C)
    h: torch.Tensor,  # (B, S, C), the forward's every h_t
    dh: torch.Tensor,  # (B, S, C), h's gradient
    dh_last: torch.Tensor | None = None,  # (B, C), h_last's gradient (None: zero)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """The adjoint of :func:`rglru`: (dx, dlog_a, dh0), in x's dtype (so
    float64 in, float64 out), dh0 None without h0. Per channel, from the
    last step to the first, with ``w_t = sqrt(max(1 - exp(2 log_a_t), 0))``
    (as ``-expm1``, which does not cancel near a = 1) and ``h_{-1} = h0``
    (or 0)::

        g_t = dh_t + a_{t+1} g_{t+1}   (g_{S-1} = dh_{S-1} + dh_last)
        dx_t = w_t g_t,  dlog_a_t = g_t (a_t h_{t-1} - a_t^2 x_t / w_t),  dh0 = a_0 g_0

    The carry from step t to step t - 1 is ``a_t g_t``. At a = 1 (log_a
    0) w is 0: dx is 0 there and dlog_a is an infinity of the sign of
    ``-g x`` (NaN where g x is 0), as JAX's derivative of the square
    root at 0 gives."""
    dt = x.dtype
    b, s, c = x.shape
    la = log_a.to(dt)
    a = torch.exp(la)
    v = -torch.expm1(2 * la)
    w = torch.sqrt(torch.where(v > 0, v, torch.zeros_like(v)))  # +0 at a = 1, never -0
    zero = torch.zeros((b, c), dtype=dt, device=x.device)
    hprev = torch.cat([(zero if h0 is None else h0.to(dt))[:, None], h[:, :-1].to(dt)], dim=1)
    dh = dh.to(dt)
    carry = zero if dh_last is None else dh_last.to(dt)
    g = torch.empty_like(dh)
    for t in range(s - 1, -1, -1):
        gt = dh[:, t] + carry
        g[:, t] = gt
        carry = a[:, t] * gt
    dx = w * g
    dlog_a = g * (a * hprev - a * a * x.to(dt) / w)
    return dx, dlog_a, (carry if h0 is not None else None)


# ------------------------------------------- the 8-bit AdamW update and its grids
QBLOCK = 256  # quantization block along the trailing dim
V_FLOOR = 1e-16  # offset so v=0 is representable in log space


def layer_slices(t: torch.Tensor, like: torch.Tensor | None = None) -> list[torch.Tensor]:
    """A stacked leaf (3 dims or more: the layer stack first) as its layer
    slices; any other leaf whole. With ``like``, ``t`` (a moment's codes
    or scales) is cut as the parameter ``like`` is. The torch-ops forms
    walk a stack one slice at a time so that their f32 temporaries are one
    layer's (one f32 copy of yi-6b's stacked MLP weight at 16 layers is
    2.9 GB); slicing changes no elementwise result, nor a quantization
    that blocks the trailing dim alone."""
    return list(t.unbind(0)) if (t if like is None else like).dim() >= 3 else [t]


def pad_to_block(n: int) -> int:
    return -(-n // QBLOCK) * QBLOCK


def _pad_last(x: torch.Tensor, npad: int) -> torch.Tensor:
    n = x.shape[-1]
    if npad == n:
        return x
    return torch.nn.functional.pad(x, (0, npad - n))


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as an IEEE quotient on any device: on the card PyTorch turns a
    division by a host scalar into a product with its reciprocal, which is
    not the reference's quotient, so the divisor is a tensor on x's device."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _blocks(x: torch.Tensor) -> tuple[torch.Tensor, int, int]:
    """(x zero-padded to whole blocks as (..., nblk, 256), n, npad)."""
    shape = tuple(x.shape)
    n = shape[-1]
    npad = pad_to_block(n)
    return _pad_last(x, npad).reshape(shape[:-1] + (npad // QBLOCK, QBLOCK)), n, npad


def _unblock(blocks: torch.Tensor, shape: tuple, n: int, npad: int) -> torch.Tensor:
    return blocks.reshape(tuple(shape[:-1]) + (npad,))[..., :n].contiguous()


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (f32) -> (int8 codes of x's shape, f32 scales (..., nblk)): linear
    absmax over 256-blocks of the trailing dim, zero-padded."""
    blocks, n, npad = _blocks(x)
    scale = _div(blocks.abs().amax(-1, keepdim=True), 127.0)
    safe = torch.where(scale == 0, 1.0, scale)
    codes = torch.clamp(torch.round(blocks / safe), -127, 127).to(torch.int8)
    return _unblock(codes, x.shape, n, npad), scale[..., 0]


def dequantize(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    blocks, n, npad = _blocks(codes.to(torch.float32))
    return _unblock(blocks * scales[..., None], codes.shape, n, npad)


def quantize_log(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Non-negative x (f32) -> (int8 codes on a per-block log2 grid, f32
    scales (..., nblk, 2) holding (lo, step)). The zero padding of a
    partial block enters the log range as log2(1e-16)."""
    blocks, n, npad = _blocks(x)
    blocks = torch.log2(blocks + V_FLOOR)
    lo = blocks.amin(-1, keepdim=True)
    hi = blocks.amax(-1, keepdim=True)
    step = torch.clamp_min(_div(hi - lo, 254.0), 1e-8)
    codes = torch.clamp(torch.round((blocks - lo) / step) - 127, -127, 127).to(torch.int8)
    return _unblock(codes, x.shape, n, npad), torch.cat([lo, step], -1)


def dequantize_log(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    blocks, n, npad = _blocks(codes.to(torch.float32))
    lo, step = scales[..., :1], scales[..., 1:]
    out = torch.clamp_min(torch.exp2(lo + (blocks + 127.0) * step) - V_FLOOR, 0.0)
    return _unblock(out, codes.shape, n, npad)


@torch.no_grad()
def global_norm(leaves: list[torch.Tensor], max_norm: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(norm, scale) of gradient ``leaves``, 0-d f32 tensors on their
    device: the norm of every element in f32, summed a layer slice at a
    time, and the clip scale min(1, max_norm / (norm + 1e-9)) in
    PyTorch's form of that quotient, ``(norm + 1e-9).reciprocal() *
    max_norm`` (``Tensor.__rtruediv__``), which rounds twice; the kernel
    (``csrc/grad_norm.cu``) takes the same form."""
    g2 = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for g in leaves:
        for gs in layer_slices(g):
            g2 = g2 + torch.sum(torch.square(gs.float()))
    norm = torch.sqrt(g2)
    return norm, torch.clamp((norm + 1e-9).reciprocal() * max_norm, max=1.0)


@torch.no_grad()
def adamw8bit_update(p, g, m_codes, m_scales, v_codes, v_scales, *, lr, bc1, bc2, b1, b2, eps, weight_decay,
                     clip_scale=None):
    """One leaf of ``adamw8bit``'s update in torch ops, in place: the
    reference's ``upd`` (``optimizer.py:237-247``), op for op, a layer
    slice at a time. ``lr``, ``bc1`` and ``bc2`` are 0-d f32 tensors.
    ``clip_scale`` (a 0-d f32 tensor, or None for g as given) scales g as
    ``clip_by_global_norm`` does, ``(g.float() * scale).to(g.dtype)``,
    without writing it back."""
    lr, bc1, bc2 = (t.to(p.device) for t in (lr, bc1, bc2))
    parts = zip(*(layer_slices(t, p) for t in (p, g, m_codes, m_scales, v_codes, v_scales)))
    for ps, gs, mc, ms, vc, vs in parts:
        gf = gs.float()
        if clip_scale is not None:
            gf = (gf * clip_scale.to(p.device)).to(gs.dtype).float()
        m = b1 * dequantize(mc, ms) + (1 - b1) * gf
        v = b2 * dequantize_log(vc, vs) + (1 - b2) * gf * gf
        pf = ps.float()
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * pf
        ps.copy_((pf - lr * u).to(ps.dtype))
        for (c, s), (cd, sd) in ((quantize(m), (mc, ms)), (quantize_log(v), (vc, vs))):
            cd.copy_(c)
            sd.copy_(s)
