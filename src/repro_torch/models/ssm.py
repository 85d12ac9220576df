"""Mamba-2 SSD mixer (port of ``repro.models.ssm``, one device).

Parameters keep the JAX tree's keys and shapes (the caller indexes one
layer out of the stacked ``(L, ...)`` leaves); ``A_log``, ``D`` and
``dt_bias`` are f32 whatever the parameter dtype.

The difference that belongs to the port: for S > 1 the mixer calls
``kernels.ops.ssd_op`` (the Hopper SSD kernel on the card, its plain
version ``ref.ssd`` on the CPU) where the JAX mixer runs the pure-jnp
``ssd_chunked``, so ``ssd_chunked`` and ``_segsum`` have no port; under
grad mode the scan's gradient is K2's backward kernel (``SSDScan``) and
autograd differentiates the mixer's other ops, as ``jax.grad`` does. The
decode step (S == 1 with a state) is the one-token recurrence in torch
ops, as in JAX.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import ssd_op
from repro_torch.models.layers import _proj, rms_norm
from repro_torch.models.policy import P, Policy

__all__ = [
    "F32_LEAVES",
    "SSMParams",
    "causal_conv",
    "ssm_decode_step",
    "ssm_init",
    "ssm_init_state",
    "ssm_mixer",
    "ssm_pspecs",
    "ssm_shapes",
]

# leaves kept in f32 under any parameter dtype (ssm.py:58-62 in JAX)
F32_LEAVES = ("A_log", "D", "dt_bias")


@dataclasses.dataclass(frozen=True)
class SSMParams:
    d_inner: int  # expand * d_model
    head_dim: int = 64  # P
    state_dim: int = 128  # N
    n_groups: int = 1  # G (B/C shared across heads within a group)
    conv_width: int = 4
    chunk: int = 256  # Q

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def ssm_shapes(L: int, d: int, sp: SSMParams) -> dict[str, tuple[int, ...]]:
    """The mixer's parameter shapes, stacked over ``L`` layers."""
    gn = sp.n_groups * sp.state_dim
    h = sp.n_heads
    return {
        "w_z": (L, d, sp.d_inner),
        "w_x": (L, d, sp.d_inner),
        "w_B": (L, d, gn),
        "w_C": (L, d, gn),
        "w_dt": (L, d, h),
        "conv_x": (L, sp.conv_width, sp.d_inner),
        "conv_bc": (L, sp.conv_width, 2 * gn),
        "A_log": (L, h),
        "D": (L, h),
        "dt_bias": (L, h),
        "norm_w": (L, sp.d_inner),
        "w_out": (L, sp.d_inner, d),
    }


def ssm_pspecs(policy: Policy, d: int, sp: SSMParams) -> dict:
    """JAX's ``ssm_pspecs``: ``d_inner`` and the heads over the model
    axis, the group-shared B/C projections replicated, ``d`` ZeRO-3 where
    the policy says."""
    tp_in = policy.tp(sp.d_inner)
    tp_h = policy.tp(sp.n_heads)
    f_in = policy.fsdp(d, has_tp=tp_in is not None)
    f_h = policy.fsdp(d, has_tp=tp_h is not None)
    f = policy.fsdp(d)
    return {
        "w_z": P(None, f_in, tp_in),
        "w_x": P(None, f_in, tp_in),
        "w_B": P(None, f, None),
        "w_C": P(None, f, None),
        "w_dt": P(None, f_h, tp_h),
        "conv_x": P(None, None, tp_in),
        "conv_bc": P(None, None, None),
        "A_log": P(None, tp_h),
        "D": P(None, tp_h),
        "dt_bias": P(None, tp_h),
        "norm_w": P(None, tp_in),
        "w_out": P(None, tp_in, f_in),
    }


@torch.no_grad()
def ssm_init(p: dict, d: int, sp: SSMParams, normal) -> None:
    """Fill the mixer's stacked parameters in place at the JAX init's
    scales; ``normal(t, scale)`` draws a scaled standard normal into t."""
    for k in ("w_z", "w_x", "w_B", "w_C", "w_dt"):
        normal(p[k], 1.0 / math.sqrt(d))
    normal(p["conv_x"], 0.5)
    normal(p["conv_bc"], 0.5)
    h = sp.n_heads
    p["A_log"].copy_(torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32)).expand(p["A_log"].shape))
    p["D"].fill_(1.0)
    p["dt_bias"].fill_(0.0)
    p["norm_w"].fill_(1.0)
    normal(p["w_out"], 1.0 / math.sqrt(sp.d_inner))


def causal_conv(x: torch.Tensor, w: torch.Tensor, state: torch.Tensor | None = None):
    """Depthwise causal conv, then SiLU. x: (B, S, C), w: (W, C).

    With ``state`` (B, W-1, C) the conv continues from it (decode).
    Returns (y, new_state), the new state being the last W-1 raw inputs.
    """
    b, s, c = x.shape
    wd = w.shape[0]
    if state is None:
        pad = torch.zeros((b, wd - 1, c), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S+W-1, C)
    y = xp[:, 0:s] * w[0]
    for i in range(1, wd):
        y = y + xp[:, i : i + s] * w[i]
    new_state = xp[:, xp.shape[1] - (wd - 1) :]
    return F.silu(y), new_state


def ssm_mixer(
    p: dict,
    xin: torch.Tensor,  # (B, S, d)
    sp: SSMParams,
    state: dict | None = None,  # decode: {"conv": (B, W-1, C), "ssd": (B, H, N, P)}
    norm_eps: float = 1e-5,
    *,
    norm=None,
):
    """Full Mamba-2 block (without the residual add). Returns (y, new_state).

    On a mesh the caller passes this rank's heads' parameters with ``sp``'s
    ``d_inner`` cut to them, and ``norm(y, w, eps)``: the gated RMS norm
    over the whole ``d_inner`` (its mean square summed over the ranks)."""
    b, s, _ = xin.shape
    gn = sp.n_groups * sp.state_dim
    z = _proj(xin, p["w_z"])
    xh = _proj(xin, p["w_x"])
    bc = _proj(xin, torch.cat([p["w_B"], p["w_C"]], dim=-1))
    dt_raw = _proj(xin, p["w_dt"])

    conv_state = state["conv"] if state is not None else None
    cs_x = conv_state[:, :, : sp.d_inner] if conv_state is not None else None
    cs_bc = conv_state[:, :, sp.d_inner :] if conv_state is not None else None
    xh, ns_x = causal_conv(xh, p["conv_x"], cs_x)
    bc, ns_bc = causal_conv(bc, p["conv_bc"], cs_bc)
    new_conv = torch.cat([ns_x, ns_bc], dim=-1)

    Bm = bc[..., :gn].reshape(b, s, sp.n_groups, sp.state_dim)
    Cm = bc[..., gn:].reshape(b, s, sp.n_groups, sp.state_dim)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())

    xheads = xh.reshape(b, s, sp.n_heads, sp.head_dim)
    init_ssd = state["ssd"] if state is not None else None
    if s == 1 and state is not None:
        y, new_ssd = _ssd_step(xheads, dt, A, Bm, Cm, init_ssd)
    else:
        y, new_ssd = ssd_op(xheads, dt, A, Bm, Cm, init_ssd, chunk=sp.chunk)

    y = y + xheads * p["D"][None, None, :, None].to(y.dtype)
    y = y.reshape(b, s, sp.d_inner)
    y = (norm or rms_norm)(y * F.silu(z), p["norm_w"], norm_eps)
    out = _proj(y, p["w_out"])
    return out, {"conv": new_conv, "ssd": new_ssd}


def _ssd_step(x, dt, A, Bm, Cm, state):
    """Single-token recurrent update (decode).

    x: (B, 1, H, P), dt: (B, 1, H), Bm/Cm: (B, 1, G, N), state: (B, H, N, P).
    x * dt is the f32 product rounded once to x's dtype, as the prefill's
    scan rounds it (``ssd_scan.py:117``), so that prefill and decode share
    one rounding; the JAX step rounds dt first, which is the same in f32
    (tests/test_torch_ssm.py bounds the difference in bf16).
    """
    h = x.shape[2]
    rep = h // Bm.shape[2]
    decay = torch.exp(dt[:, 0, :] * A[None, :])  # (B, H)
    Bh = Bm[:, 0].repeat_interleave(rep, dim=1) if rep > 1 else Bm[:, 0]  # (B, H, N)
    Ch = Cm[:, 0].repeat_interleave(rep, dim=1) if rep > 1 else Cm[:, 0]
    xdt = (x[:, 0].float() * dt[:, 0, :, None]).to(x.dtype).float()
    upd = torch.einsum("bhn,bhp->bhnp", Bh.float(), xdt)
    new_state = state * decay[:, :, None, None] + upd
    y = torch.einsum("bhn,bhnp->bhp", Ch.float(), new_state)
    return y[:, None].to(x.dtype), new_state


def ssm_decode_step(p, xin, sp, state, norm_eps=1e-5):
    return ssm_mixer(p, xin, sp, state=state, norm_eps=norm_eps)


def ssm_init_state(b: int, sp: SSMParams, device=None) -> dict:
    """Zero decode state: conv (B, W-1, d_inner + 2GN) and SSD (B, H, N, P), both f32."""
    conv_c = sp.d_inner + 2 * sp.n_groups * sp.state_dim
    return {
        "conv": torch.zeros((b, sp.conv_width - 1, conv_c), dtype=torch.float32, device=device),
        "ssd": torch.zeros((b, sp.n_heads, sp.state_dim, sp.head_dim), dtype=torch.float32, device=device),
    }
