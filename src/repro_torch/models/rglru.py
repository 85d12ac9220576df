"""RG-LRU recurrent block (port of ``repro.models.rglru``, one device).

Griffin / RecurrentGemma's Real-Gated Linear Recurrent Unit:

    r_t = sigmoid(W_a x_t + b_a),  i_t = sigmoid(W_i x_t + b_i),
    log a_t = -8 softplus(Lambda) r_t,
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t).

Parameters keep the JAX tree's keys and shapes (the caller indexes one
layer out of the stacked ``(L, ...)`` leaves); ``b_a``, ``b_i`` and
``Lambda`` are f32 whatever the parameter dtype.

The difference that belongs to the port: for S > 1 the mixer calls
``kernels.ops.rglru_op`` (the Hopper RG-LRU kernel on the card, its plain
version ``ref.rglru`` on the CPU) where the JAX mixer runs its
``rglru_scan``, an ``associative_scan``, which so has no port. Under grad
mode that call goes through ``RGLRUScan``, whose backward is K3's
backward kernel (``ref.rglru_bwd`` on the CPU); JAX differentiates its
associative scan. The decode step (S == 1 with a state) is the one-step
update in torch ops, in the ``a * a`` form, as in JAX, and never reaches
the kernels.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import rglru_op
from repro_torch.models.policy import P, Policy
from repro_torch.models.ssm import causal_conv

__all__ = [
    "F32_LEAVES",
    "RGLRUParams",
    "rglru_init",
    "rglru_init_state",
    "rglru_mixer",
    "rglru_pspecs",
    "rglru_shapes",
]

_C = 8.0  # Griffin's fixed gate sharpness

# leaves kept in f32 under any parameter dtype (rglru.py:59-62 in JAX)
F32_LEAVES = ("b_a", "b_i", "Lambda")


@dataclasses.dataclass(frozen=True)
class RGLRUParams:
    d_rnn: int
    conv_width: int = 4
    n_blocks: int = 16  # block-diagonal gate projections

    @property
    def block_dim(self) -> int:
        return self.d_rnn // self.n_blocks


def rglru_shapes(L: int, d: int, rp: RGLRUParams) -> dict[str, tuple[int, ...]]:
    """The mixer's parameter shapes, stacked over ``L`` layers."""
    bd = rp.block_dim
    return {
        "w_x_branch": (L, d, rp.d_rnn),
        "w_gate_branch": (L, d, rp.d_rnn),
        "conv": (L, rp.conv_width, rp.d_rnn),
        "w_a": (L, rp.n_blocks, bd, bd),
        "b_a": (L, rp.d_rnn),
        "w_i": (L, rp.n_blocks, bd, bd),
        "b_i": (L, rp.d_rnn),
        "Lambda": (L, rp.d_rnn),
        "w_out": (L, rp.d_rnn, d),
    }


def rglru_pspecs(policy: Policy, d: int, rp: RGLRUParams) -> dict:
    """JAX's ``rglru_pspecs``: the RG-LRU's channels and its gates'
    diagonal blocks over the model axis (the recurrence needs no
    collective), ``d`` ZeRO-3 where the policy says."""
    tp_r = policy.tp(rp.d_rnn)
    tp_b = policy.tp(rp.n_blocks)
    f = policy.fsdp(d, has_tp=tp_r is not None)
    return {
        "w_x_branch": P(None, f, tp_r),
        "w_gate_branch": P(None, f, tp_r),
        "conv": P(None, None, tp_r),
        "w_a": P(None, tp_b, None, None),
        "b_a": P(None, tp_r),
        "w_i": P(None, tp_b, None, None),
        "b_i": P(None, tp_r),
        "Lambda": P(None, tp_r),
        "w_out": P(None, tp_r, f),
    }


@torch.no_grad()
def rglru_init(p: dict, d: int, rp: RGLRUParams, normal, uniform) -> None:
    """Fill the mixer's stacked parameters in place at the JAX init's
    scales; ``normal(t, scale)`` draws a scaled standard normal into t and
    ``uniform(t, lo, hi)`` a uniform one. Lambda puts a^c in (0.9, 0.999)
    (Griffin's appendix): u ~ U(0.81, 0.998), Lambda = log(expm1(-log(u) / 16))."""
    normal(p["w_x_branch"], 1.0 / math.sqrt(d))
    normal(p["w_gate_branch"], 1.0 / math.sqrt(d))
    normal(p["conv"], 0.5)
    normal(p["w_a"], 1.0 / math.sqrt(rp.block_dim))
    normal(p["w_i"], 1.0 / math.sqrt(rp.block_dim))
    p["b_a"].fill_(0.0)
    p["b_i"].fill_(0.0)
    uniform(p["Lambda"], 0.9**2, 0.999**2)
    p["Lambda"].copy_(torch.log(torch.expm1(-torch.log(p["Lambda"]) / (2 * _C))))
    normal(p["w_out"], 1.0 / math.sqrt(rp.d_rnn))


def _block_diag_proj(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) in the compute dtype, w: (nb, bd, bd) block-diagonal,
    b: (D,) f32; the product in x's dtype, then f32 plus b."""
    bsz, s, dd = x.shape
    nb, bd, _ = w.shape
    y = torch.einsum("bsnd,nde->bsne", x.reshape(bsz, s, nb, bd), w.to(x.dtype))
    return y.reshape(bsz, s, dd).float() + b


def rglru_mixer(
    p: dict,
    xin: torch.Tensor,  # (B, S, d)
    rp: RGLRUParams,
    state: dict | None = None,  # decode: {"conv": (B, W-1, D), "h": (B, D)}
):
    """Griffin recurrent block (without the residual add). Returns (y, new_state)."""
    s = xin.shape[1]
    xb = xin @ p["w_x_branch"].to(xin.dtype)
    gate = xin @ p["w_gate_branch"].to(xin.dtype)

    conv_state = state["conv"] if state is not None else None
    xb, new_conv = causal_conv(xb, p["conv"], conv_state)

    r = torch.sigmoid(_block_diag_proj(xb, p["w_a"], p["b_a"]))
    i = torch.sigmoid(_block_diag_proj(xb, p["w_i"], p["b_i"]))
    log_a = -_C * F.softplus(p["Lambda"].float()) * r  # (B, S, D) f32
    gated = i * xb.float()

    h0 = state["h"] if state is not None else None
    if s == 1 and state is not None:
        a = torch.exp(log_a[:, 0])
        h_last = a * h0 + torch.sqrt(torch.clamp(1 - a * a, min=0.0)) * gated[:, 0]
        h = h_last[:, None]
    else:
        h, h_last = rglru_op(gated, log_a, h0)

    y = h.to(xin.dtype) * F.gelu(gate, approximate="tanh")
    out = y @ p["w_out"].to(y.dtype)
    return out, {"conv": new_conv, "h": h_last}


def rglru_init_state(b: int, rp: RGLRUParams, device=None) -> dict:
    """Zero decode state: conv (B, W-1, d_rnn) and h (B, d_rnn), both f32."""
    return {
        "conv": torch.zeros((b, rp.conv_width - 1, rp.d_rnn), dtype=torch.float32, device=device),
        "h": torch.zeros((b, rp.d_rnn), dtype=torch.float32, device=device),
    }
