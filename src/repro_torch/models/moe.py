"""Mixture-of-Experts FFN (port of ``repro.models.moe``, one device).

Every expert lives on the one device, so :func:`moe_ffn` runs the JAX
package's single-shard path (``_local_moe`` with ``e_start`` 0): top-k
routing with the weights renormalised, ``_capacity`` slots an expert
counted from the call's ``b * s`` tokens, the lower token first within an
expert (a stable sort over expert ids) and the routes past the capacity
dropped (weight 0); the three expert products as batched matmuls (JAX
computes them as einsums outside any Pallas kernel); and the combine as
each token's k contributions added in order from zero, which is the
arithmetic of JAX's scatter-add over ``repeat(arange(T), k)`` with no
atomics, so a call gives the same bits every time. arctic's dense
residual (a gated MLP) is added to the output.

The expert-parallel path (``_ep_moe``) and ``moe_pspecs`` belong to the
mesh and are not ported.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

__all__ = ["F32_LEAVES", "MoEParams", "moe_ffn", "moe_init", "moe_shapes"]

# leaves kept in f32 under any parameter dtype (moe.py:49 in JAX)
F32_LEAVES = ("router",)

# When set to a 0-d integer tensor, every call adds the routes it dropped
# to it, on the tensor's device and without a sync (a check that a run
# dropped nothing reads it once at the end).
DROPS: torch.Tensor | None = None


@dataclasses.dataclass(frozen=True)
class MoEParams:
    n_experts: int
    top_k: int
    d_ff: int  # per-expert hidden
    capacity_factor: float = 1.25
    dense_residual: bool = False  # arctic: dense MLP summed with MoE out
    router_aux_weight: float = 0.01


def moe_shapes(L: int, d: int, mp: MoEParams) -> dict[str, tuple[int, ...]]:
    """The MoE's parameter shapes, stacked over ``L`` layers."""
    e, f = mp.n_experts, mp.d_ff
    return {"router": (L, d, e), "w_in": (L, e, d, f), "w_gate": (L, e, d, f), "w_out": (L, e, f, d)}


@torch.no_grad()
def moe_init(p: dict, d: int, mp: MoEParams, normal) -> None:
    """Fill the stacked MoE leaves in place at the JAX init's scales
    (``moe_init:46``): the router and the two input projections
    1/sqrt(d), the output projection 1/sqrt(d_ff); ``normal(t, scale)``
    draws a scaled standard normal into t."""
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(mp.d_ff)
    for k in ("router", "w_in", "w_gate"):
        normal(p[k], s_in)
    normal(p["w_out"], s_out)


def _capacity(mp: MoEParams, n_tokens: int) -> int:
    c = int(math.ceil(mp.top_k * n_tokens * mp.capacity_factor / mp.n_experts))
    return max(8, -(-c // 8) * 8)  # round up to 8 for TPU-friendly shapes


def _local_moe(
    x2: torch.Tensor,  # (T, d) tokens (flattened batch * seq)
    probs: torch.Tensor,  # (T, E) f32 router probabilities
    w_in: torch.Tensor,  # (E, d, f)
    w_gate: torch.Tensor,
    w_out: torch.Tensor,  # (E, f, d)
    *,
    mp: MoEParams,
    capacity: int,
) -> torch.Tensor:
    """Capacity dispatch, the expert products and the combine; returns (T, d)."""
    t, d = x2.shape
    e = w_in.shape[0]
    k = mp.top_k
    dev = x2.device
    # jax.lax.top_k: the k largest, equal values in expert order
    topw, tope = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, tope = topw[:, :k], tope[:, :k]
    topw = topw / topw.sum(dim=-1, keepdim=True)  # renormalize
    flat_e = tope.reshape(-1)  # (T*k,) expert ids
    flat_w = topw.reshape(-1)
    flat_tok = torch.arange(t, device=dev).repeat_interleave(k)

    # rank within each expert: sort by expert id (stable: the lower token
    # first), rank = position - first position of that expert
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    first = torch.searchsorted(e_sorted, e_sorted, side="left")
    rank = torch.empty_like(order)
    rank[order] = torch.arange(t * k, device=dev) - first

    keep = rank < capacity
    slot = torch.where(keep, flat_e * capacity + rank, e * capacity)  # drop row
    if DROPS is not None:
        DROPS.add_((~keep).sum())

    # dispatch: each slot's token id (T: an all-zero pad row), then gather
    slot_tok = torch.full((e * capacity + 1,), t, dtype=torch.long, device=dev)
    slot_tok[slot] = torch.where(keep, flat_tok, t)
    x2p = torch.cat([x2, x2.new_zeros((1, d))])
    xe = x2p[slot_tok[:-1]].reshape(e, capacity, d)

    h = torch.bmm(xe, w_in.to(xe.dtype))
    g = torch.bmm(xe, w_gate.to(xe.dtype))
    ye = torch.bmm(F.silu(g) * h, w_out.to(xe.dtype))

    # combine: gather the slots back, weight, add each token's k in order
    ye_flat = torch.cat([ye.reshape(e * capacity, d), ye.new_zeros((1, d))])
    contrib = (ye_flat[slot] * (flat_w * keep).to(ye.dtype)[:, None]).reshape(t, k, d)
    out = torch.zeros((t, d), dtype=ye.dtype, device=dev)
    for j in range(k):
        out = out + contrib[:, j]
    return out


def moe_ffn(p: dict, x: torch.Tensor, mp: MoEParams, dense_mlp=None):
    """MoE FFN over x (B, S, d); ``dense_mlp(x)`` (arctic's dense
    residual) is added where the config has one. Returns (out, aux_loss)."""
    b, s, d = x.shape
    logits = (x @ p["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    # load-balancing aux loss (Switch): E * sum(frac_tokens * frac_probs)
    top1 = probs.argmax(dim=-1).reshape(-1)
    ones = torch.ones(top1.shape, dtype=torch.float32, device=x.device)
    counts = torch.zeros(mp.n_experts, dtype=torch.float32, device=x.device).scatter_add_(0, top1, ones)
    frac_tok = counts / (b * s)
    frac_prob = probs.mean(dim=(0, 1))
    aux = mp.n_experts * torch.sum(frac_tok * frac_prob) * mp.router_aux_weight

    capacity = _capacity(mp, max(b * s, 1))
    out = _local_moe(
        x.reshape(-1, d), probs.reshape(-1, mp.n_experts), p["w_in"], p["w_gate"], p["w_out"],
        mp=mp, capacity=capacity,
    ).reshape(b, s, d)
    if mp.dense_residual and dense_mlp is not None:
        out = out + dense_mlp(x)
    return out, aux
