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

Training. The gradient takes the same care, so that repeated backward
passes give the same bits on the card. The dispatch and the combine are
two gathers, each the other's transpose, and under grad mode each is a
:class:`_PadGather`, whose adjoint is a gather too:

* The dispatch gathers each slot's token row (``x2p[slot_tok]``); a token
  sits in up to ``top_k`` slots, so autograd's adjoint of that gather
  would be a scatter-add with repeated indices, which the card adds in no
  fixed order. The hand-written adjoint forms each token's gradient as
  its ``top_k`` slot rows (``slot``) added in route order from zero (a
  dropped route reads the zero pad row): the combine's arithmetic again,
  with no atomics.
* The combine gathers each route's slot row (``ye_flat[slot]``). The kept
  slots are distinct, but every dropped route reads the pad row, so
  autograd's adjoint would scatter-add all of them onto that one row,
  which the card's sorted-index kernel walks one after another (at the
  published capacity a random router drops about 80% of the routes, and
  that adjoint took 61% of a training step's device time on the H100:
  PERF.md). The hand-written adjoint gathers each slot's one route row
  (``slot_route``; the zero row for a slot no route kept) and drops the
  pad row's gradient, which nothing needs.
* The router's gradient flows through the sorted top-k weights (the
  sort's adjoint writes each selected probability once) and the softmax;
  the aux loss's token fractions come from an argmax and carry none, as
  in JAX.

Serving (grad mode off) runs the plain gathers: the same code and bits as
before the adjoints existed.

Expert parallelism (``moe_pspecs``, JAX's ``_ep_moe``). On a mesh whose
model axis divides the experts each rank holds ``e_loc`` of them, from
``e_start = coord(model) * e_loc`` (with ``ep_inner_axes`` a block of
each expert's ``d_ff`` too); the tokens, the router and the routes are
the same on every rank of a data shard, and each rank computes its own
experts' slots and returns its part of the output, which the caller sums
over the model axis (and the inner axes). The capacity comes from one
data shard's tokens, as in JAX; ``DROPS`` counts each rank's dropped
routes to its own experts, so every route is counted once across the
ranks. The aux loss's token and probability fractions are means over the
global batch: the caller passes their sum over the data axes.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models.policy import P, Policy
from repro_torch.models.sharding import all_reduce, axes_of

__all__ = ["F32_LEAVES", "MoEParams", "moe_ffn", "moe_init", "moe_pspecs", "moe_routes", "moe_shapes"]

# leaves kept in f32 under any parameter dtype (moe.py:49 in JAX)
F32_LEAVES = ("router",)

# When set to a 0-d integer tensor, every call adds the routes it dropped
# to it, on the tensor's device and without a sync (a check that a run
# dropped nothing reads it once at the end).
DROPS: torch.Tensor | None = None
# True while a checkpointed layer group's forward runs a second time for
# its backward (``Policy.remat``): its routes were counted the first time.
RECOMPUTING = False


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


def moe_pspecs(policy: Policy, d: int, mp: MoEParams) -> dict:
    """JAX's ``moe_pspecs``: experts over the model axis, each expert's
    ``d_ff`` over ``ep_inner_axes`` (2D expert parallelism), ``d`` ZeRO-3
    where the policy says; the router replicated."""
    e = policy.tp(mp.n_experts)
    f = policy.fsdp(d, has_tp=e is not None)
    inner = policy.ep_inner(mp.d_ff)
    return {
        "router": P(None, None, None),
        "w_in": P(None, e, f, inner),
        "w_gate": P(None, e, f, inner),
        "w_out": P(None, e, inner, f),
    }


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


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """jax.lax.top_k: the k largest, equal values in expert order."""
    topw, tope = torch.sort(probs, dim=-1, descending=True, stable=True)
    return topw[..., :k], tope[..., :k]


def _pad(x):
    """x (N, d) with a zero row appended: index N picks zeros."""
    return torch.cat([x, x.new_zeros((1, x.shape[1]))])


class _PadGather(torch.autograd.Function):
    """``_pad(src)[idx]`` with an adjoint that gathers as well: ``adj``
    lists, for each row of src, the ``k`` rows of the output that picked
    it (len(idx), the zero row, where fewer did), and that row's gradient
    is theirs added in that order from zero. No atomics: the same bits on
    every call."""

    @staticmethod
    def forward(ctx, src, idx, adj, k: int):
        ctx.save_for_backward(adj)
        ctx.k = k
        return _pad(src)[idx]

    @staticmethod
    def backward(ctx, dout):
        (adj,) = ctx.saved_tensors
        rows = _pad(dout)[adj].reshape(-1, ctx.k, dout.shape[1])
        dsrc = torch.zeros(rows.shape[0::2], dtype=dout.dtype, device=dout.device)
        for j in range(ctx.k):
            dsrc = dsrc + rows[:, j]
        return dsrc, None, None, None


def _gather(src, idx, adj, k: int):
    """``_pad(src)[idx]``; under grad mode through :class:`_PadGather`."""
    if torch.is_grad_enabled() and src.requires_grad:
        return _PadGather.apply(src, idx, adj, k)
    return _pad(src)[idx]


def _dispatch(x2, slot_tok, slot, k: int):
    """(E * C, d): each slot's token row (the zero pad row for a slot no
    route kept); the adjoint adds each token's k route slots (``slot``)."""
    return _gather(x2, slot_tok, slot, k)


def _experts(xe, w_in, w_gate, w_out):
    """The gated expert MLPs over the slots (E, C, d): batched matmuls."""
    h = torch.bmm(xe, w_in.to(xe.dtype))
    g = torch.bmm(xe, w_gate.to(xe.dtype))
    return torch.bmm(F.silu(g) * h, w_out.to(xe.dtype))


def _combine(ye, slot, slot_route, weight, t: int, k: int):
    """Gather each route's slot row of ye (E * C, d) back (the dropped ones
    the pad row; the adjoint takes each slot's one route, ``slot_route``),
    weight it, and add each token's k in order from zero: (T, d)."""
    d = ye.shape[1]
    contrib = (_gather(ye, slot, slot_route, 1) * weight.to(ye.dtype)[:, None]).reshape(t, k, d)
    out = torch.zeros((t, d), dtype=ye.dtype, device=ye.device)
    for j in range(k):
        out = out + contrib[:, j]
    return out


def _local_moe(
    x2: torch.Tensor,  # (T, d) tokens (flattened batch * seq)
    probs: torch.Tensor,  # (T, E) f32 router probabilities
    w_in: torch.Tensor,  # (E, d, f)
    w_gate: torch.Tensor,
    w_out: torch.Tensor,  # (E, f, d)
    *,
    mp: MoEParams,
    capacity: int,
    tope: torch.Tensor | None = None,  # (T, k) expert ids to route by, else probs' top-k
    e_start: int | None = None,  # expert parallelism: the first of this rank's experts
) -> torch.Tensor:
    """Capacity dispatch, the expert products and the combine; returns (T, d).
    With ``e_start`` the weights are this rank's experts from ``e_start``
    on, the routes to the other experts are not this rank's (weight 0), and
    the result is this rank's part of the output."""
    t, d = x2.shape
    e = w_in.shape[0]
    k = mp.top_k
    dev = x2.device
    if tope is None:
        topw, tope = _top_k(probs, k)
    else:
        topw = probs.gather(-1, tope)
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

    if e_start is None:
        keep = rank < capacity
        slot = torch.where(keep, flat_e * capacity + rank, e * capacity)  # drop row
        if DROPS is not None and not RECOMPUTING:
            DROPS.add_((~keep).sum())
    else:  # JAX's _local_moe on an expert-parallel shard: the local experts' routes
        local_e = flat_e - e_start
        mine = (local_e >= 0) & (local_e < e)
        keep = mine & (rank < capacity)
        slot = torch.where(keep, local_e * capacity + rank, e * capacity)
        if DROPS is not None and not RECOMPUTING:
            DROPS.add_((mine & ~keep).sum())

    # dispatch: each slot's token id (T: an all-zero pad row), then gather
    slot_tok = torch.full((e * capacity + 1,), t, dtype=torch.long, device=dev)
    slot_tok[slot] = torch.where(keep, flat_tok, t)
    xe = _dispatch(x2, slot_tok[:-1], slot, k).reshape(e, capacity, d)
    ye = _experts(xe, w_in, w_gate, w_out)

    # combine: gather the slots back, weight, add each token's k in order;
    # its adjoint reads each slot's route (T * k: a zero row)
    slot_route = None
    if torch.is_grad_enabled():
        slot_route = torch.full((e * capacity + 1,), t * k, dtype=torch.long, device=dev)
        slot_route[slot] = torch.where(keep, torch.arange(t * k, device=dev), t * k)
        slot_route = slot_route[:-1]
    return _combine(ye.reshape(e * capacity, d), slot, slot_route, flat_w * keep, t, k)


def _router(p: dict, x: torch.Tensor, mp: MoEParams, data=None):
    """Router probabilities (B, S, E) in f32 (f64 for an f64 x) and the
    load-balancing aux loss (Switch): E * sum(frac_tokens * frac_probs).
    With ``data`` (a mesh and the axes the batch splits over, of more than
    one rank) both fractions are means over the global batch."""
    b, s, _ = x.shape
    logits = (x @ p["router"].to(x.dtype)).to(torch.promote_types(x.dtype, torch.float32))
    probs = torch.softmax(logits, dim=-1)
    top1 = probs.argmax(dim=-1).reshape(-1)
    ones = torch.ones(top1.shape, dtype=torch.float32, device=x.device)
    counts = torch.zeros(mp.n_experts, dtype=torch.float32, device=x.device).scatter_add_(0, top1, ones)
    if data is None:
        frac_tok = counts / (b * s)
        frac_prob = probs.mean(dim=(0, 1))
    else:
        mesh, axes = data
        n = b * s * mesh.size(axes)
        frac_tok = all_reduce(counts, mesh, axes) / n
        frac_prob = all_reduce(probs.sum(dim=(0, 1)), mesh, axes) / n
    aux = mp.n_experts * torch.sum(frac_tok * frac_prob) * mp.router_aux_weight
    return probs, aux


@torch.no_grad()
def moe_routes(p: dict, x: torch.Tensor, mp: MoEParams) -> torch.Tensor:
    """The (B * S, k) expert ids that :func:`moe_ffn` routes x by."""
    probs, _ = _router(p, x, mp)
    return _top_k(probs.reshape(-1, mp.n_experts), mp.top_k)[1]


def moe_ffn(p: dict, x: torch.Tensor, mp: MoEParams, dense_mlp=None, routes: torch.Tensor | None = None,
            *, mesh=None, policy=None, rows=None):
    """MoE FFN over x (B, S, d); ``dense_mlp(x)`` (arctic's dense
    residual) is added where the config has one. ``routes`` ((B * S, k)
    expert ids, as :func:`moe_routes` gives them) routes by those experts,
    their weights taken from this call's probabilities, in place of this
    call's top-k: a run in another precision routed alike. On a ``mesh``
    (with its ``policy``) x is this rank's rows of the batch, split over
    the axes ``rows`` (the policy's batch axes where None: training's
    data shards; serving's batch splits where it divides), ``p`` this
    rank's blocks, and the experts split over the model axis where it
    divides them (JAX's ``_ep_moe``); the output is summed over the ranks
    that hold parts of it. The capacity is JAX's: the whole batch's
    tokens over the data-parallel degree. Returns (out, aux_loss)."""
    b, s, d = x.shape
    data = None
    ep, reduce_axes = False, ()
    n_tokens = b * s
    if mesh is not None:
        batch = tuple(a for a in (policy.batch_axes if rows is None else rows) if a in mesh.sizes)
        data = (mesh, batch) if mesh.size(batch) > 1 else None
        n_tokens = b * s * mesh.size(batch) // policy.dp_degree
        tp = policy.tp_axis
        ep = mesh.size(tp) > 1 and mp.n_experts % mesh.size(tp) == 0
        inner = axes_of(policy.ep_inner(mp.d_ff))
        reduce_axes = tuple(a for a in mesh.axis_names if (ep and a == tp) or a in inner)
    probs, aux = _router(p, x, mp, data)
    capacity = _capacity(mp, max(n_tokens, 1))
    out = _local_moe(
        x.reshape(-1, d), probs.reshape(-1, mp.n_experts), p["w_in"], p["w_gate"], p["w_out"],
        mp=mp, capacity=capacity, tope=routes,
        e_start=mesh.coord(policy.tp_axis) * p["w_in"].shape[0] if ep else None,
    ).reshape(b, s, d)
    if reduce_axes:
        out = all_reduce(out, mesh, reduce_axes)
    if mp.dense_residual and dense_mlp is not None:
        out = out + dense_mlp(x)
    return out, aux
