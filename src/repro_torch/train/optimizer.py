"""AdamW with f32 moments, AdamW with 8-bit moments, the cosine schedule
and global-norm clipping (port of ``repro.train.optimizer``: ``adamw:153``,
``adamw8bit:202``, ``cosine_schedule:33``, ``clip_by_global_norm:48``).

The arithmetic is the JAX package's, step for step: the schedule and the
bias corrections in f32 on the host; m and v in f32; the step count
incremented before ``lr_fn(step)``; clipped gradients rounded back to the
gradient's dtype (for bf16 gradients that is a rounding of its own);
weight decay on every leaf; the new value computed in f32 and cast to the
parameter's dtype.

``adamw8bit`` keeps m and v as int8 codes with f32 scales for each
256-element block of the trailing dim only: m on a linear absmax grid, v
on a log2 grid whose ``(lo, step)`` per block are a trailing pair (the
reference's ``_quantize``, ``_quantize_log``; the port's are in
``kernels/ref.py``). A partial block is padded with zeros, which count
in its absmax and in its log2 range. Its state is ``{"step", "m":
{codes, scales}, "v": {codes, scales}}`` under the params' tree, as
JAX's is. Its global-norm clip is ``kernels.grad_norm.global_norm``,
whose scale stays on the device, and the update of one leaf is one call of
``kernels.adamw8bit.adamw8bit_update`` with that scale: CUDA kernels on
the card, which apply the scale as the update reads g, and their plain
versions (``kernels.ref.global_norm``, ``kernels.ref.adamw8bit_update``)
on the CPU, which compute what ``clip_by_global_norm`` and the update did
in turn, to the bit.

Differences that belong to PyTorch: ``update`` writes the parameters and
the moments in place and returns the same objects; AdamW also writes the
clipped gradients in place, ``adamw8bit`` leaves them as they were; and
the torch-ops forms walk a stacked leaf (``(L, ...)``) one layer slice at
a time (``kernels.ref.layer_slices``), so their f32 temporaries are one
layer's, not the stack's.

Trees are nested dicts of tensors in the JAX layout; their leaves are
visited in the order JAX flattens a dict (sorted keys).

On a mesh (``init``'s and ``update``'s ``mesh`` and ``pspecs``, the
parameters' specs) every tensor is this rank's block and ``state_pspecs``
(JAX's) says how the state splits: the moments as their parameters, the
8-bit scales with their trailing dim whole (``_scale_spec``), the step
replicated. The clip's global norm sums each leaf's squares over the
axes the leaf is split on and only those (a replicated leaf counts once),
per group of leaves split alike. The 8-bit quantization blocks are 256
elements of the global trailing dim, so where the trailing dim is split
(a block may straddle two ranks: yi-6b's ``w_in`` splits 11008 four ways
into 2752 = 10.75 x 256 columns) the update gathers the leaf's trailing
dim, runs of rows at a time, runs on it whole, the same on each rank of
that axis, and keeps its block: the unsharded update's numbers. A mesh of one rank runs the
mesh-free arithmetic.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.kernels import adamw8bit as kernel
from repro_torch.kernels import grad_norm
from repro_torch.kernels.ref import QBLOCK, global_norm, layer_slices, pad_to_block, quantize_log
from repro_torch.models import sharding as SH
from repro_torch.models.policy import P, PartitionSpec

__all__ = [
    "Optimizer", "adamw", "adamw8bit", "clip_by_global_norm", "cosine_schedule", "is_quantized",
    "tree_leaves", "tree_unflatten",
]


def is_quantized(x) -> bool:
    """An 8-bit moment leaf: ``{"codes", "scales"}`` (JAX's ``is_q``)."""
    return isinstance(x, dict) and "codes" in x


def tree_leaves(tree, is_leaf: Callable[[Any], bool] | None = None) -> list:
    """The leaves of a nested dict, in JAX's order (sorted keys); a node
    for which ``is_leaf`` holds is a leaf."""
    if isinstance(tree, dict) and not (is_leaf is not None and is_leaf(tree)):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k], is_leaf)]
    return [tree]


def tree_unflatten(like, leaves) -> Any:
    """A nested dict shaped like ``like`` with ``leaves`` in JAX's order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(like)


# --------------------------------------------------------------- lr schedules
def cosine_schedule(
    peak_lr: float, warmup_steps: int, total_steps: int, final_frac: float = 0.1
) -> Callable[[torch.Tensor], torch.Tensor]:
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)

    return lr


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient by min(1, max_norm / (norm + 1e-9)) in f32 and
    round it back to its dtype, in place. Returns (grads, norm)."""
    leaves = tree_leaves(grads)
    norm, scale = global_norm(leaves, max_norm)
    for g in leaves:
        for gs in layer_slices(g):
            gs.copy_((gs.float() * scale).to(gs.dtype))
    return grads, norm


@torch.no_grad()
def _mesh_norm(leaves: list[torch.Tensor], specs: list, mesh, max_norm: float, norm_fn):
    """(norm, scale) of the gradient blocks ``leaves`` on a mesh:
    ``norm_fn`` over each group of leaves split on the same axes, its
    square summed over those axes, the groups' squares added. One group
    split on no axis (a mesh of one rank) is ``norm_fn``'s own result."""
    groups: dict[tuple, list] = {}
    for g, spec in zip(leaves, specs):
        groups.setdefault(SH.split_axes(spec, mesh), []).append(g)
    if list(groups) == [()]:
        return norm_fn(leaves, max_norm)
    g2 = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for axes, group in groups.items():
        norm = norm_fn(group, max_norm)[0]
        g2 = g2 + SH.all_reduce(norm * norm, mesh, axes)
    norm = torch.sqrt(g2)
    return norm, torch.clamp((norm + 1e-9).reciprocal() * max_norm, max=1.0)


def _scale_spec(spec) -> PartitionSpec:
    """Scales: same spec with the trailing dim unsharded (JAX's)."""
    if len(spec) == 0:
        return P()
    return P(*tuple(spec)[:-1], None)


def _trailing(spec, ndim: int):
    """The entry that splits a leaf's trailing dim (None if none)."""
    spec = tuple(spec)
    return spec[ndim - 1] if ndim and len(spec) >= ndim else None


# ----------------------------------------------------------------- optimizer
@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[..., Any]
    update: Callable[..., tuple[Any, Any]]
    state_pspecs: Callable[[Any], Any] | None = None


def adamw(
    lr: float | Callable = 1e-3,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.01,
    max_grad_norm: float | None = 1.0,
) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: torch.tensor(lr, dtype=torch.float32))

    def init(params, *, mesh=None, pspecs=None):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        leaves = tree_leaves(params)
        return {
            "step": torch.zeros((), dtype=torch.int32),
            "m": tree_unflatten(params, [zeros(p) for p in leaves]),
            "v": tree_unflatten(params, [zeros(p) for p in leaves]),
        }

    @torch.no_grad()
    def update(grads, state, params, *, mesh=None, pspecs=None):
        if max_grad_norm is not None and mesh is not None:
            leaves = tree_leaves(grads)
            scale = _mesh_norm(leaves, tree_leaves(pspecs), mesh, max_grad_norm, global_norm)[1]
            for g in leaves:
                for gs in layer_slices(g):
                    gs.copy_((gs.float() * scale).to(gs.dtype))
        elif max_grad_norm is not None:
            grads, _ = clip_by_global_norm(grads, max_grad_norm)
        step = state["step"] + 1
        lr_t = lr_fn(step).to(torch.float32)
        stepf = step.to(torch.float32)
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** stepf
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** stepf
        leaves = zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]), tree_leaves(state["v"]))
        for p, g, m, v in leaves:
            dev = p.device
            lr_d, bc1_d, bc2_d = (t.to(dev) for t in (lr_t, bc1, bc2))
            for ps, gs, ms, vs in zip(layer_slices(p), layer_slices(g), layer_slices(m), layer_slices(v)):
                gf = gs.float()
                ms.mul_(b1).add_(gf * (1 - b1))
                vs.mul_(b2).add_(gf.mul(1 - b2).mul_(gf))
                pf = ps.float()
                u = (ms / bc1_d) / (torch.sqrt(vs / bc2_d) + eps) + weight_decay * pf
                ps.copy_((pf - lr_d * u).to(ps.dtype))
        state["step"] = step
        return params, state

    def state_pspecs(param_pspecs):
        return {"step": P(), "m": param_pspecs, "v": param_pspecs}

    return Optimizer(init, update, state_pspecs)


def adamw8bit(
    lr: float | Callable = 1e-3,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.01,
    max_grad_norm: float | None = 1.0,
) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: torch.tensor(lr, dtype=torch.float32))

    def zero_m(p, n):  # quantize of zeros: codes 0, scales 0 (n: the global trailing dim)
        nblk = pad_to_block(n) // QBLOCK
        return {"codes": torch.zeros(p.shape, dtype=torch.int8, device=p.device),
                "scales": torch.zeros(p.shape[:-1] + (nblk,), dtype=torch.float32, device=p.device)}

    def zero_v(p, n):  # quantize_log of zeros: codes -127, each block (log2(1e-16), 1e-8)
        nblk = pad_to_block(n) // QBLOCK
        pair = quantize_log(torch.zeros(1, dtype=torch.float32, device=p.device))[1]
        return {"codes": torch.full(p.shape, -127, dtype=torch.int8, device=p.device),
                "scales": pair.expand(p.shape[:-1] + (nblk, 2)).contiguous()}

    def init(params, *, mesh=None, pspecs=None):
        leaves = tree_leaves(params)
        specs = [None] * len(leaves) if mesh is None else tree_leaves(pspecs)
        ns = [p.shape[-1] * (1 if s is None else mesh.size(_trailing(s, p.dim()))) for p, s in zip(leaves, specs)]
        return {
            "step": torch.zeros((), dtype=torch.int32),
            "m": tree_unflatten(params, [zero_m(p, n) for p, n in zip(leaves, ns)]),
            "v": tree_unflatten(params, [zero_v(p, n) for p, n in zip(leaves, ns)]),
        }

    @torch.no_grad()
    def update(grads, state, params, *, mesh=None, pspecs=None):
        # the clip's scale, applied as the update reads each g
        specs = None if mesh is None else tree_leaves(pspecs)
        if max_grad_norm is None:
            clip = None
        elif mesh is None:
            clip = grad_norm.global_norm(tree_leaves(grads), max_grad_norm)[1]
        else:
            clip = _mesh_norm(tree_leaves(grads), specs, mesh, max_grad_norm, grad_norm.global_norm)[1]
        step = state["step"] + 1
        lr_t = lr_fn(step).to(torch.float32)
        stepf = step.to(torch.float32)
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** stepf
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** stepf
        # the m and v leaves are {codes, scales} under the params' tree (_tree_map4)
        leaves = zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"], is_quantized),
                     tree_leaves(state["v"], is_quantized))
        kw = dict(lr=lr_t, bc1=bc1, bc2=bc2, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, clip_scale=clip)
        for i, (p, g, mq, vq) in enumerate(leaves):
            last = None if specs is None else _trailing(specs[i], p.dim())
            if last is not None and SH.split_axes(P(last), mesh):
                _update_whole_trailing(p, g, mq, vq, last, mesh, kw)
            else:
                kernel.adamw8bit_update(p, g, mq["codes"], mq["scales"], vq["codes"], vq["scales"], **kw)
        state["step"] = step
        return params, state

    def state_pspecs(param_pspecs):
        def mspec(spec):  # scales: (..., nblk)
            return {"codes": spec, "scales": _scale_spec(spec)}

        def vspec(spec):  # scales: (..., nblk, 2)
            return {"codes": spec, "scales": P(*_scale_spec(spec), None)}

        return {
            "step": P(),
            "m": SH.map_tree(lambda _, sp: mspec(sp), param_pspecs, param_pspecs),
            "v": SH.map_tree(lambda _, sp: vspec(sp), param_pspecs, param_pspecs),
        }

    return Optimizer(init, update, state_pspecs)


_WHOLE_ROWS_ELEMS = 1 << 26  # elements of the whole trailing dim gathered at a time


@torch.no_grad()
def _update_whole_trailing(p, g, mq, vq, entry, mesh, kw) -> None:
    """The 8-bit update of a leaf whose trailing dim is split over
    ``entry``'s axes: p, g and the codes gathered along it (the scales are
    whole already), the update run on the whole dim, and this rank's block
    kept; every rank of those axes computes the same scales. The blocks
    lie along the trailing dim alone, so the leaf goes through in runs of
    its rows (the leading dims flattened), each at most _WHOLE_ROWS_ELEMS
    elements gathered: the gathered copies are a run's, not the leaf's."""
    n = p.shape[-1]
    rows = p.numel() // n if n else 0
    whole_n = n * mesh.size(entry)
    step = max(1, _WHOLE_ROWS_ELEMS // max(whole_n, 1))
    spec = P(None, entry)
    flat = [t.view(rows, *t.shape[p.dim() - 1:]) for t in (p, g, mq["codes"], mq["scales"], vq["codes"], vq["scales"])]
    for r0 in range(0, rows, step):
        pr, gr, mc, ms, vc, vs = (t[r0:r0 + step] for t in flat)
        whole = [SH.gather(t, spec, mesh).contiguous() for t in (pr, gr, mc, vc)]
        kernel.adamw8bit_update(whole[0], whole[1], whole[2], ms, whole[3], vs, **kw)
        for dst, src in zip((pr, mc, vc), (whole[0], whole[2], whole[3])):
            dst.copy_(SH.local_block(src, 1, mesh, entry))
