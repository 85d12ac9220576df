"""AdamW with f32 moments, the cosine schedule and global-norm clipping
(port of ``repro.train.optimizer``: ``adamw:153``, ``cosine_schedule:33``,
``clip_by_global_norm:48``).

The arithmetic is the JAX package's, step for step: the schedule and the
bias corrections in f32 on the host; m and v in f32; the step count
incremented before ``lr_fn(step)``; clipped gradients rounded back to the
gradient's dtype (for bf16 gradients that is a rounding of its own);
weight decay on every leaf; the new value computed in f32 and cast to the
parameter's dtype.

Differences that belong to PyTorch: ``update`` writes the parameters, the
moments and the (clipped) gradients in place and returns the same
objects, and it walks a stacked leaf (``(L, ...)``) one layer slice at a
time, so its f32 temporaries are one layer's, not the stack's (one f32
copy of yi-6b's stacked MLP weight at 16 layers is 2.9 GB). Slicing does
not change an elementwise result. The 8-bit optimizer is not ported yet.

Trees are nested dicts of tensors in the JAX layout; their leaves are
visited in the order JAX flattens a dict (sorted keys).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

__all__ = ["Optimizer", "adamw", "clip_by_global_norm", "cosine_schedule", "tree_leaves", "tree_unflatten"]


def tree_leaves(tree) -> list:
    """The leaves of a nested dict, in JAX's order (sorted keys)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves) -> Any:
    """A nested dict shaped like ``like`` with ``leaves`` in JAX's order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(like)


def _slices(t: torch.Tensor) -> list[torch.Tensor]:
    """A stacked leaf (3 dims or more: the layer stack first) as its layer
    slices; any other leaf whole."""
    return list(t.unbind(0)) if t.dim() >= 3 else [t]


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
    g2 = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for g in leaves:
        for gs in _slices(g):
            g2 = g2 + torch.sum(torch.square(gs.float()))
    norm = torch.sqrt(g2)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    for g in leaves:
        for gs in _slices(g):
            gs.copy_((gs.float() * scale).to(gs.dtype))
    return grads, norm


# ----------------------------------------------------------------- optimizer
@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]


def adamw(
    lr: float | Callable = 1e-3,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.01,
    max_grad_norm: float | None = 1.0,
) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: torch.tensor(lr, dtype=torch.float32))

    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        leaves = tree_leaves(params)
        return {
            "step": torch.zeros((), dtype=torch.int32),
            "m": tree_unflatten(params, [zeros(p) for p in leaves]),
            "v": tree_unflatten(params, [zeros(p) for p in leaves]),
        }

    @torch.no_grad()
    def update(grads, state, params):
        if max_grad_norm is not None:
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
            for ps, gs, ms, vs in zip(_slices(p), _slices(g), _slices(m), _slices(v)):
                gf = gs.float()
                ms.mul_(b1).add_(gf * (1 - b1))
                vs.mul_(b2).add_(gf.mul(1 - b2).mul_(gf))
                pf = ps.float()
                u = (ms / bc1_d) / (torch.sqrt(vs / bc2_d) + eps) + weight_decay * pf
                ps.copy_((pf - lr_d * u).to(ps.dtype))
        state["step"] = step
        return params, state

    return Optimizer(init, update)
