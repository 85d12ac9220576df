"""Dtype and parallelism policy (port of ``repro.models.policy.Policy``).

``weights_int8`` serves int8 post-training-quantized weights
(``model.quantize_params``); ``kv_cache_dtype`` may be
``"float8_e4m3fn"``, which halves a bf16 decode cache. ``remat``
(``"none" | "block" | "full"``, JAX's field) recomputes each layer group's
forward in its backward while training: ``"full"`` saves nothing inside
the group, ``"block"`` saves the products without a batch dimension;
any other value runs as ``"none"`` (``StreamModel._run_stack``).

The mesh fields follow ``remat``, so the positional dtype arguments keep
their places (``Policy("float32", "float32", "float32")``). They are
JAX's, with JAX's meaning and its divisibility rule: ``mesh_axes`` maps
each mesh axis to its size; the batch splits over ``batch_axes``; heads,
``d_ff``, experts and the vocab over ``tp_axis``; with ``fsdp_axes`` the
``d_model`` dims split ZeRO-3 style (with ``fsdp_selective``, only
parameters that have no tensor-parallel dim); ``ep_inner_axes`` splits
each expert's ``d_ff`` (2D expert parallelism); ``seq_axis`` shards a
decode cache's sequence (``seq`` and ``logical_to_pspec`` give its specs;
on a mesh the decode then runs JAX's flash-decode). A dim is split over an
axis only where its size divides. JAX's ``unroll`` is not ported: torch has no scan to unroll.

A spec is :class:`PartitionSpec`: per dim of a tensor, ``None``
(replicated), an axis name, or a tuple of names (split in the order of
the names, the first the slowest, as JAX's ``NamedSharding`` splits it).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Mapping, Sequence

import torch

__all__ = ["P", "PartitionSpec", "Policy", "logical_to_pspec", "torch_dtype"]


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (the names JAX's Policy uses)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec``: a tuple with one entry per dim (``None``,
    an axis name, or a tuple of axis names; a tuple of one name is that
    name, as JAX stores it)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class Policy:
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    kv_cache_dtype: str = "bfloat16"
    weights_int8: bool = False
    remat: str = "none"  # none | block | full
    # mesh axis name -> size; decisions are divisibility-driven
    mesh_axes: Mapping[str, int] = field(default_factory=dict, hash=False)
    batch_axes: tuple[str, ...] = ("data",)
    tp_axis: str | None = "model"
    fsdp_axes: tuple[str, ...] = ()
    seq_axis: str | tuple | None = None
    ep_inner_axes: tuple[str, ...] = ()
    fsdp_selective: bool = True  # see Policy.fsdp

    def ep_inner(self, dim_size: int):
        if not self.ep_inner_axes:
            return None
        return self._axis_if_divides(tuple(self.ep_inner_axes), dim_size)

    @classmethod
    def for_mesh(cls, mesh, **kw) -> "Policy":
        """The policy of ``mesh`` (the port's ``Mesh``, a ``DeviceMesh`` or
        an axis -> size mapping): the batch over its ``pod`` and ``data``
        axes, tensor parallelism over ``model`` where it has one."""
        from repro_torch.launch.mesh import mesh_axis_sizes

        sizes = mesh_axis_sizes(mesh)
        batch = tuple(a for a in ("pod", "data") if a in sizes)
        kw.setdefault("batch_axes", batch)
        kw.setdefault("tp_axis", "model" if "model" in sizes else None)
        return cls(mesh_axes=sizes, **kw)

    # ------------------------------------------------------------ axis sizes
    def size(self, axis: str | Sequence[str] | None) -> int:
        if axis is None:
            return 1
        if isinstance(axis, str):
            return self.mesh_axes.get(axis, 1)
        n = 1
        for a in axis:
            n *= self.mesh_axes.get(a, 1)
        return n

    @property
    def dp_degree(self) -> int:
        return self.size(self.batch_axes)

    # --------------------------------------------------------- spec builders
    def _axis_if_divides(self, axis, dim_size: int):
        """Return ``axis`` if it exists and evenly divides ``dim_size``."""
        if axis is None:
            return None
        if isinstance(axis, tuple):
            ok = all(a in self.mesh_axes for a in axis)
            return axis if ok and dim_size % self.size(axis) == 0 else None
        if axis not in self.mesh_axes:
            return None
        return axis if dim_size % self.size(axis) == 0 else None

    def batch_spec(self, batch_size: int):
        """Largest prefix of batch_axes that divides the batch."""
        axes: list[str] = []
        for a in self.batch_axes:
            trial = axes + [a]
            if batch_size % self.size(tuple(trial)) == 0:
                axes = trial
            else:
                break
        return tuple(axes) if axes else None

    def tp(self, dim_size: int):
        return self._axis_if_divides(self.tp_axis, dim_size)

    def fsdp(self, dim_size: int, has_tp: bool = False):
        """ZeRO-3 spec for a param dim. With ``fsdp_selective`` (default),
        params that already have a tensor-parallel dim are not
        fsdp-sharded: their per-device footprint is already /tp."""
        if not self.fsdp_axes:
            return None
        if has_tp and self.fsdp_selective:
            return None
        return self._axis_if_divides(tuple(self.fsdp_axes), dim_size)

    def seq(self, dim_size: int):
        return self._axis_if_divides(self.seq_axis, dim_size)

    def with_mesh_axes(self, sizes: Mapping[str, int]) -> "Policy":
        return replace(self, mesh_axes=dict(sizes))


def logical_to_pspec(policy: Policy, dims: Sequence[tuple[str, int]]) -> PartitionSpec:
    """Build a PartitionSpec from (logical_name, size) dims.

    Logical names: ``batch, seq, heads, kv_heads, head_dim, embed(=d_model,
    FSDP target), ff, experts, vocab, state, none``.
    """
    spec = []
    for name, size in dims:
        if name == "batch":
            spec.append(policy.batch_spec(size))
        elif name == "seq":
            spec.append(policy.seq(size))
        elif name in ("heads", "kv_heads", "ff", "vocab", "experts"):
            spec.append(policy.tp(size))
        elif name == "embed":
            spec.append(policy.fsdp(size))
        elif name in ("none", "layers", "head_dim", "state"):
            spec.append(None)
        else:
            raise ValueError(f"unknown logical dim {name!r}")
    return P(*spec)
