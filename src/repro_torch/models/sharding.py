"""Training on a device mesh: the mesh, each rank's blocks of a tree, and
the differentiable collectives (the port's side of JAX's SPMD
partitioner).

JAX annotates every parameter with a ``PartitionSpec`` and GSPMD inserts
the collectives. Here one process is one rank of a :class:`Mesh`; each
rank holds its own block of every leaf, cut by the leaf's spec
(:func:`shard_tree`), as plain tensors, and the model calls the
collectives where the partitioner puts them. The kernels are ctypes
launches on plain tensors, which is why this is not DTensor.

Gradient convention. A tensor that several ranks hold the same copy of
(replicated over some axes) has as its gradient the **sum** of the
ranks' local gradients of it. So each rank back-propagates its share of
the global loss (the loss divided by the world size, the loss being the
same number on every rank), and:

* :func:`all_reduce` (sum) has an all-reduce as its adjoint;
* :func:`all_gather` along a dim has a reduce-scatter as its adjoint
  (ZeRO-3's gather of a parameter's ``d_model`` dim, and the context
  parallel attention's output);
* taking one's block of a replicated tensor (:func:`local_block`, a
  plain slice) has autograd's zero-padding as its adjoint, no collective;
* after the backward, a leaf's gradient is summed over every mesh axis
  its spec does not split it on (:func:`reduce_replicated_`), which is
  where data parallelism's gradient sum happens too.

A spec entry names an axis or a tuple of axes; a dim named by a tuple is
split in the order of its names, the first the slowest, as JAX's
``NamedSharding`` splits it. An axis of size 1 splits nothing and costs
no collective, so a mesh of one rank runs the same operations as no mesh.

Every collective here exists in both gloo (the CPU tests) and NCCL (the
cards): ``all_reduce``, ``all_gather_into_tensor`` and
``reduce_scatter_tensor``, in f32, bf16 and int8.
"""

from __future__ import annotations

import itertools
import math
import warnings
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.models.policy import PartitionSpec

__all__ = [
    "Mesh", "all_gather", "all_reduce", "all_reduce_max", "axes_of", "cut", "gather", "gather_dims",
    "gather_tree", "layer_specs", "local_block", "local_shape", "map_tree", "reduce_replicated_", "shard_tree",
    "split_axes",
]


def axes_of(entry) -> tuple[str, ...]:
    """A spec entry's axis names: () for None."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class Mesh:
    """A mesh of ``shape`` over ``axes``, one rank per process, ranks laid
    out row-major over the shape (the last axis the fastest), over
    ``torch.distributed``'s default process group; its tensors live on
    ``device`` (the card unless the caller asks for the CPU).

    Each axis's group comes from ``init_device_mesh``; a group over several
    axes (a ZeRO-3 dim over ``("pod", "data")``) is made here, for every
    set of axes of size above 1, when the mesh is built (making a group is
    collective, so every rank makes them all). A mesh of one rank needs no
    process group."""

    def __init__(self, shape, axes, *, device=None):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axes)
        if len(self.shape) != len(self.axis_names) or min(self.shape, default=1) < 1:
            raise ValueError(f"mesh shape {self.shape} does not fit axes {self.axis_names}")
        self.sizes = dict(zip(self.axis_names, self.shape))
        self.world = math.prod(self.shape)
        self.device = resolve_device(device)
        self.device_mesh = None
        self._groups: dict[tuple[str, ...], Any] = {}
        if dist.is_available() and dist.is_initialized():
            if dist.get_world_size() != self.world:
                raise ValueError(f"mesh of {self.world} ranks over a process group of {dist.get_world_size()}")
            self.rank = dist.get_rank()
            from torch.distributed.device_mesh import init_device_mesh

            # meta tensors (the dry run) take a CPU device mesh: meta has no backend
            kind = "cpu" if self.device.type == "meta" else self.device.type
            self.device_mesh = init_device_mesh(kind, self.shape, mesh_dim_names=self.axis_names)
            big = [a for a in self.axis_names if self.sizes[a] > 1]
            for n in range(2, len(big)):
                for sub in itertools.combinations(big, n):
                    rest = [a for a in self.axis_names if a not in sub]
                    for fixed in itertools.product(*(range(self.sizes[a]) for a in rest)):
                        ranks = sorted(
                            self._rank_of({**dict(zip(rest, fixed)), **dict(zip(sub, c))})
                            for c in itertools.product(*(range(self.sizes[a]) for a in sub))
                        )
                        group = dist.new_group(ranks)
                        if self.rank in ranks:
                            self._groups[sub] = group
        elif self.world == 1:
            self.rank = 0
        else:
            raise RuntimeError(f"a mesh of {self.world} ranks needs torch.distributed's default process group")
        coords, r = [], self.rank
        for s in reversed(self.shape):
            coords.append(r % s)
            r //= s
        self.coords = dict(zip(self.axis_names, reversed(coords)))

    def _rank_of(self, coords: dict) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.sizes[a] + coords[a]
        return r

    def __repr__(self) -> str:
        return f"Mesh({dict(self.sizes)}, rank {self.rank})"

    def size(self, axes) -> int:
        """The number of blocks a dim split over ``axes`` has (axes not in
        the mesh count 1)."""
        return math.prod(self.sizes.get(a, 1) for a in axes_of(axes))

    def coord(self, axes) -> int:
        """This rank's block index along ``axes``, the first axis the slowest."""
        k = 0
        for a in axes_of(axes):
            k = k * self.sizes.get(a, 1) + self.coords.get(a, 0)
        return k

    def group(self, axes):
        """The process group of this rank's ranks along ``axes`` (None
        where they are one rank). The axes must come in the mesh's order,
        which is the order of the group's ranks."""
        ax = tuple(a for a in axes_of(axes) if self.sizes.get(a, 1) > 1)
        if not ax:
            return None
        order = [self.axis_names.index(a) for a in ax]
        if order != sorted(order) or len(set(order)) != len(order):
            raise ValueError(f"axes {ax} are not in the mesh's order {self.axis_names}")
        if len(ax) == 1:
            return self.device_mesh.get_group(ax[0])
        if len(ax) == sum(s > 1 for s in self.shape):
            return dist.group.WORLD
        return self._groups[ax]

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier()


# ------------------------------------------------------------ collectives
def _collective(fn, out, x, group) -> None:
    """``all_gather_into_tensor`` and ``reduce_scatter_tensor`` warn of
    their newer names on torch 2.13; the card's torch has only these."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        fn(out, x, group=group)


def _gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xt.shape[0],) + tuple(xt.shape[1:]), dtype=x.dtype, device=x.device)
    _collective(dist.all_gather_into_tensor, out, xt, group)
    return out.movedim(0, dim)


def _scatter_sum(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((xt.shape[0] // n,) + tuple(xt.shape[1:]), dtype=x.dtype, device=x.device)
    _collective(dist.reduce_scatter_tensor, out, xt, group)
    return out.movedim(0, dim)


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int, group, n: int):
        ctx.args = (dim, group, n)
        return _gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, *ctx.args), None, None, None


def all_reduce(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """The sum of x over the ranks along ``axes``; its adjoint is the sum
    of the gradients (x itself where those ranks are one)."""
    group = mesh.group(axes)
    return x if group is None else _AllReduce.apply(x, group)


def all_gather(x: torch.Tensor, dim: int, mesh: Mesh, axes) -> torch.Tensor:
    """The blocks of the ranks along ``axes`` joined along ``dim`` in block
    order; its adjoint is the reduce-scatter of the gradient."""
    group = mesh.group(axes)
    return x if group is None else _AllGather.apply(x, dim % x.dim(), group, mesh.size(axes))


@torch.no_grad()
def all_reduce_max(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """The elementwise max over the ranks along ``axes`` (no gradient)."""
    group = mesh.group(axes)
    if group is None:
        return x
    y = x.detach().contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def local_block(x: torch.Tensor, dim: int, mesh: Mesh, axes) -> torch.Tensor:
    """This rank's block of x along ``dim`` (a view)."""
    n = mesh.size(axes)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split {n} ways")
    blk = x.shape[dim] // n
    return x.narrow(dim, mesh.coord(axes) * blk, blk)


# ------------------------------------------------------------ spec trees
def map_tree(f: Callable, tree, specs):
    """``f(leaf, spec)`` over a nested dict and its spec tree."""
    if isinstance(tree, dict):
        return {k: map_tree(f, tree[k], specs[k]) for k in tree}
    return f(tree, specs)


def layer_specs(specs):
    """A stacked block's specs without the leading layer dim (one layer's)."""
    if isinstance(specs, dict):
        return {k: layer_specs(v) for k, v in specs.items()}
    return PartitionSpec(*tuple(specs)[1:])


def split_axes(spec, mesh: Mesh) -> tuple[str, ...]:
    """The axes of size above 1 that ``spec`` splits its tensor on, in the
    mesh's order."""
    used = {a for e in tuple(spec) for a in axes_of(e)}
    return tuple(a for a in mesh.axis_names if a in used and mesh.sizes[a] > 1)


def local_shape(shape, spec, mesh: Mesh) -> tuple[int, ...]:
    """The shape of this rank's block of a tensor of ``shape``."""
    shape = list(shape)
    for i, e in enumerate(tuple(spec)):
        n = mesh.size(e)
        if shape[i] % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split {n} ways by {spec}")
        shape[i] //= n
    return tuple(shape)


def cut(t, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the dense tensor t, a tensor of its own."""
    t = torch.as_tensor(t)
    for i, e in enumerate(tuple(spec)):
        t = local_block(t, i, mesh, e)
    return t.clone(memory_format=torch.contiguous_format)


@torch.no_grad()
def gather(t: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """The dense tensor of every rank's block of ``t`` (collective), a
    tensor of its own (a copy where no axis splits ``t``)."""
    out = t
    for i, e in enumerate(tuple(spec)):
        group = mesh.group(e)
        if group is not None:
            out = _gather(out, i, group, mesh.size(e))
    return t.clone() if out is t else out


def shard_tree(tree, pspecs, mesh: Mesh, device=None):
    """Each leaf of a dense tree (tensors or arrays) cut to this rank's
    block by its spec, on ``device`` (the mesh's by default)."""
    dev = mesh.device if device is None else torch.device(device)
    return map_tree(lambda t, s: cut(t, s, mesh).to(dev), tree, pspecs)


def gather_tree(tree, pspecs, mesh: Mesh):
    """The dense tree of every rank's blocks (collective: every rank calls
    it and every rank gets the dense tree)."""
    return map_tree(lambda t, s: gather(t, s, mesh), tree, pspecs)


def gather_dims(tree, specs, mesh: Mesh, axes):
    """Each leaf with the dims its spec splits over ``axes`` (ZeRO-3's
    ``d_model`` dims) all-gathered, differentiably; the rest stay blocks."""
    want = set(axes_of(axes))

    def one(t, spec):
        for i, e in enumerate(tuple(spec)):
            ax = axes_of(e)
            if ax and set(ax) <= want:
                t = all_gather(t, i, mesh, e)
        return t

    return map_tree(one, tree, specs)


@torch.no_grad()
def reduce_replicated_(leaves: list[torch.Tensor], specs: list, mesh: Mesh) -> None:
    """Sum each gradient in place over the mesh axes its spec does not
    split it on (the ranks that hold the same block of it)."""
    for g, spec in zip(leaves, specs):
        used = set(split_axes(spec, mesh))
        axes = tuple(a for a in mesh.axis_names if mesh.sizes[a] > 1 and a not in used)
        group = mesh.group(axes)
        if group is not None:
            dist.all_reduce(g, group=group)
