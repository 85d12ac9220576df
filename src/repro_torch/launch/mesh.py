"""Device meshes (port of ``repro.launch.mesh``).

``make_mesh(shape, axes)`` builds the port's :class:`~repro_torch.models.
sharding.Mesh` over ``torch.distributed``'s default process group, one
rank per process and card, through ``init_device_mesh``. The caller
starts the process group (its address, world size and rank are its own:
nothing on a machine announces a cluster).
"""

from __future__ import annotations

from typing import Mapping, Sequence

__all__ = ["make_mesh", "make_production_mesh", "mesh_axis_sizes"]


def make_mesh(shape: Sequence[int], axes: Sequence[str], device=None):
    """A mesh of ``shape`` over the axes ``axes`` (row-major over the
    ranks: rank = ((pod * data) + d) * model + m), its tensors on the card
    unless ``device`` asks for the CPU. A mesh of one rank needs no process
    group; any other needs the default one, of ``prod(shape)`` ranks."""
    from repro_torch.models.sharding import Mesh

    return Mesh(shape, axes, device=device)


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production meshes are TPU v5e pods: (16, 16) over
    ("data", "model") and (2, 16, 16) over ("pod", "data", "model"), 256
    and 512 chips. Those shapes do not carry over to H100 machines, and no
    size for the card is fixed here: build the mesh of the machine at hand
    with :func:`make_mesh`."""
    raise NotImplementedError(
        "the TPU v5e production meshes do not carry over to the card; use make_mesh(shape, axes)"
    )


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """axis -> size of the port's ``Mesh``, a ``DeviceMesh`` or a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = getattr(mesh, "axis_names", None) or getattr(mesh, "mesh_dim_names", None)
    return dict(zip(names, tuple(mesh.shape)))
