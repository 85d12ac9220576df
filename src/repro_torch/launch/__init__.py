"""Launch helpers (port of ``repro.launch``): the mesh, the launchers
``python -m repro_torch.launch.train`` and ``repro_torch.launch.serve``,
and the dry run ``python -m repro_torch.launch.dryrun`` (every cell's step
on the meta device over a fake process group: what a rank holds,
allocates, computes and sends)."""

from repro_torch.launch.mesh import make_mesh, make_production_mesh, mesh_axis_sizes

__all__ = ["make_mesh", "make_production_mesh", "mesh_axis_sizes"]
