"""Launch helpers (port of ``repro.launch``): the mesh, and the launchers
``python -m repro_torch.launch.train`` and ``repro_torch.launch.serve``.
``dryrun.py`` (the meta-device accounting) is not ported yet."""

from repro_torch.launch.mesh import make_mesh, make_production_mesh, mesh_axis_sizes

__all__ = ["make_mesh", "make_production_mesh", "mesh_axis_sizes"]
