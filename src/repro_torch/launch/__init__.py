"""Launch helpers (port of ``repro.launch``): the mesh. The launchers
(``train.py``, ``serve.py``, ``dryrun.py``) are not ported yet."""

from repro_torch.launch.mesh import make_mesh, make_production_mesh, mesh_axis_sizes

__all__ = ["make_mesh", "make_production_mesh", "mesh_axis_sizes"]
