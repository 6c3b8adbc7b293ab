"""Entry points of the port. Reference: ``repro/launch/`` (``train.py``;
``mesh.py``: ``make_mesh``, ``make_production_mesh``, ``data_axes``;
``dryrun.py`` and ``hlo_cost.py`` wait for ROADMAP.md step 13.6)."""
from .mesh import Mesh, data_axes, make_mesh, make_production_mesh

__all__ = ["Mesh", "data_axes", "make_mesh", "make_production_mesh"]
