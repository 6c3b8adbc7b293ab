"""Entry points of the port. Reference: ``repro/launch/`` (``train.py``;
``mesh.py``: ``make_mesh``, ``make_production_mesh``, ``data_axes``;
``dryrun.py`` and ``hlo_cost.py``).

The dry run (``python -m repro_torch.launch.dryrun``, ``dryrun.py``)
reports each (arch x shape) cell's per-device FLOPs, bytes, collective
bytes, memory and roofline terms on the production meshes, counted on
``meta`` tensors by ``op_cost.OpCost`` (the counterpart of
``hlo_cost.py``), with no card. ``count_cell``, ``run_cell``,
``model_flops`` and ``OpCost`` are exported here, loaded on first use so
that ``python -m repro_torch.launch.dryrun`` runs its module once."""
from .mesh import Mesh, data_axes, make_mesh, make_production_mesh

_LAZY = {"count_cell": "dryrun", "run_cell": "dryrun",
         "model_flops": "dryrun", "OpCost": "op_cost"}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__),
                       name)
    raise AttributeError(name)


__all__ = ["Mesh", "OpCost", "count_cell", "data_axes", "make_mesh",
           "make_production_mesh", "model_flops", "run_cell"]
