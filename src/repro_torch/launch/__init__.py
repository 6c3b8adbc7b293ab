"""Entry points of the port. Reference: ``repro/launch/`` (``train.py``;
``mesh.py``, ``dryrun.py`` and ``hlo_cost.py`` wait for ROADMAP.md steps
11 and 13)."""
