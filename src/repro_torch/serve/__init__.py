"""Serving in the port: the LM engine (``serve.engine``) and the online
diversity service (``serve.diversity``: ``DiversityService``,
``StreamRuntime``, ``QueryFrontend``).

Reference: ``repro/serve/__init__.py``. The diversity service carries
the reference's durability (write-ahead log, checkpoints, restore), query
coalescing, health, replication and audit.
"""
