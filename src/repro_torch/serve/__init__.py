"""Serving in the port: the LM engine (``serve.engine``) and the online
diversity service (``serve.diversity``: ``DiversityService``,
``StreamRuntime``, ``QueryFrontend``).

Reference: ``repro/serve/__init__.py``. The diversity service's
durability, coalescing, health, replication and audit modules come with
ROADMAP step 10.
"""
