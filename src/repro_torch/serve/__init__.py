"""Serving in the port: the LM engine (``serve.engine``).

Reference: ``repro/serve/__init__.py``; the diversity service
(``repro/serve/diversity``) is not ported yet (ROADMAP.md step 9).
"""
