"""Twins of the reference's ``examples/*.py`` on the port, each run as
``python -m repro_torch.examples.<name>``: ``quickstart`` (``solve_dmmc``
in its three settings), ``streaming_topics`` (one streaming pass under a
transversal matroid), ``diversity_service`` (two tenants over one served
stream, its metrics and trace), ``serving_diverse`` (the LM ``Engine``
feeding ``solve_dmmc``) and ``diverse_training`` (``launch.train`` with
diverse and with random batches). Each takes ``--device`` (default
``cuda``; on a host with no card it raises unless ``--device cpu``) and
keeps its reference's checks."""
