"""Runnable examples of the port, the counterparts of the repository's
top-level ``examples/``: ``python -m repro_torch.examples.<name>``, on the
card unless ``--device`` names another (``--device cpu`` on a machine
without one)."""
