"""Measurement scripts of the port, counterparts of the repository's
``scripts/``; each runs as ``python3 -m vast_tpu_torch.scripts.<name>``."""
