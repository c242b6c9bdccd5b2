"""Command-line entry points of the port (``python -m
tpat_tpu_torch.cli.<name>``)."""
