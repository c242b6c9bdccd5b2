"""Command-line entry points of the port (``python -m
tpat_tpu_torch.cli.<name>``)."""

import argparse


def str2bool(v):
    """argparse bool parser of the CLIs (``tpat_tpu/cli/__init__.py``);
    refuses what is not a boolean word instead of reading it as False."""
    if isinstance(v, bool):
        return v
    s = str(v).lower()
    if s in ("yes", "true", "t", "y", "1"):
        return True
    if s in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError(f"boolean value expected, got {v!r}")
