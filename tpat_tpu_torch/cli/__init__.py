"""Command-line entry points of the port (``python -m
tpat_tpu_torch.cli.<name>``)."""

import argparse

import torch

from tpat_tpu_torch.parallel.distributed import world_size  # noqa: F401


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


def card_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without CUDA raises, so a
    CLI never carries on on the CPU unasked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the CLI runs on the card "
            "(main(args, device='cpu') runs it on the CPU)"
        )
    return device
