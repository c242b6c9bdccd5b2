"""Dataset normalisation constants (mean, std) for a manifest (copy of
``tpat_tpu/cli/get_norm_stats.py``).

The dataset is built with normalisation skipped and every train-time
augmentation off, and the per-batch (mean, std) of the raw log-mel fbanks
are averaged: the AST recipe that produced the presets' constants (e.g.
esc50's (-6.6268077, 5.358466)).

Usage:
    python -m tpat_tpu_torch.cli.get_norm_stats --manifest data.json \\
        --label_csv labels.csv --target_length 512
"""

from __future__ import annotations

import argparse
from typing import Tuple

import numpy as np


def compute_norm_stats(dataset, batch_size: int = 256) -> Tuple[float, float]:
    """Mean of the per-batch means and of the per-batch stds (ddof 1) of
    un-normalised fbanks; ``dataset`` must be built with ``skip_norm=True``."""
    if not getattr(dataset, "skip_norm", False):
        raise ValueError("dataset must be built with skip_norm=True")
    means, stds = [], []
    buf = []
    for i in range(len(dataset)):
        buf.append(np.asarray(dataset[i][0], dtype=np.float64))
        if len(buf) == batch_size:
            b = np.stack(buf)
            means.append(b.mean())
            stds.append(b.std(ddof=1))
            buf = []
    if buf:
        b = np.stack(buf)
        means.append(b.mean())
        stds.append(b.std(ddof=1))
    if not means:
        raise ValueError("empty dataset")
    return float(np.mean(means)), float(np.mean(stds))


def main(argv=None):
    from tpat_tpu_torch.config import DataConfig
    from tpat_tpu_torch.data.datasets import AudiosetDataset

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--manifest", required=True)
    p.add_argument("--label_csv", required=True)
    p.add_argument("--target_length", type=int, required=True)
    p.add_argument("--num_mel_bins", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=256)
    args = p.parse_args(argv)

    cfg = DataConfig(
        name="custom", num_classes=1, target_length=args.target_length,
        num_mel_bins=args.num_mel_bins, norm_mean=0.0, norm_std=1.0,
        multilabel=False, use_noise=False, loss_type="ce",
        freqm=0, timem=0, mixup=0.0,
    )
    ds = AudiosetDataset(
        args.manifest, cfg, args.label_csv, train=False, skip_norm=True
    )
    mean, std = compute_norm_stats(ds, args.batch_size)
    print(f"mean={mean:.7f} std={std:.7f}")
    print(
        "use as: norm_mean={:.7f}, norm_std={:.7f} "
        "(input is normalized as (x - mean) / (2 * std))".format(mean, std)
    )
    return mean, std


if __name__ == "__main__":
    main()
