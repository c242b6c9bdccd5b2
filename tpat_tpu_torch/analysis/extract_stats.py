"""The analysis CLI (port of ``tpat_tpu/analysis/extract_stats.py``, the
reference's ``extract_stats.py``), reading the feature directories that
``--eval --flag_extract_features true`` writes (``{key}.{idx:04d}.pth``)::

    python -m tpat_tpu_torch.analysis.extract_stats \\
        --feature_dict_path feats --output_dir stats --kendall_rank_mean \\
        --fig_title ESC-50

Subcommands (same flags as the reference):
  --visualize_mask            render mel-specs with pruned patches zeroed
  --kendall_rank_mean/_std    Kendall-tau between attention scores and
                              KMeans(5) intensity-cluster ranks, per block
  --retained_token_visualize  2D log-density histogram of retained tokens
  --retained_token_analyze    count retained low-intensity tokens

The numeric subcommands (Kendall, retained-token count) need numpy only;
the image subcommands import matplotlib when they run.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np

from tpat_tpu_torch.analysis import stats as S
from tpat_tpu_torch.utils.features import combine_feature_dict


def visualize_mask(feature_dict_path: str, output_dir: str, num_items: int = 64):
    out = os.path.join(output_dir, "visualize")
    os.makedirs(out, exist_ok=True)
    mel = np.asarray(combine_feature_dict(feature_dict_path, "mel"))[:num_items]
    labels = combine_feature_dict(feature_dict_path, "labels")[:num_items]
    stages = []
    for blk in range(64):
        idx = combine_feature_dict(feature_dict_path, f"block-{blk}.topk_idx")
        if idx is not None:
            stages.append(np.asarray(idx)[:num_items])
    if not stages:
        raise ValueError("no pruning stages found in the feature dir")

    rgb = S.colorize_mel(mel[:, 0])  # (B, 3, T, F)
    S.save_melspec_batch(
        rgb, out, "melspec_{}_{}_input.jpg", start_idx=0, labels=labels
    )
    for stage_i, composed in enumerate(S.compose_melspec_idx(stages)):
        masked = S.apply_patch_mask(rgb, composed, patch_size=16)
        S.save_melspec_batch(
            masked, out, "melspec_{}_{}" + f"_{stage_i}.jpg",
            start_idx=0, labels=labels,
        )
    return out


def kendall_rank(
    feature_dict_path: str,
    output_dir: Optional[str],
    stat: str,
    fig_title: str = "",
    num_blocks: int = 12,
):
    mel = np.asarray(combine_feature_dict(feature_dict_path, "mel"))
    patch_stat = S.patch_stats_np(mel, 16, stat)
    rank, cluster_info = S.kmeans_rank(patch_stat, n_clusters=5)
    print("--- cluster boundaries (ascending) ---")
    for i, (mn, mx, frac) in enumerate(cluster_info):
        print(f"C{i + 1}: [{mn:.4f}, {mx:.4f}] {frac * 100:.0f}%")

    taus = []
    for blk in range(num_blocks):
        score = combine_feature_dict(feature_dict_path, f"block-{blk}.attn_score")
        if score is None:  # fewer blocks than requested: stop cleanly
            break
        tau = S.kendall_tau_pairs(np.asarray(score), rank)
        print(f"Kendall Rank for block {blk}: {tau}")
        taus.append(tau)
        idx = combine_feature_dict(feature_dict_path, f"block-{blk}.topk_idx")
        if idx is not None:
            rank = np.take_along_axis(rank, np.asarray(idx), axis=1)

    print(feature_dict_path, stat, taus)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        out_path = os.path.join(output_dir, f"kendall_rank_{stat}.json")
        # Merge into an existing file so successive per-dataset runs build
        # the combined {dataset: [taus x 12]} artifact — the schema of the
        # reference's published ``stats/kendall_rank_*.json``.
        # Entries whose block count differs from this run are dropped:
        # they come from a different corpus/config and would silently
        # corrupt the combined artifact.
        # Exclusive lock across the read-modify-write: per-dataset runs may
        # be launched in parallel into one output_dir, and an unlocked
        # interleave would drop the other run's freshly-added entry.
        import fcntl

        with open(out_path, "a+") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            f.seek(0)
            raw = f.read()
            merged = {}
            if raw.strip():
                for k, v in json.loads(raw).items():
                    if len(v) == len(taus):
                        merged[k] = v
                    else:
                        print(
                            f"kendall_rank: dropping stale entry {k!r} "
                            f"({len(v)} blocks != {len(taus)})"
                        )
            merged[fig_title or "run"] = taus
            f.seek(0)
            f.truncate()
            json.dump(merged, f, indent=2)
    return taus, cluster_info


def _gathered_patch_stats(feature_dict_path: str, num_blocks: int = 12):
    mel = np.asarray(combine_feature_dict(feature_dict_path, "mel"))
    mean = S.patch_stats_np(mel, 16, "mean")
    std = S.patch_stats_np(mel, 16, "std")
    rank_mean, _ = S.kmeans_rank(mean, 5)
    rank_std, _ = S.kmeans_rank(std, 5)
    for blk in range(num_blocks):
        idx = combine_feature_dict(feature_dict_path, f"block-{blk}.topk_idx")
        if idx is not None:
            idx = np.asarray(idx)
            mean = np.take_along_axis(mean, idx, axis=1)
            std = np.take_along_axis(std, idx, axis=1)
            rank_mean = np.take_along_axis(rank_mean, idx, axis=1)
            rank_std = np.take_along_axis(rank_std, idx, axis=1)
    return mean, std, rank_mean, rank_std


def retained_token_visualize(
    feature_dict_path: str, output_dir: str, fig_title: str = "retained"
):
    """2D log1p-density histogram of retained-token (mean, std)
    (extract_stats.py:284-331, token_reduction_utils.py:22-85)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    mean, std, _, _ = _gathered_patch_stats(feature_dict_path)
    raw_mean, raw_std = mean.ravel(), std.ravel()
    upper_std = raw_std.min() + (raw_std.max() - raw_std.min()) * 0.75
    hist, xe, ye = np.histogram2d(
        raw_mean, raw_std, bins=20, density=True,
        range=[[raw_mean.min(), raw_mean.max()], [0, upper_std]],
    )
    hist = np.log1p(hist)
    fig, ax = plt.subplots(figsize=(4, 4.5))
    mesh = ax.pcolormesh(xe, ye, hist.T, cmap="inferno")
    fig.colorbar(mesh, ax=ax, orientation="horizontal")
    ax.set_title(fig_title, fontsize=16)
    fig.tight_layout(pad=0)
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, f"retain_token_stat_{fig_title}.jpg")
    fig.savefig(path, dpi=300)
    plt.close(fig)
    return path


def retained_token_analyze(feature_dict_path: str, output_dir=None) -> int:
    """Count retained tokens in the two lowest-intensity clusters
    (extract_stats.py:336-381: rank_mean < 2)."""
    _, _, rank_mean, _ = _gathered_patch_stats(feature_dict_path)
    count = int((rank_mean < 2).sum())
    print(count)
    return count


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Extract stats from features")
    p.add_argument("--feature_dict_path", type=str, required=True)
    p.add_argument("--output_dir", type=str, default=".")
    p.add_argument("--visualize_mask", action="store_true")
    p.add_argument("--fig_title", type=str, default="")
    p.add_argument("--kendall_rank_mean", action="store_true")
    p.add_argument("--kendall_rank_std", action="store_true")
    p.add_argument("--retained_token_visualize", action="store_true")
    p.add_argument("--retained_token_analyze", action="store_true")
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    if args.visualize_mask:
        visualize_mask(args.feature_dict_path, args.output_dir)
    elif args.kendall_rank_mean:
        kendall_rank(args.feature_dict_path, args.output_dir, "mean", args.fig_title)
    elif args.kendall_rank_std:
        kendall_rank(args.feature_dict_path, args.output_dir, "std", args.fig_title)
    elif args.retained_token_visualize:
        retained_token_visualize(
            args.feature_dict_path, args.output_dir, args.fig_title or "retained"
        )
    elif args.retained_token_analyze:
        retained_token_analyze(args.feature_dict_path)
    else:
        raise ValueError("Invalid argument")


if __name__ == "__main__":
    main()
