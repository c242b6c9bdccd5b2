"""Result reducers (port of ``tpat_tpu/analysis/reducers.py``): the
reference's ``audiomae/average_esc50_score.py`` (average the scores in
``best-*.txt``-style marker files over a 5-fold x 5-seed experiment tree)
and ``ast/egs/esc50/get_esc_result.py`` (average column 1 of
``best_result.csv`` files), plus the per-block Kendall-tau line plot
(``audiomae/stats/draw_kendall_graph.py``)::

    python -m tpat_tpu_torch.analysis.reducers exp/esc50 [--csv]
    python -m tpat_tpu_torch.analysis.reducers stats/kendall_rank_mean.json \\
        --kendall_plot

Numpy and argparse only; the plot imports matplotlib when it runs.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
from typing import Optional


def read_score_file(path: str) -> Optional[float]:
    """First line of a score file as float (average_esc50_score.py:15-25)."""
    with open(path) as f:
        line = f.readline().strip()
    try:
        return float(line)
    except ValueError:
        return None


def score_from_marker_name(path: str) -> Optional[float]:
    """Parse ``best-{epoch:03d}-{score}.txt`` file names."""
    m = re.search(r"best-\d{3}-(\d+\.\d{4})\.txt", os.path.basename(path))
    return float(m.group(1)) if m else None


def average_scores(root_dir: str, pattern: str = "best-") -> Optional[float]:
    """Walk the experiment tree and average matching score files.  Marker
    files (empty, score in the name) and result files (score in line 1)
    are both handled.

    The aggregate this function itself writes (``{pattern}-{avg}.txt``)
    is excluded from the scan: the reference
    (average_esc50_score.py:57-59) writes the same file into the tree it
    scans and silently double-counts it on every rerun — a compounding
    bias, not a behavior worth porting."""
    own_output = re.compile(rf"^{re.escape(pattern)}-\d+\.\d{{4}}\.txt$")
    total, count = 0.0, 0
    for dirpath, _dirs, files in os.walk(root_dir):
        for name in files:
            if name.startswith(pattern) and name.endswith(".txt"):
                if own_output.match(name):
                    continue  # a previous run's aggregate
                path = os.path.join(dirpath, name)
                score = score_from_marker_name(path)
                if score is None:
                    score = read_score_file(path)
                if score is not None:
                    total += score
                    count += 1
    if count == 0:
        return None
    avg = total / count
    with open(os.path.join(root_dir, f"{pattern}-{avg:.4f}.txt"), "w") as f:
        f.write(f"{avg:.4f}\n")
    return avg


def average_csv_results(exp_path: str, eval_file_pattern: str = "best_result.csv"):
    """get_esc_result.py: average column 1 of every matching CSV."""
    import numpy as np

    files = glob.glob(
        os.path.join(exp_path, "**", f"{eval_file_pattern}*"), recursive=True
    )
    if not files:
        return None
    accs = [float(np.loadtxt(f, delimiter=",")[1]) for f in files]
    avg = float(np.mean(accs))
    out = os.path.join(
        exp_path, f"average_result_{avg:.4f}-{eval_file_pattern}.txt"
    )
    with open(out, "w") as f:
        f.write(f"Average accuracy: {avg:.4f}")
    return avg


def draw_kendall_graph(json_path: str, title: str = "", out_path: Optional[str] = None):
    """12-block Kendall-tau line chart (draw_kendall_graph.py)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    data = json.load(open(json_path))
    plt.figure(figsize=(10, 2))
    n = max((len(ys) for ys in data.values()), default=12)
    x = np.arange(1, n + 1)
    for label, ys in data.items():
        avg = float(np.mean(ys))
        plt.plot(np.arange(1, len(ys) + 1), ys,
                 label=f"{label} / {avg:.2f}", marker="o")
    plt.ylim(0.0, 1.0)
    plt.ylabel(r"$\tau$", fontsize=16)
    plt.xticks(x)
    plt.legend(fontsize=10, loc="lower right", ncol=3)
    plt.grid(alpha=0.3)
    plt.tight_layout()
    out_path = out_path or f"{json_path}.jpg"
    plt.savefig(out_path)
    plt.close()
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser(description="Average experiment scores")
    p.add_argument("root_directories", nargs="+")
    p.add_argument("--pattern", default="best-")
    p.add_argument("--csv", action="store_true",
                   help="average best_result.csv files instead")
    p.add_argument("--kendall_plot", action="store_true",
                   help="treat the positional paths as kendall-tau JSON "
                        "files and render the 12-block line chart "
                        "(stats/draw_kendall_graph.py equivalent)")
    args = p.parse_args(argv)
    for root in args.root_directories:
        if args.kendall_plot:
            print(f"wrote {draw_kendall_graph(root)}")
            continue
        avg = (
            average_csv_results(root)
            if args.csv
            else average_scores(root, args.pattern)
        )
        if avg is None:
            print(f"No scores found in {root}")
        else:
            print(f"Average score in '{root}': {avg:.4f}")


if __name__ == "__main__":
    main()
