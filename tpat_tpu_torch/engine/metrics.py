"""Evaluation statistics (``tpat_tpu/engine/metrics.py``), host-side numpy.

The JAX module takes AP, AUC and the precision-recall and ROC points from
scikit-learn, which the card's image does not have; this copy computes them
in numpy with scikit-learn's conventions:

- the curves rank by descending score and put tied scores at one threshold
  (``_binary_clf_curve``);
- average precision is the step sum ``-sum(diff(recall) * precision[:-1])``;
- the ROC AUC is trapezoidal over the curve, so ties count one half, and is
  NaN when the targets hold one class only (scikit-learn 1.6 on; earlier
  versions raised);
- ``roc_curve`` drops the collinear points, as ``drop_intermediate=True``.

``calculate_stats`` returns per-class dicts with AP, AUC, subsampled
precision/recall and ROC points and a global argmax accuracy; mAP is the
mean of the per-class APs.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
from scipy import stats as scipy_stats


def _binary_targets(y_true: np.ndarray) -> np.ndarray:
    y = np.asarray(y_true)
    if not np.all((y == 0) | (y == 1)):
        raise ValueError("targets must be 0 or 1 for AP and AUC")
    return y == 1


def _binary_clf_curve(
    y_true: np.ndarray, y_score: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """False and true positives at each distinct score, descending."""
    pos = _binary_targets(y_true)
    y_score = np.asarray(y_score)
    order = np.argsort(y_score, kind="mergesort")[::-1]
    y_score = y_score[order]
    pos = pos[order]
    distinct = np.where(np.diff(y_score))[0]
    thr_idx = np.r_[distinct, pos.size - 1]
    tps = np.cumsum(pos, dtype=np.float64)[thr_idx]
    fps = 1 + thr_idx - tps
    return fps, tps, y_score[thr_idx]


def precision_recall_curve(y_true, y_score):
    """(precision, recall, thresholds), recall descending, ending at
    (precision 1, recall 0)."""
    fps, tps, thresholds = _binary_clf_curve(y_true, y_score)
    ps = tps + fps
    precision = np.zeros_like(tps)
    np.divide(tps, ps, out=precision, where=ps != 0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    return (np.hstack((precision[::-1], 1)), np.hstack((recall[::-1], 0)),
            thresholds[::-1])


def average_precision(y_true, y_score) -> float:
    precision, recall, _ = precision_recall_curve(y_true, y_score)
    return float(-np.sum(np.diff(recall) * precision[:-1]))


def roc_curve(y_true, y_score):
    """(fpr, tpr, thresholds) from (0, 0), the first threshold +inf."""
    fps, tps, thresholds = _binary_clf_curve(y_true, y_score)
    if len(fps) > 2:
        keep = np.where(np.r_[
            True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True
        ])[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps = np.r_[0, tps]
    fps = np.r_[0, fps]
    thresholds = np.r_[np.inf, thresholds]
    fpr = np.repeat(np.nan, fps.shape) if fps[-1] <= 0 else fps / fps[-1]
    tpr = np.repeat(np.nan, tps.shape) if tps[-1] <= 0 else tps / tps[-1]
    return fpr, tpr, thresholds


def roc_auc(y_true, y_score) -> float:
    if np.unique(_binary_targets(y_true)).size != 2:
        return float("nan")
    fpr, tpr, _ = roc_curve(y_true, y_score)
    # the trapezoid sum in numpy's own order (np.trapezoid, np.trapz)
    return float((np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0).sum())


def d_prime(auc: float) -> float:
    return scipy_stats.norm().ppf(auc) * np.sqrt(2.0)


def calculate_stats(
    output: np.ndarray, target: np.ndarray, save_every_steps: int = 1000
) -> List[Dict]:
    classes_num = target.shape[-1]
    acc = float(np.mean(np.argmax(target, 1) == np.argmax(output, 1)))
    out = []
    for k in range(classes_num):
        avg_precision = average_precision(target[:, k], output[:, k])
        try:
            auc = roc_auc(target[:, k], output[:, k])
            fpr, tpr, _ = roc_curve(target[:, k], output[:, k])
        except ValueError:  # targets that are not 0/1
            auc, fpr, tpr = np.nan, np.array([0.0]), np.array([0.0])
        precisions, recalls, _ = precision_recall_curve(
            target[:, k], output[:, k]
        )
        out.append(
            {
                "precisions": precisions[0::save_every_steps],
                "recalls": recalls[0::save_every_steps],
                "AP": avg_precision,
                "fpr": fpr[0::save_every_steps],
                "fnr": 1.0 - tpr[0::save_every_steps],
                "auc": auc,
                "acc": acc,
            }
        )
    return out


def mean_average_precision(output: np.ndarray, target: np.ndarray) -> float:
    aps = [
        average_precision(target[:, k], output[:, k])
        for k in range(target.shape[-1])
    ]
    return float(np.mean(aps))


def topk_accuracy(output: np.ndarray, target_idx: np.ndarray, ks=(1, 5)):
    """timm.utils.accuracy semantics: percentage in [0, 100]."""
    order = np.argsort(-output, axis=1)
    out = []
    for k in ks:
        correct = (order[:, :k] == target_idx[:, None]).any(axis=1)
        out.append(100.0 * correct.mean())
    return out
