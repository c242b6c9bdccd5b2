"""Analysis primitives behind ``extract_stats`` (port of
``tpat_tpu/analysis/stats.py``), in numpy:

- per-patch mel statistics (mean, std with ddof 1);
- KMeans(5) intensity clusters, remapped so that 0 is the lowest cluster;
- Kendall tau by counting concordant and discordant pairs (ties count as
  concordant);
- top-k index composition across pruning stages;
- patch masking for the visualisations.

The JAX package clusters with scikit-learn, which the card's image lacks.
``kmeans_1d`` is the 1-D case of scikit-learn's ``KMeans(n_clusters,
random_state)`` with its defaults (``sklearn/cluster/_kmeans.py``, 1.9):
the data centred; greedy k-means++ with ``2 + int(log k)`` local trials
from ``np.random.RandomState(random_state)``, its distances in float64 cast
back to the data's dtype; one init; Lloyd with the squared distances
``|c|^2 - 2 x c`` in the data's dtype, the cluster sums accumulated in
order, the empty clusters relocated to the farthest points, ``tol = 1e-4``
times the data's variance and ``max_iter`` 300; then a last E-step.  The
only arithmetic left unreplicated is the order in which scikit-learn's
OpenMP threads add their partial sums over chunks of 256 points.

``colorize_mel`` and ``save_melspec_batch`` import matplotlib when called.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

CHUNK = 256  # scikit-learn's CHUNK_SIZE: the points one Lloyd chunk sums
MAX_ITER, TOL = 300, 1e-4  # KMeans' defaults


def patch_stats_np(mel: np.ndarray, patch: int = 16, kind: str = "mean") -> np.ndarray:
    """(B, 1, H, W) -> (B, h*w) per-patch mean or std, row-major patch order
    (einops 'b c (h p) (w q) -> b (c p q) (h w)')."""
    b, c, hh, ww = mel.shape
    gh, gw = hh // patch, ww // patch
    t = mel.reshape(b, c, gh, patch, gw, patch)
    t = t.transpose(0, 1, 3, 5, 2, 4).reshape(b, c * patch * patch, gh * gw)
    if kind == "mean":
        return t.mean(axis=1)
    if kind == "std":
        return t.std(axis=1, ddof=1)
    raise ValueError(kind)


def _sq_distances(a: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Squared distances of (m, 1) points ``a`` to (n, 1) points ``x`` as
    scikit-learn's ``_euclidean_distances`` takes them: in float64,
    -2 a.x + |a|^2 + |x|^2, cast to the data's dtype, floored at 0."""
    a64, x64 = a.astype(np.float64), x.astype(np.float64)
    d = -2 * (a64 @ x64.T)
    d += np.einsum("ij,ij->i", a64, a64)[:, None]
    d += np.einsum("ij,ij->i", x64, x64)[None, :]
    return np.maximum(d.astype(x.dtype, copy=False), 0)


def _kmeans_plusplus(x: np.ndarray, k: int, rs: np.random.RandomState) -> np.ndarray:
    n = x.shape[0]
    weight = np.ones(n, dtype=x.dtype)
    centers = np.empty((k, 1), dtype=x.dtype)
    trials = 2 + int(np.log(k))
    first = rs.choice(n, p=weight / weight.sum())
    centers[0] = x[first]
    closest = _sq_distances(centers[0, np.newaxis], x)
    pot = closest @ weight
    for c in range(1, k):
        rand_vals = rs.uniform(size=trials) * pot
        ids = np.searchsorted(np.cumsum(weight * closest), rand_vals)
        np.clip(ids, None, closest.size - 1, out=ids)
        dist = _sq_distances(x[ids], x)
        np.minimum(closest, dist, out=dist)
        pots = dist @ weight.reshape(-1, 1)
        best = np.argmin(pots)
        pot = pots[best]
        closest = dist[best]
        centers[c] = x[ids[best]]
    return centers


def _assign(x: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """Labels of the nearest centre by |c|^2 - 2 x c (the first on a tie)."""
    cc = np.einsum("ij,ij->i", centers, centers)
    d = cc[None, :] + (-2 * (x * centers[:, 0][None, :]))
    return np.argmin(d, axis=1).astype(np.int32)


def _lloyd_step(x: np.ndarray, centers: np.ndarray, labels: np.ndarray):
    """One M-step: (new centres, centre shifts).  Each chunk's sums run in
    point order, then the chunks' sums in chunk order."""
    k, dt = centers.shape[0], x.dtype
    sums = np.zeros(k, dtype=dt)
    counts = np.zeros(k, dtype=dt)
    for start in range(0, x.shape[0], CHUNK):
        xs, ls = x[start:start + CHUNK, 0], labels[start:start + CHUNK]
        for j in range(k):
            vals = xs[ls == j]
            if vals.size:
                sums[j] += np.cumsum(vals, dtype=dt)[-1]
                counts[j] += dt.type(vals.size)
    empty = np.where(counts == 0)[0]
    if empty.size:
        dist = ((x - centers[labels]) ** 2).sum(axis=1)
        far = np.argpartition(dist, -empty.size)[:-empty.size - 1:-1]
        if np.max(dist) != 0:
            for new, idx in zip(empty, far):
                old = labels[idx]
                sums[old] -= x[idx, 0]
                sums[new] = x[idx, 0]
                counts[new] = 1
                counts[old] -= 1
    # scikit-learn's _average_centers, in its order: an empty cluster takes
    # the biggest one's entry as it stands at that point of the loop
    new_centers = sums.reshape(k, 1).copy()
    biggest = np.argmax(counts)
    for j in range(k):
        if counts[j] > 0:
            new_centers[j, 0] *= dt.type(1.0 / np.float64(counts[j]))
        else:
            new_centers[j, 0] = new_centers[biggest, 0]
    diff = (new_centers[:, 0] - centers[:, 0]).astype(dt)
    shift = np.sqrt((diff * diff).astype(np.float64)).astype(dt)
    return new_centers, shift


def kmeans_1d(
    values: np.ndarray, n_clusters: int = 5, random_state: int = 123,
) -> np.ndarray:
    """The cluster label of every value, as
    ``KMeans(n_clusters, random_state=random_state).fit_predict(values.reshape(-1, 1))``."""
    x = np.array(values, copy=True).reshape(-1, 1)
    if x.dtype not in (np.float32, np.float64):
        x = x.astype(np.float64)
    if x.shape[0] < n_clusters:
        raise ValueError(
            f"n_samples={x.shape[0]} should be >= n_clusters={n_clusters}."
        )
    tol = np.mean(np.var(x, axis=0)) * TOL
    x -= x.mean(axis=0)
    centers = _kmeans_plusplus(x, n_clusters, np.random.RandomState(random_state))
    labels_old = np.full(x.shape[0], -1, dtype=np.int32)
    strict = False
    for _ in range(MAX_ITER):
        labels = _assign(x, centers)
        centers, shift = _lloyd_step(x, centers, labels)
        if np.array_equal(labels, labels_old):
            strict = True
            break
        if (shift ** 2).sum() <= tol:
            break
        labels_old = labels
    if not strict:
        labels = _assign(x, centers)
    return labels


def kmeans_rank(
    stat: np.ndarray, n_clusters: int = 5, random_state: int = 123
) -> Tuple[np.ndarray, List[Tuple[float, float, float]]]:
    """KMeans over the flattened per-patch stat, cluster ids remapped so
    that 0 is the lowest-intensity cluster (``stats.py:34-63``).  Returns
    (rank (B, P) float32, [(min, max, share)] in ascending order); a
    cluster left without members (fewer distinct values than clusters) is
    skipped."""
    labels = kmeans_1d(stat, n_clusters, random_state).reshape(stat.shape)
    info = []
    for cid in range(n_clusters):
        vals = stat[labels == cid]
        if vals.size == 0:
            continue
        info.append((cid, float(vals.min()), float(vals.max()), vals.size))
    info.sort(key=lambda x: x[1])
    out = np.zeros_like(labels, dtype=np.float32)
    for new, (old, *_rest) in enumerate(info):
        out[labels == old] = new
    return out, [(mn, mx, size / stat.size) for (_cid, mn, mx, size) in info]


def kendall_tau_pairs(attn_score: np.ndarray, rank: np.ndarray) -> float:
    """Kendall coefficient over a batch: concordant and discordant pairs of
    the upper triangle, ties counted as concordant.  attn_score, rank:
    (B, N)."""
    b, n = attn_score.shape
    concordant = discordant = 0
    iu = np.triu_indices(n, k=1)
    for i in range(b):
        ad = attn_score[i][None, :] - attn_score[i][:, None]
        rd = rank[i][None, :] - rank[i][:, None]
        prod = (ad * rd)[iu]
        concordant += int((prod >= 0).sum())
        discordant += int((prod < 0).sum())
    tau = (concordant - discordant) / ((n * (n - 1) // 2) * b)
    if not -1.0 <= tau <= 1.0:
        raise AssertionError(f"tau {tau} out of [-1, 1]")
    return tau


def compose_melspec_idx(idx_stages: List[np.ndarray]) -> List[np.ndarray]:
    """Kept-token indices of every pruning stage in the original patch
    grid: stage i's indices address stage i-1's survivors."""
    out = [np.array(idx_stages[0])]
    for idx in idx_stages[1:]:
        out.append(np.take_along_axis(out[-1], np.array(idx), axis=1))
    return out


def apply_patch_mask(
    img: np.ndarray, idx: np.ndarray, patch_size: int = 16
) -> np.ndarray:
    """Zero every patch of (B, C, H, W) ``img`` that is not in ``idx``
    ((B, T) indices into the (h, w) patch grid)."""
    b, c, hh, ww = img.shape
    gh, gw = hh // patch_size, ww // patch_size
    t = img.reshape(b, c, gh, patch_size, gw, patch_size)
    t = t.transpose(0, 1, 3, 5, 2, 4).reshape(
        b, c * patch_size * patch_size, gh * gw
    )
    out = np.zeros_like(t)
    ii = np.arange(b)[:, None]
    out[ii, :, idx] = t[ii, :, idx]
    out = out.reshape(b, c, patch_size, patch_size, gh, gw)
    return out.transpose(0, 1, 4, 2, 5, 3).reshape(b, c, hh, ww)


def colorize_mel(mel: np.ndarray) -> np.ndarray:
    """(B, T, F) raw mel -> (B, 3, T, F) viridis RGB."""
    from matplotlib.pyplot import get_cmap

    rgb = get_cmap("viridis")(mel)[..., :3]
    return rgb.transpose(0, 3, 1, 2).astype(np.float32)


def save_melspec_batch(
    batch: np.ndarray, path: str, file_name: str, start_idx: int = 0,
    labels: Optional[List[str]] = None,
):
    """Save each (3, H, W) image rotated 90 degrees counter-clockwise;
    ``file_name`` is formatted with the item's index and label."""
    import matplotlib.pyplot as plt

    os.makedirs(path, exist_ok=True)
    for i, img in enumerate(batch):
        img = np.rot90(img.transpose(1, 2, 0), k=1)
        label = labels[i] if labels is not None else ""
        fname = file_name.format(start_idx + i, label)
        plt.imsave(os.path.join(path, fname), np.clip(img, 0, 1))
