"""Feature extraction files (port of ``tpat_tpu/utils/features.py``): each
eval batch's feature dict written as ``{key}.{batch_idx:04d}.pth``, the
reference's naming, and a combiner that globs one key's files in order and
concatenates them.

The port always has torch, so it always writes ``.pth``.  The combiner also
reads the ``.npy`` files the JAX writer leaves on a host without torch, so
either package's feature directory feeds either package's analysis.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Union

import numpy as np
import torch


class FeatureWriter:
    """``writer(feature_dict, batch_idx)`` saves every entry of the dict:
    arrays as tensors, label lists as lists."""

    def __init__(self, path: str):
        os.makedirs(path, exist_ok=True)
        self.path = path

    def __call__(self, feature_dict: Dict, batch_idx: int):
        for key, value in feature_dict.items():
            if hasattr(value, "shape") and not isinstance(value, torch.Tensor):
                value = torch.from_numpy(np.asarray(value))
            torch.save(value, os.path.join(self.path, f"{key}.{batch_idx:04d}.pth"))


def _load_one(fname: str):
    if fname.endswith(".pth"):
        v = torch.load(fname, map_location="cpu", weights_only=False)
        return v.numpy() if isinstance(v, torch.Tensor) else v
    return np.load(fname, allow_pickle=True)


def combine_feature_dict(path: str, key: str) -> Optional[Union[np.ndarray, List]]:
    """Every ``{key}.*.pth`` and ``{key}.*.npy`` under ``path`` in name order,
    concatenated along axis 0 (label lists as one list); None when the key
    has no file, which the analysis loops stop on."""
    files = sorted(
        glob.glob(os.path.join(path, f"{key}.*.pth"))
        + glob.glob(os.path.join(path, f"{key}.*.npy"))
    )
    if not files:
        return None
    parts = [_load_one(f) for f in files]
    if isinstance(parts[0], list) or parts[0].dtype == object:
        out: List = []
        for p in parts:
            out.extend(list(p))
        return out
    return np.concatenate(parts, axis=0)
