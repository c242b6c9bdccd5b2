"""2D sin-cos positional embeddings (copy of
``tpat_tpu/models/pos_embed.py:17-51``).

Copied rather than imported: importing ``tpat_tpu.models`` imports the flax
model.  The reference's channel quirk is kept bit for bit: the FIRST half of
the channels encodes w, the second half h (``np.meshgrid(grid_w, grid_h)``
puts w in ``grid[0]``).  Every AudioMAE checkpoint was trained against it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def sincos_1d(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    """(M,) positions -> (M, embed_dim): omega = 1/10000^(2i/D), [sin, cos]."""
    if embed_dim % 2:
        raise ValueError(f"embed_dim must be even, got {embed_dim}")
    omega = np.arange(embed_dim // 2, dtype=np.float32)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000**omega
    out = np.einsum("m,d->md", pos.reshape(-1).astype(np.float32), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_2d(
    embed_dim: int, grid_hw: Tuple[int, int], cls_token: bool = False
) -> np.ndarray:
    """(H*W, embed_dim) sin-cos embedding over an (H, W) grid, row-major,
    w encoded in the first half of the channels (see module note)."""
    h, w = grid_hw
    grid_h = np.arange(h, dtype=np.float32)
    grid_w = np.arange(w, dtype=np.float32)
    grid = np.meshgrid(grid_w, grid_h)  # w first, like the reference
    grid = np.stack(grid, axis=0).reshape([2, 1, h, w])
    emb_h = sincos_1d(embed_dim // 2, grid[0])
    emb_w = sincos_1d(embed_dim // 2, grid[1])
    emb = np.concatenate([emb_h, emb_w], axis=1)
    if cls_token:
        emb = np.concatenate([np.zeros([1, embed_dim], dtype=emb.dtype), emb], axis=0)
    return emb
