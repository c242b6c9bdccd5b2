"""2D sin-cos positional embeddings and the checkpoint pos-embed surgery
(copy of ``tpat_tpu/models/pos_embed.py``).

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


# ---------------------------------------------------------------------------
# Checkpoint pos-embed surgery (``tpat_tpu/models/pos_embed.py:54-265``), numpy
# ---------------------------------------------------------------------------


def crop_time_audio_pos_embed(
    pos_embed: np.ndarray,
    orig_size: Tuple[int, int],
    new_size: Tuple[int, int],
    num_extra_tokens: int = 1,
) -> np.ndarray:
    """AudioMAE checkpoint surgery: the patch rows of a (1, extra +
    orig_h*orig_w, D) table are viewed as an (orig_h, orig_w) grid (the
    reference views the AudioSet grid as (8, 64)) and the second axis is
    cropped to new_size[1]; the extra-token rows stay at the front."""
    if orig_size == new_size:
        return pos_embed
    d = pos_embed.shape[-1]
    extras = pos_embed[:, :num_extra_tokens, :]
    patches = pos_embed[:, num_extra_tokens:, :]
    patches = patches.reshape(-1, orig_size[0], orig_size[1], d)
    if new_size[1] > orig_size[1]:
        raise ValueError(
            f"time axis can only be cropped, got {orig_size} -> {new_size}"
        )
    patches = patches[:, :, : new_size[1], :]
    patches = patches.reshape(1, new_size[0] * new_size[1], d)
    return np.concatenate([extras, patches], axis=1)


def _bicubic_resize_torch(
    grid: np.ndarray, out_hw: Tuple[int, int]
) -> np.ndarray:
    """(H, W, D) -> (out_h, out_w, D) as torch ``F.interpolate(mode=
    'bicubic', align_corners=False)``: src = (dst + 0.5) * in/out - 0.5, a
    separable 4-tap Keys cubic with A = -0.75, edge-clamped taps, no
    antialiasing; in float64."""
    a = -0.75

    def axis_weights(n_in, n_out):
        dst = np.arange(n_out, dtype=np.float64)
        src = (dst + 0.5) * (n_in / n_out) - 0.5
        x1 = np.floor(src)
        t = src - x1

        def cc1(x):  # |x| <= 1
            return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0

        def cc2(x):  # 1 < |x| < 2
            return ((a * x - 5.0 * a) * x + 8.0 * a) * x - 4.0 * a

        w = np.stack([cc2(t + 1.0), cc1(t), cc1(1.0 - t), cc2(2.0 - t)], 1)
        idx = np.stack([x1 - 1, x1, x1 + 1, x1 + 2], 1).astype(np.int64)
        return w, np.clip(idx, 0, n_in - 1)

    return _separable(grid, out_hw, axis_weights)


def _bilinear_resize_torch(
    grid: np.ndarray, out_hw: Tuple[int, int]
) -> np.ndarray:
    """(H, W, D) -> (out_h, out_w, D) as torch ``F.interpolate(mode=
    'bilinear', align_corners=False)``: src = max((dst + 0.5) * in/out -
    0.5, 0), then a 2-tap lerp with edge-clamped taps; in float64."""

    def axis_weights(n_in, n_out):
        dst = np.arange(n_out, dtype=np.float64)
        src = (dst + 0.5) * (n_in / n_out) - 0.5
        src = np.maximum(src, 0.0)
        x0 = np.floor(src)
        t = src - x0
        w = np.stack([1.0 - t, t], 1)
        idx = np.stack([x0, x0 + 1], 1).astype(np.int64)
        return w, np.clip(idx, 0, n_in - 1)

    return _separable(grid, out_hw, axis_weights)


def _separable(grid, out_hw, axis_weights):
    h, w, _d = grid.shape
    oh, ow = out_hw
    wy, iy = axis_weights(h, oh)
    wx, ix = axis_weights(w, ow)
    g = grid.astype(np.float64)
    rows = (g[iy] * wy[:, :, None, None]).sum(axis=1)  # (oh, W, D)
    out = (rows[:, ix] * wx[None, :, :, None]).sum(axis=2)  # (oh, ow, D)
    return out.astype(grid.dtype)


def interpolate_square_pos_embed(
    pos_embed: np.ndarray, new_size: int, num_extra_tokens: int = 1
) -> np.ndarray:
    """Square bicubic interpolation, for image-pretrained checkpoints whose
    grid side differs from the target."""
    d = pos_embed.shape[-1]
    n = pos_embed.shape[1] - num_extra_tokens
    orig = int(n ** 0.5)
    if orig == new_size:
        return pos_embed
    extras = pos_embed[:, :num_extra_tokens]
    grid = pos_embed[:, num_extra_tokens:].reshape(orig, orig, d)
    grid = _bicubic_resize_torch(grid, (new_size, new_size))
    return np.concatenate(
        [extras, grid.reshape(1, new_size * new_size, d)], axis=1
    )


def interpolate_img2audio_pos_embed(
    pos_embed: np.ndarray,
    orig_size: Tuple[int, int],
    new_size: Tuple[int, int],
    num_extra_tokens: int = 1,
) -> np.ndarray:
    """Rectangular bicubic interpolation of an image grid (e.g. 14x14) to an
    audio grid (e.g. 8x64)."""
    if orig_size == new_size:
        return pos_embed
    d = pos_embed.shape[-1]
    extras = pos_embed[:, :num_extra_tokens]
    grid = pos_embed[:, num_extra_tokens:].reshape(
        orig_size[0], orig_size[1], d
    )
    grid = _bicubic_resize_torch(grid, new_size)
    return np.concatenate(
        [extras, grid.reshape(1, new_size[0] * new_size[1], d)], axis=1
    )


def deit_img2audio_pos_embed(
    pos_embed: np.ndarray,
    f_dim: int,
    t_dim: int,
    num_extra_tokens: int = 2,
) -> np.ndarray:
    """AST ImageNet-DeiT surgery: the square (hw, hw) grid behind the CLS and
    distillation rows is adapted time axis first, then frequency; an axis
    whose target fits inside hw is centre-cut (``[hw//2 - dim//2 :
    hw//2 - dim//2 + dim]``), a larger one is torch-bilinear interpolated
    (the second interpolation only ever stretches frequency)."""
    d = pos_embed.shape[-1]
    n = pos_embed.shape[1] - num_extra_tokens
    hw = int(round(n ** 0.5))
    if hw * hw != n:
        raise ValueError(f"DeiT pos-embed grid is square; got {n} patches")
    extras = pos_embed[:, :num_extra_tokens]
    grid = pos_embed[:, num_extra_tokens:].reshape(hw, hw, d)
    if t_dim <= hw:
        start = int(hw / 2) - int(t_dim / 2)
        grid = grid[:, start : start + t_dim, :]
    else:
        grid = _bilinear_resize_torch(grid, (hw, t_dim))
    if f_dim <= hw:
        start = int(hw / 2) - int(f_dim / 2)
        grid = grid[start : start + f_dim, :, :]
    else:
        grid = _bilinear_resize_torch(grid, (f_dim, t_dim))
    return np.concatenate(
        [extras, grid.reshape(1, f_dim * t_dim, d)], axis=1
    )


def sum_rgb_patch_embed(weight: np.ndarray) -> np.ndarray:
    """RGB -> 1-channel patch embed by a channel sum, on the torch conv
    layout (O, C, kh, kw); the JAX function takes flax's (kh, kw, C, O)."""
    return weight.sum(axis=1, keepdims=True)


def center_crop_time_ast_pos_embed(
    pos_embed: np.ndarray,
    t_dim: int,
    f_dim: int = 8,
    num_extra_tokens: int = 2,
) -> np.ndarray:
    """AST AudioSet-checkpoint surgery: the 512 patch rows are viewed as
    (8, 64) and the time axis is centre-cropped to t_dim, columns
    [32 - t_dim//2, 32 - t_dim//2 + t_dim)."""
    if f_dim != 8:
        raise ValueError("AST AudioSet grid is (8, 64); f_dim must be 8")
    d = pos_embed.shape[-1]
    extras = pos_embed[:, :num_extra_tokens, :]
    patches = pos_embed[:, num_extra_tokens:, :]
    grid = patches.reshape(1, 8, 64, d)
    if t_dim < 64:
        start = 32 - int(t_dim / 2)
        grid = grid[:, :, start : start + t_dim, :]
    elif t_dim > 64:
        raise ValueError(f"t_dim={t_dim} > 64 not supported")
    patches = grid.reshape(1, 8 * t_dim, d)
    return np.concatenate([extras, patches], axis=1)
