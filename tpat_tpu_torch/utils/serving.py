"""Serving artifacts for the static-pruned eval forward (port of
``tpat_tpu/utils/serving.py``).

The artifact layout is the JAX package's, so either package reads the
other's parameters:

    params.npz   flat {'/'-joined flax path: array} parameter tree
    meta.json    input_shape, input_dtype, batch_sizes (bucketed artifacts)

The port also writes ``meta["vit_config"]`` (the ``ViTConfig`` fields); an
artifact written by the JAX package has none, so ``load_forward`` then needs
``cfg``.  The JAX package's ``.jaxexport`` programs are not read: the port
rebuilds the model from the config and runs it eagerly.

Bucketed artifacts dispatch as the JAX loader does: each request is padded
with zero rows to the smallest bucket that fits and the logits are sliced
back; a request larger than the biggest bucket is chunked by it.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from tpat_tpu_torch.config import ViTConfig
from tpat_tpu_torch.models.vit import AudioViT
from tpat_tpu_torch.utils.weights import jax_flat_from_state_dict, state_dict_from_jax


def _unflatten(flat) -> dict:
    tree: dict = {}
    for k, v in flat.items():
        parts = k.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def export_forward(
    model: AudioViT,
    input_shape: Sequence[int],
    out_dir: str,
    batch_sizes: Optional[Sequence[int]] = None,
) -> str:
    """Write ``model``'s parameters and the serving metadata to ``out_dir``.

    input_shape: ``(batch, 1, target_length, num_mel_bins)``, or AST's
    ``(batch, 1, num_mel_bins, target_length)``.  With
    ``batch_sizes`` (e.g. ``(1, 8, 32, 128)``) the artifact is bucketed and
    the leading dim of ``input_shape`` is ignored; without, the batch size
    is fixed to ``input_shape[0]``.
    """
    os.makedirs(out_dir, exist_ok=True)
    meta = {"input_dtype": "float32"}
    if batch_sizes is None:
        meta["input_shape"] = [int(s) for s in input_shape]
    else:
        buckets = sorted({int(b) for b in batch_sizes})
        if not buckets or buckets[0] < 1:
            raise ValueError(f"batch_sizes must be positive ints: {batch_sizes}")
        meta["input_shape"] = [None] + [int(s) for s in input_shape[1:]]
        meta["batch_sizes"] = buckets
    meta["vit_config"] = dataclasses.asdict(model.cfg)
    np.savez(
        os.path.join(out_dir, "params.npz"),
        **jax_flat_from_state_dict(model.state_dict()),
    )
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f)
    return out_dir


def _config_from_meta(meta: dict) -> ViTConfig:
    if "vit_config" not in meta:
        raise ValueError(
            "artifact has no vit_config (written by the JAX package): pass "
            "cfg to load_forward"
        )
    fields = dict(meta["vit_config"])
    fields["drop_loc"] = tuple(fields["drop_loc"])
    return ViTConfig(**fields)


def load_forward(
    out_dir: str,
    cfg: Optional[ViTConfig] = None,
    device: str = "cuda",
) -> Tuple[Callable, dict]:
    """Load an artifact onto ``device``; returns ``(fn, meta)`` where
    ``fn(x)`` maps a batch of the artifact's input shape ((n, 1, T, F), or
    AST's (n, 1, F, T); numpy or tensor) to (n, classes) f32 logits on
    ``device``."""
    with open(os.path.join(out_dir, "meta.json")) as f:
        meta = json.load(f)
    if cfg is None:
        cfg = _config_from_meta(meta)
    with np.load(os.path.join(out_dir, "params.npz")) as flat:
        params = _unflatten({k: flat[k] for k in flat.files})
    model = AudioViT(cfg, device=device)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    model.eval()

    dtype = getattr(torch, meta["input_dtype"])
    sample_shape = tuple(meta["input_shape"][1:])
    buckets = meta.get("batch_sizes") or [meta["input_shape"][0]]

    @torch.no_grad()
    def _run_padded(chunk: torch.Tensor) -> torch.Tensor:
        n = chunk.shape[0]
        b = next(bb for bb in buckets if bb >= n)  # buckets are sorted
        if n < b:
            pad = chunk.new_zeros((b - n,) + chunk.shape[1:])
            chunk = torch.cat([chunk, pad], dim=0)
        return model(chunk)[:n]

    def fn(x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=dtype, device=device)
        if tuple(x.shape[1:]) != sample_shape:
            raise ValueError(
                f"request shape {tuple(x.shape)} does not match the "
                f"artifact's (n,) + {sample_shape}"
            )
        if x.shape[0] == 0:
            raise ValueError("empty batch")
        if "batch_sizes" not in meta and x.shape[0] != buckets[0]:
            raise ValueError(
                f"artifact is fixed to batch {buckets[0]}, got {x.shape[0]}"
            )
        biggest = buckets[-1]
        outs = [
            _run_padded(x[i:i + biggest]) for i in range(0, x.shape[0], biggest)
        ]
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)

    return fn, meta
