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

A waveform artifact (``frontend=``, ``meta["frontend"]["input"] ==
"waveform"``, the JAX package's schema) takes raw PCM (n, num_samples):
``load_forward`` runs the device frontend (``ops/frontend.py``: fbank, pad
with the clip's minimum, normalisation; AST's transpose where
``ast_orientation``) before the model, whichever package wrote the
artifact.  Its padding contract is in the meta: a short clip carries a NaN
tail, VoxCeleb's left pad a NaN head of a multiple of 160 samples.  The
bucket padding stays zero rows, never NaN rows, which have no real frame.
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
from tpat_tpu_torch.ops.frontend import FrontendConfig, device_frontend
from tpat_tpu_torch.utils import tracing
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
    frontend: Optional[FrontendConfig] = None,
    ast_orientation: bool = False,
) -> str:
    """Write ``model``'s parameters and the serving metadata to ``out_dir``.

    input_shape: ``(batch, 1, target_length, num_mel_bins)``, or AST's
    ``(batch, 1, num_mel_bins, target_length)``; with ``frontend``, raw
    waveforms ``(batch, num_samples)``.  With ``batch_sizes`` (e.g.
    ``(1, 8, 32, 128)``) the artifact is bucketed and the leading dim of
    ``input_shape`` is ignored; without, the batch size is fixed to
    ``input_shape[0]``.  ``ast_orientation``: with ``frontend``, transpose
    the spectrogram to AST's (B, 1, F, T) before the model.
    """
    os.makedirs(out_dir, exist_ok=True)
    meta = {"input_dtype": "float32"}
    if frontend is not None:
        meta["frontend"] = {
            "input": "waveform",
            "num_samples": int(input_shape[-1]),
            "sample_rate": frontend.sample_rate,
            "num_mel_bins": frontend.num_mel_bins,
            "target_length": frontend.target_length,
            "norm_mean": frontend.norm_mean,
            "norm_std": frontend.norm_std,
            "ast_orientation": bool(ast_orientation),
            "padding_contract": (
                "pad short clips to num_samples with NaN at the TAIL "
                "(frames the true length cannot produce take the clip's "
                "fbank.min() fill, dataset.py:218-225); an optional NaN "
                "HEAD (VoxCeleb lr_pad) must be a multiple of the "
                "160-sample frame shift; fully-finite inputs unaffected"
            ),
        }
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
    ``fn(x)`` maps a batch of the artifact's input shape ((n, 1, T, F),
    AST's (n, 1, F, T), or (n, num_samples) waveforms; numpy or tensor) to
    (n, classes) f32 logits on ``device``; each call is traced as
    ``serve.request``."""
    with open(os.path.join(out_dir, "meta.json")) as f:
        meta = json.load(f)
    if cfg is None:
        cfg = _config_from_meta(meta)
    with np.load(os.path.join(out_dir, "params.npz")) as flat:
        params = _unflatten({k: flat[k] for k in flat.files})
    model = AudioViT(cfg, device=device)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    model.eval()

    front = meta.get("frontend")
    if front is not None and front.get("input") == "waveform":
        fcfg = FrontendConfig(
            sample_rate=front["sample_rate"], num_mel_bins=front["num_mel_bins"],
            target_length=front["target_length"], norm_mean=front["norm_mean"],
            norm_std=front["norm_std"],
        )

        def forward(wav: torch.Tensor) -> torch.Tensor:
            spec = device_frontend(wav, fcfg)
            return model(spec.transpose(2, 3) if front["ast_orientation"] else spec)
    else:
        forward = model

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
        return forward(chunk)[:n]

    def fn(x) -> torch.Tensor:
        with tracing.span("serve.request"):
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
                    f"artifact is fixed to batch {buckets[0]}, got "
                    f"{x.shape[0]}"
                )
            biggest = buckets[-1]
            outs = [_run_padded(x[i:i + biggest])
                    for i in range(0, x.shape[0], biggest)]
            return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)

    return fn, meta
