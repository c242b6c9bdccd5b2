"""Weights across the two packages and the reference ``.pth`` layout.

- ``state_dict_from_jax``: a flax param tree (numpy leaves) -> the AudioMAE
  state dict, through the JAX package's own exporter
  ``tpat_tpu.utils.torch_export.audiomae_state_dict`` (pure numpy);
- ``jax_flat_from_state_dict``: its inverse, as the ``'/'``-joined flat flax
  keys the serving artifact's ``params.npz`` holds;
- ``jax_flat_grads``: a module's parameter gradients under the same flat
  flax keys, to hold them against ``jax.grad``'s tree;
- ``load_pth``: a reference ``.pth``, unwrapped from AudioMAE's
  ``{'model': state_dict}`` envelope.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from tpat_tpu.utils.torch_export import audiomae_state_dict

_LAYERNORMS = ("norm1", "norm2", "fc_norm")


def state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax AudioViT params -> tensors ``AudioViT.load_state_dict(strict=
    True)`` takes."""
    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32))
        for k, v in audiomae_state_dict(params).items()
    }


def jax_flat_from_state_dict(
    sd: Mapping[str, torch.Tensor]
) -> Dict[str, np.ndarray]:
    """AudioMAE state dict -> flat flax params: ``blocks.3.attn.qkv.weight``
    becomes ``blocks_3/attn/qkv/kernel`` (transposed), a conv weight
    (O, I, kh, kw) becomes a (kh, kw, I, O) kernel, a LayerNorm weight its
    ``scale``."""
    flat: Dict[str, np.ndarray] = {}
    for key, t in sd.items():
        a = t.detach().to("cpu", torch.float32).numpy()
        if "." not in key:  # cls_token, pos_embed
            flat[key] = a
            continue
        module, leaf = key.rsplit(".", 1)
        path = module.replace("blocks.", "blocks_").replace(".", "/")
        if leaf == "bias":
            flat[f"{path}/bias"] = a
        elif module.rsplit(".", 1)[-1] in _LAYERNORMS:
            flat[f"{path}/scale"] = a
        elif a.ndim == 4:
            flat[f"{path}/kernel"] = np.ascontiguousarray(a.transpose(2, 3, 1, 0))
        else:
            flat[f"{path}/kernel"] = np.ascontiguousarray(a.T)
    return flat


def jax_flat_grads(
    named_grads: Mapping[str, Optional[torch.Tensor]]
) -> Dict[str, np.ndarray]:
    """Gradients by parameter name (``(name, p.grad)`` pairs, or names
    zipped with ``torch.autograd.grad``'s result) -> flat flax keys, by the
    key and layout rule of ``jax_flat_from_state_dict``.  Parameters without
    a gradient (the frozen pos_embed) are left out."""
    return jax_flat_from_state_dict(
        {k: g for k, g in named_grads.items() if g is not None}
    )


def load_pth(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference ``.pth`` state dict (tensors only), unwrapping the
    AudioMAE ``{'model': state_dict, ...}`` envelope."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and isinstance(obj.get("model"), dict):
        obj = obj["model"]
    return {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}
