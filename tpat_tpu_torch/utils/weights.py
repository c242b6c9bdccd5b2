"""Weights across the two packages and the reference ``.pth`` layout.

- ``state_dict_from_jax``: a flax AudioViT param tree (numpy leaves) -> the
  state dict of the port's model, AudioMAE or AST (``flavor``);
- ``ast_state_dict``: the same AST tree -> the reference AST ``.pth``
  layout (``module.v.*`` and ``module.mlp_head.{0,1}.*``);
- ``mae_state_dict_from_jax``: flax MAE params -> the reference pretraining
  model's state dict, which ``models.mae.MaskedAutoencoderViT`` loads;
- ``jax_flat_from_state_dict``: their inverse, as the ``'/'``-joined flat
  flax keys (the serving artifact's ``params.npz`` holds these);
- ``jax_flat_grads``: a module's parameter gradients under the same flat
  flax keys, to hold them against ``jax.grad``'s tree;
- ``load_pth``: a reference ``.pth``, unwrapped from AudioMAE's
  ``{'model': state_dict}`` envelope (``state_dict_of``).

The exporter helpers are the port's own copies of
``tpat_tpu/utils/torch_export.py:19-128`` (pure numpy), so the port
imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

# the LayerNorm modules of AudioViT and of the MAE (their weight is flax's
# ``scale``)
_LAYERNORMS = ("norm1", "norm2", "fc_norm", "norm", "decoder_norm",
               "mlp_head_norm")
# AST's head modules -> their flax names
_AST_HEAD = {"mlp_head.0": "mlp_head_norm", "mlp_head.1": "mlp_head"}


def _t(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32).T)


def _linear(dst: Dict, prefix: str, p: Mapping):
    dst[f"{prefix}.weight"] = _t(p["kernel"])
    if "bias" in p:
        dst[f"{prefix}.bias"] = np.asarray(p["bias"], dtype=np.float32)


def _layernorm(dst: Dict, prefix: str, p: Mapping):
    dst[f"{prefix}.weight"] = np.asarray(p["scale"], dtype=np.float32)
    dst[f"{prefix}.bias"] = np.asarray(p["bias"], dtype=np.float32)


def _conv(dst: Dict, prefix: str, p: Mapping):
    k = np.asarray(p["kernel"], dtype=np.float32)  # (kh, kw, I, O)
    dst[f"{prefix}.weight"] = np.ascontiguousarray(k.transpose(3, 2, 0, 1))
    if "bias" in p:
        dst[f"{prefix}.bias"] = np.asarray(p["bias"], dtype=np.float32)


def _block(dst: Dict, prefix: str, p: Mapping):
    _layernorm(dst, f"{prefix}.norm1", p["norm1"])
    _layernorm(dst, f"{prefix}.norm2", p["norm2"])
    _linear(dst, f"{prefix}.attn.qkv", p["attn"]["qkv"])
    _linear(dst, f"{prefix}.attn.proj", p["attn"]["proj"])
    _linear(dst, f"{prefix}.mlp.fc1", p["mlp"]["fc1"])
    _linear(dst, f"{prefix}.mlp.fc2", p["mlp"]["fc2"])


def audiomae_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {
        "cls_token": np.asarray(params["cls_token"], dtype=np.float32),
        "pos_embed": np.asarray(params["pos_embed"], dtype=np.float32),
    }
    _conv(sd, "patch_embed.proj", params["patch_embed"]["proj"])
    for name, p in params.items():
        if name.startswith("blocks_"):
            _block(sd, f"blocks.{int(name.split('_')[1])}", p)
    if "fc_norm" in params:
        _layernorm(sd, "fc_norm", params["fc_norm"])
    if "head" in params:
        _linear(sd, "head", params["head"])
    return sd


def ast_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """AST flax params -> the reference AST ``.pth`` layout."""
    sd: Dict[str, np.ndarray] = {}
    v: Dict[str, np.ndarray] = {
        k: np.asarray(params[k], dtype=np.float32)
        for k in ("cls_token", "dist_token", "pos_embed")
    }
    _conv(v, "patch_embed.proj", params["patch_embed"]["proj"])
    for name, p in params.items():
        if name.startswith("blocks_"):
            _block(v, f"blocks.{int(name.split('_')[1])}", p)
    _layernorm(v, "norm", params["norm"])
    for k, val in v.items():
        sd[f"module.v.{k}"] = val
    _layernorm(sd, "module.mlp_head.0", params["mlp_head_norm"])
    _linear(sd, "module.mlp_head.1", params["mlp_head"])
    return sd


def _swin_v2_cr_block(dst: Dict, prefix: str, p: Mapping):
    """flax SwinBlock params -> timm SwinTransformerV2CrBlock key layout."""
    _layernorm(dst, f"{prefix}.norm1", p["norm1"])
    _layernorm(dst, f"{prefix}.norm2", p["norm2"])
    _linear(dst, f"{prefix}.attn.qkv", p["attn"]["qkv"])
    _linear(dst, f"{prefix}.attn.proj", p["attn"]["proj"])
    dst[f"{prefix}.attn.logit_scale"] = np.asarray(
        p["attn"]["logit_scale"], dtype=np.float32
    )
    _linear(dst, f"{prefix}.attn.meta_mlp.fc1", p["attn"]["meta_fc1"])
    _linear(dst, f"{prefix}.attn.meta_mlp.fc2", p["attn"]["meta_fc2"])
    _linear(dst, f"{prefix}.mlp.fc1", p["mlp"]["fc1"])
    _linear(dst, f"{prefix}.mlp.fc2", p["mlp"]["fc2"])


def mae_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """Full MAE (encoder + decoder) flax params -> the reference pretraining
    model's state_dict layout (``models_mae.py:25-464``)."""
    sd: Dict[str, np.ndarray] = {
        "cls_token": np.asarray(params["cls_token"], dtype=np.float32),
        "pos_embed": np.asarray(params["pos_embed"], dtype=np.float32),
        "mask_token": np.asarray(params["mask_token"], dtype=np.float32),
        "decoder_pos_embed": np.asarray(
            params["decoder_pos_embed"], dtype=np.float32
        ),
    }
    _conv(sd, "patch_embed.proj", params["patch_embed"]["proj"])
    _layernorm(sd, "norm", params["norm"])
    _linear(sd, "decoder_embed", params["decoder_embed"])
    _layernorm(sd, "decoder_norm", params["decoder_norm"])
    _linear(sd, "decoder_pred", params["decoder_pred"])
    for name, p in params.items():
        if name.startswith("blocks_"):
            _block(sd, f"blocks.{int(name.split('_')[1])}", p)
        elif name.startswith("decoder_blocks_"):
            i = int(name.rsplit("_", 1)[1])
            if "logit_scale" in p["attn"]:
                _swin_v2_cr_block(sd, f"decoder_blocks.{i}", p)
            else:
                _block(sd, f"decoder_blocks.{i}", p)
    return sd


def _tensors(sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in sd.items()}


def state_dict_from_jax(
    params: Mapping, flavor: Optional[str] = None
) -> Dict[str, torch.Tensor]:
    """Flax AudioViT params -> tensors ``AudioViT.load_state_dict(strict=
    True)`` takes.  ``flavor`` 'audiomae' or 'ast'; None reads it from the
    tree (AST's holds a ``dist_token``).  The AST keys are the reference
    layout's without its ``module.v.``/``module.`` prefixes."""
    if flavor is None:
        flavor = "ast" if "dist_token" in params else "audiomae"
    if flavor == "audiomae":
        return _tensors(audiomae_state_dict(params))
    if flavor != "ast":
        raise ValueError(f"flavor must be 'audiomae' or 'ast', got {flavor!r}")
    return _tensors({
        k.removeprefix("module.").removeprefix("v."): v
        for k, v in ast_state_dict(params).items()
    })


def mae_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax MaskedAutoencoderViT params -> tensors
    ``models.mae.MaskedAutoencoderViT.load_state_dict(strict=True)`` takes."""
    return _tensors(mae_state_dict(params))


def jax_flat_from_state_dict(
    sd: Mapping[str, torch.Tensor]
) -> Dict[str, np.ndarray]:
    """AudioMAE, AST or MAE state dict -> flat flax params:
    ``blocks.3.attn.qkv.weight`` becomes ``blocks_3/attn/qkv/kernel``
    (transposed), a conv weight (O, I, kh, kw) becomes a (kh, kw, I, O)
    kernel, a LayerNorm weight its ``scale``; AST's ``mlp_head.0`` and
    ``mlp_head.1`` become ``mlp_head_norm`` and ``mlp_head``; the swin
    decoder's ``attn.meta_mlp.fc{1,2}`` become ``attn/meta_fc{1,2}`` and
    its (H,) ``attn.logit_scale`` keeps its name."""
    flat: Dict[str, np.ndarray] = {}
    for key, t in sd.items():
        a = t.detach().to("cpu", torch.float32).numpy()
        if "." not in key:  # cls_token, pos_embed, mask_token, ...
            flat[key] = a
            continue
        module, leaf = key.rsplit(".", 1)
        module = _AST_HEAD.get(module, module)
        path = (module.replace(".meta_mlp.fc", ".meta_fc")
                .replace("blocks.", "blocks_").replace(".", "/"))
        if leaf in ("bias", "logit_scale"):
            flat[f"{path}/{leaf}"] = a
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
    a gradient (the frozen pos embeds) are left out."""
    return jax_flat_from_state_dict(
        {k: g for k, g in named_grads.items() if g is not None}
    )


def state_dict_of(obj) -> Dict[str, torch.Tensor]:
    """The state dict inside a loaded reference ``.pth``: the AudioMAE
    ``{'model': state_dict, ...}`` envelope unwrapped, tensors only, the
    DataParallel ``module.`` prefix stripped (as the JAX package's
    ``load_torch_state_dict``)."""
    if isinstance(obj, dict) and isinstance(obj.get("model"), dict):
        obj = obj["model"]
    return {k.removeprefix("module."): v for k, v in obj.items()
            if isinstance(v, torch.Tensor)}


def load_pth(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference ``.pth`` state dict (``state_dict_of``)."""
    return state_dict_of(torch.load(path, map_location="cpu", weights_only=True))
