"""Reference ``.pth`` checkpoints into the port's ``AudioViT``, with the
reference's finetune surgery (``tpat_tpu/utils/torch_import.py``).

The port's model takes the reference key layout as is, so where the JAX
package converts a state dict to flax params, the port keeps the state dict
and applies the same surgery (``main_finetune.py:384-426``):

- only the trunk's keys are taken: ``cls_token``, ``pos_embed``,
  ``patch_embed.proj.*``, every block's ``norm1``, ``attn.qkv``,
  ``attn.proj``, ``norm2``, ``mlp.fc1``, ``mlp.fc2``, ``fc_norm.*`` where
  present and ``head.*`` where its class count matches (a pretraining
  checkpoint's ``norm``, decoder and mask token are left out);
- ``pos_embed`` is time-cropped from the checkpoint's grid to the model's;
  the AudioSet checkpoint's 512 patch rows are viewed as (freq, time) =
  (8, 64) whatever the patch flatten order, as the reference does
  (``main_finetune.py:408-409``), and a row count that still does not
  match is refused;
- ``overlay_state_dict`` loads the result over a freshly initialised model
  (``strict=False``: missing keys keep their initialisation) and fails on
  any key the model does not have, as ``overlay_params`` does.

The AST importers take the same path (``ast_models.py:273-381``):

- ``ast_state_dict_for``, the counterpart of ``ast_params_from_state_dict``:
  an AST ``.pth`` (``module.`` already stripped by ``state_dict_of``; the
  trunk under ``v.``) -> the trunk, ``dist_token`` and ``norm`` included,
  its pos_embed's (8, 64) time axis centre-cropped to the model's, a row
  count that still does not match refused, and ``mlp_head.{0,1}`` kept only
  when the class count matches;
- ``deit_state_dict_for``, the counterpart of
  ``deit_params_from_state_dict``: a timm DeiT-distilled state dict -> the
  trunk with the RGB patch conv summed to one channel and the square pos
  grid cut or stretched to the audio grid; both DeiT heads are dropped.

The MAE importer, ``mae_state_dict_for``, is the counterpart of
``mae_params_from_state_dict``: a reference full-MAE ``.pth``
(``models_mae.py``: encoder and decoder, no surgery) -> the state dict
``MaskedAutoencoderViT.load_state_dict(strict=True)`` takes, the decoder
flavour told by ``decoder_blocks.0.attn.logit_scale`` and both depths read
from the keys; a checkpoint whose flavour, depths or grid differ from the
model's config is refused with the mismatch named (pretraining resumes at
the checkpoint's own geometry).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from tpat_tpu_torch.config import ViTConfig
from tpat_tpu_torch.models import pos_embed as pe
from tpat_tpu_torch.models.mae import MAEConfig

_BLOCK_KEY = re.compile(
    r"blocks\.\d+\.(norm1|norm2|attn\.qkv|attn\.proj|mlp\.fc1|mlp\.fc2)"
    r"\.(weight|bias)"
)
_AST_TRUNK = ("cls_token", "dist_token", "patch_embed.proj.weight",
              "patch_embed.proj.bias", "norm.weight", "norm.bias")


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().to("cpu", torch.float32)


def audiomae_state_dict_for(
    sd: Mapping[str, torch.Tensor],
    cfg: ViTConfig,
    ckpt_grid: Tuple[int, int] = (8, 64),
) -> Dict[str, torch.Tensor]:
    """A reference AudioMAE state dict -> the state dict ``AudioViT(cfg)``
    takes with ``overlay_state_dict``, after the surgery above (the
    counterpart of ``audiomae_params_from_state_dict``)."""
    out: Dict[str, torch.Tensor] = {"cls_token": _f32(sd["cls_token"])}
    for k, v in sd.items():
        if k.startswith("patch_embed.proj.") or _BLOCK_KEY.fullmatch(k):
            out[k] = _f32(v)
        elif k.startswith("fc_norm."):
            out[k] = _f32(v)
    if "pos_embed" in sd:
        pos = pe.crop_time_audio_pos_embed(
            _f32(sd["pos_embed"]).numpy(), ckpt_grid,
            (cfg.grid_f, cfg.grid_t), num_extra_tokens=1,
        )
        expected = cfg.num_patches + 1
        if pos.shape[1] != expected:
            raise ValueError(
                f"pos_embed rows {pos.shape[1]} != expected {expected}; "
                f"check target_length ({cfg.target_length})"
            )
        out["pos_embed"] = torch.from_numpy(np.ascontiguousarray(pos))
    if "head.weight" in sd and sd["head.weight"].shape[0] == cfg.num_classes:
        out["head.weight"] = _f32(sd["head.weight"])
        if "head.bias" in sd:
            out["head.bias"] = _f32(sd["head.bias"])
    return out


def _ast_trunk(v: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: _f32(t) for k, t in v.items()
            if k in _AST_TRUNK or _BLOCK_KEY.fullmatch(k)}


def _ast_pos(pos: np.ndarray, cfg: ViTConfig, what: str) -> torch.Tensor:
    if pos.shape[1] != cfg.num_patches + 2:
        raise ValueError(
            f"{what} pos_embed rows {pos.shape[1]} != {cfg.num_patches + 2}"
        )
    return torch.from_numpy(np.ascontiguousarray(pos))


def ast_state_dict_for(
    sd: Mapping[str, torch.Tensor], cfg: ViTConfig
) -> Dict[str, torch.Tensor]:
    """An AST ``.pth`` state dict (trunk under ``v.``, ``module.``
    stripped) -> the state dict an AST ``AudioViT(cfg)`` takes with
    ``overlay_state_dict`` (``ast_models.py:353-381``)."""
    v = {k.removeprefix("v."): t for k, t in sd.items() if k.startswith("v.")}
    out = _ast_trunk(v)
    pos = _f32(v["pos_embed"]).numpy()
    if pos.shape[1] - 2 != cfg.num_patches:
        pos = pe.center_crop_time_ast_pos_embed(
            pos, cfg.target_length // cfg.patch_size, num_extra_tokens=2
        )
    out["pos_embed"] = _ast_pos(pos, cfg, "AST")
    if ("mlp_head.1.weight" in sd
            and sd["mlp_head.1.weight"].shape[0] == cfg.num_classes):
        for k in ("mlp_head.0.weight", "mlp_head.0.bias",
                  "mlp_head.1.weight", "mlp_head.1.bias"):
            out[k] = _f32(sd[k])
    return out


def deit_state_dict_for(
    sd: Mapping[str, torch.Tensor], cfg: ViTConfig
) -> Dict[str, torch.Tensor]:
    """A timm ``vit_deit_base_distilled_patch16_384`` state dict -> the AST
    trunk (``ast_models.py:273-325``): the RGB patch conv summed to one
    channel, the square pos grid adapted by
    ``pos_embed.deit_img2audio_pos_embed``, ``head``/``head_dist`` dropped
    (AST always builds a fresh mlp_head)."""
    v = {k.removeprefix("v."): t for k, t in sd.items()}
    out = _ast_trunk(v)
    w = out["patch_embed.proj.weight"]
    if w.shape[1] != 1:
        out["patch_embed.proj.weight"] = torch.from_numpy(
            pe.sum_rgb_patch_embed(w.numpy()))
    pos = pe.deit_img2audio_pos_embed(
        _f32(v["pos_embed"]).numpy(), cfg.grid_f, cfg.grid_t,
        num_extra_tokens=2,
    )
    out["pos_embed"] = _ast_pos(pos, cfg, "DeiT")
    return out


_MAE_TENSORS = ("cls_token", "pos_embed", "mask_token", "decoder_pos_embed")
_MAE_MODULES = ("patch_embed.proj", "norm", "decoder_embed", "decoder_norm",
                "decoder_pred")
_PLAIN_BLOCK = ("norm1", "attn.qkv", "attn.proj", "norm2", "mlp.fc1",
                "mlp.fc2")
_SWIN_BLOCK = _PLAIN_BLOCK + ("attn.meta_mlp.fc1", "attn.meta_mlp.fc2")


def _depth_of(sd: Mapping[str, torch.Tensor], stem: str) -> int:
    ids = {int(m.group(1)) for k in sd
           if (m := re.match(rf"{re.escape(stem)}\.(\d+)\.", k))}
    return max(ids) + 1 if ids else 0


def mae_state_dict_for(
    sd: Mapping[str, torch.Tensor], cfg: MAEConfig
) -> Dict[str, torch.Tensor]:
    """A reference full-MAE state dict -> the state dict
    ``MaskedAutoencoderViT(cfg).load_state_dict(strict=True)`` takes (the
    counterpart of ``mae_params_from_state_dict``).  The swin decoder's
    buffers the reference saves (relative coordinates, shift masks) are
    left out: the model builds its own."""
    mode = 1 if "decoder_blocks.0.attn.logit_scale" in sd else 0
    depth = _depth_of(sd, "blocks")
    dec_depth = _depth_of(sd, "decoder_blocks")
    rows = sd["pos_embed"].shape[1] - 1
    for what, got, want in (
            ("decoder_mode", mode, cfg.decoder_mode),
            ("depth", depth, cfg.depth),
            ("decoder_depth", dec_depth, cfg.decoder_depth),
            ("patches (grid)", rows, cfg.num_patches)):
        if got != want:
            raise ValueError(
                f"MAE checkpoint has {what} {got}, the model {want} "
                f"(grid {cfg.grid}, target_length {cfg.target_length})"
            )
    out = {k: _f32(sd[k]) for k in _MAE_TENSORS}
    modules = list(_MAE_MODULES)
    modules += [f"blocks.{i}.{m}" for i in range(depth) for m in _PLAIN_BLOCK]
    for i in range(dec_depth):
        block = _SWIN_BLOCK if mode == 1 else _PLAIN_BLOCK
        modules += [f"decoder_blocks.{i}.{m}" for m in block]
        if mode == 1:
            key = f"decoder_blocks.{i}.attn.logit_scale"
            out[key] = _f32(sd[key])
    for m in modules:
        for leaf in ("weight", "bias"):
            if f"{m}.{leaf}" in sd:
                out[f"{m}.{leaf}"] = _f32(sd[f"{m}.{leaf}"])
    return out


def overlay_state_dict(model: torch.nn.Module, imported: Mapping[str, torch.Tensor]):
    """Load ``imported`` over the model's own initialisation: its keys win,
    the model's other parameters stay; a key the model lacks raises
    ``KeyError`` and a shape mismatch ``RuntimeError``."""
    own = model.state_dict()
    extra = sorted(set(imported) - set(own))
    if extra:
        raise KeyError(f"imported keys not in the model: {extra}")
    model.load_state_dict(dict(imported), strict=False)


def checkpoint_grid(sd: Mapping[str, torch.Tensor], cfg: ViTConfig) -> Tuple[int, int]:
    """The (freq, time) grid a pretrained checkpoint's pos_embed is cropped
    from: the reference hard-codes the AudioSet (8, 64); like the JAX
    CLI, the time extent is read from the row count, so a checkpoint
    pretrained at another length crops too (the same (8, 64) for the
    512-patch AudioSet layout)."""
    if "pos_embed" not in sd:
        return (8, 64)
    rows = sd["pos_embed"].shape[1] - 1
    return (cfg.grid_f, rows // cfg.grid_f)
