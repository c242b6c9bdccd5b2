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

The AST, DeiT and MAE importers (``ast_params_from_state_dict``,
``deit_params_from_state_dict``, ``mae_params_from_state_dict``) wait for
ROADMAP A5 and A9.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from tpat_tpu_torch.config import ViTConfig
from tpat_tpu_torch.models import pos_embed as pe

_BLOCK_KEY = re.compile(
    r"blocks\.\d+\.(norm1|norm2|attn\.qkv|attn\.proj|mlp\.fc1|mlp\.fc2)"
    r"\.(weight|bias)"
)


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
