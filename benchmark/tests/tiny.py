"""Tiny configurations of the benchmark's cells, for runs on the CPU: the
cells' own traffic files and limits, at widths a test can hold."""

from __future__ import annotations

import copy
import json

from benchmark.harness import BENCH

VIT = dict(embed_dim=64, depth=4, num_heads=2, mlp_ratio=4.0, patch_size=16,
           in_chans=1, target_length=128, num_mel_bins=64, num_classes=10,
           drop_loc=[1, 2], base_keep_rate=0.7, drop_path_rate=0.1,
           compute_dtype="bfloat16")
MAE = dict(embed_dim=64, depth=2, num_heads=2, decoder_embed_dim=64,
           decoder_depth=2, decoder_num_heads=2, decoder_mode=1,
           window_size=[4, 4], mlp_ratio=4.0, patch_size=16,
           target_length=128, num_mel_bins=64, norm_pix_loss=True,
           mask_2d=True, mask_t_prob=0.5, mask_f_prob=0.3,
           compute_dtype="bfloat16")


def _load(kind: str, name: str) -> dict:
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def vit_config() -> dict:
    c = _load("configs", "audiomae-vitb16-esc50")
    c["program"] = {"factory": "ViTConfig", "args": dict(VIT)}
    c["model"] = dict(VIT)
    c["train"].update(drop_loc=VIT["drop_loc"], batch_size=4)
    return c


def mae_config() -> dict:
    c = _load("configs", "audiomae-mae-dec512d8b-as")
    c["program"] = {"factory": "MAEConfig", "args": dict(MAE)}
    c["model"] = dict(MAE)
    return c


def traffic(name: str, **change) -> dict:
    t = copy.deepcopy(_load("traffic", name))
    t.update(change)
    return t


def finetune():
    return vit_config(), traffic("finetune-b128", batch=4, distinct_batches=6,
                                 reference_rows=2)


def pretrain():
    return mae_config(), traffic("pretrain-b256", batch=4, reference_rows=2)


def serve():
    return vit_config(), traffic("serve-b128", clips=12, requests=[4, 4, 4],
                                 buckets=[1, 4], reference_rows=6)


def serve_backlog():
    return vit_config(), traffic("serve-b128-backlog", clips=12,
                                 requests=[4, 4, 4], buckets=[1, 4],
                                 reference_rows=6)


# each cell's tiny maker
CELLS = {"vitb16-esc50.finetune-b128": finetune,
         "mae-dec512d8b-as.pretrain-b256": pretrain,
         "vitb16-esc50.serve-b128": serve,
         "vitb16-esc50.serve-b128-backlog": serve_backlog}
