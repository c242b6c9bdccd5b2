"""Finetune and eval CLI of the port: ``tpat_tpu/cli/finetune.py`` (the
reference's ``main_finetune.py``) on PyTorch, with the same flags, defaults
and artifacts.

    python -m tpat_tpu_torch.cli.finetune \\
      --dataset esc50 --data_train train.json --data_eval eval.json \\
      --label_csv labels.csv --nb_classes 50 --batch_size 128 --epochs 120 \\
      --blr 1e-3 --base_keep_rate 0.7 --drop_loc "(3, 6, 9)" \\
      --shrink_start_epoch 20 --shrink_epochs 40 --first_eval_ep 60 \\
      --mask_t_prob 0.3 --mask_f_prob 0.3 --freqm 24 --timem 96 \\
      --roll_mag_aug true --audioset_pretrained_model_path pretrained.pth \\
      --output_dir out --result_path out/train_result.txt

    # eval of a kept model (the port's best_model or a reference .pth)
    python -m tpat_tpu_torch.cli.finetune ... --eval \\
      --finetuned_model_path out/best_model

The host pipeline (``data/``) reads the WAVs, takes the fbank and the
augmentations; ``engine.train.TrainModule`` trains through the dense, anneal
and static phases; ``engine.evaluate`` scores each epoch from
``--first_eval_ep`` on; ``utils.checkpoint.BestCheckpointKeeper`` keeps the
best.  The output directory gets ``args.yaml``, ``log.txt`` (one JSON line
per epoch: ``train_loss``, ``train_grad_norm``, ``train_phase``,
``test_acc1``, ``test_acc5``, ``test_loss`` or ``test_mAP``, ``epoch``),
``best-{epoch:03d}-{score:.4f}.txt``, ``best_model`` and, with
``--save_every_epochs``, ``last_checkpoint``; ``--result_path`` gets the
best score.

``--model ast_vit_base`` takes AST checkpoints through the AST importer
and is fed the loader's (B, 1, T, F) batches as they come, as the JAX CLI
feeds it (``cli/run_ast.py`` is the AST CLI with AST's orientation).
``--custom_rank`` reaches the static train steps and every single-label
eval; ``--drop_token_blk_idx`` with ``--retain_min``/``--retain_max`` runs
the intensity-band ablation in ``--eval`` (at keep 1.0).

``--eval --flag_extract_features true --extract_features_path feats``
writes each eval batch's features (``mel``, ``block-{i}.attn_score``,
``block-{i}.topk_idx``, ``labels``) as ``feats/{key}.{batch:04d}.pth``
(``utils/features.py``) for ``python -m
tpat_tpu_torch.analysis.extract_stats``; the directory must not exist.
``--device_frontend true``: the loader ships raw waveforms and the fbank,
SpecAug, normalisation and noise run on the device at the head of each
step and eval forward (``ops/frontend.py``).

``--device_dataset`` (``data/device_cache.py``): a set whose items are a
pure function of their index (no host-side augmentation) is copied to the
device once and each batch is an index gather there.  'auto' (the default)
caches exactly the eligible sets (under ft_esc50.sh's flags the eval set:
``--roll_mag_aug true`` rules the train set out), 'true' requires both and
raises the reason where one is not eligible, 'false' streams both from the
host loader.

Data parallelism: ``python -m torch.distributed.run --nproc_per_node N
-m tpat_tpu_torch.cli.finetune ...`` (or the JAX package's
``COORDINATOR_ADDRESS``/``NUM_PROCESSES``/``PROCESS_ID``) trains one model
over a global batch of ``batch_size * N`` rows (``parallel/``): each rank
loads its ``EpochShardSampler(world, rank)`` shard, the lr rule counts the
world, the gradients are averaged across ranks.  ``--dist_eval`` scores
each rank's unpadded eval shard and gathers the rows exactly; without it
every rank scores the whole set.  Only rank 0 writes artifacts; rank 0's
verdict on an existing run directory is broadcast, so every rank stops
together.  Feature extraction needs one process, and ``--device_dataset``
streams (``true`` raises) at more than one.

Tensor parallelism: ``--model_axis tp`` (> 1) splits the N ranks into N /
tp data ranks of tp model ranks each (``parallel/sharding.py``), and
``tp`` must divide N (JAX's assert and message).  The JAX CLI puts an (n /
tp) x tp mesh over its n devices and feeds each host's ``batch_size`` rows
to it; here one process drives one device, so the ranks of a model group
load the same ``batch_size`` rows (``EpochShardSampler`` and the
``--dist_eval`` shards run over the data ranks), the lr rule counts the
data ranks as ``num_hosts``, and the global batch is ``batch_size * N /
tp``.  The attention runs the plain path (the kernels are batch-parallel
only); checkpoints, ``best_model`` and ``last_checkpoint`` hold the
gathered tp = 1 state, written by rank 0.

``main(args, device="cuda")`` runs on the card unless the caller passes
another device (the CPU tests pass ``device="cpu"``); without CUDA it
raises.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import math
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from tpat_tpu_torch import config as cfg_lib
from tpat_tpu_torch.cli import card_device, str2bool
from tpat_tpu_torch.data.datasets import (
    AudiosetDataset, VoxCeleb1Dataset, make_name_dict,
)
from tpat_tpu_torch.data.device_cache import maybe_device_cached
from tpat_tpu_torch.data.loader import DataLoader
from tpat_tpu_torch.data.sampler import EpochShardSampler, EvalShardSampler
from tpat_tpu_torch.engine import evaluate as eval_lib
from tpat_tpu_torch.engine.train import TrainModule
from tpat_tpu_torch.models.vit import AudioViT, shard_model_
from tpat_tpu_torch.ops.frontend import make_preprocess
from tpat_tpu_torch.parallel import distributed as dist_lib
from tpat_tpu_torch.parallel import sharding
from tpat_tpu_torch.utils import checkpoint as ckpt_lib
from tpat_tpu_torch.utils import torch_import as ti
from tpat_tpu_torch.utils.features import FeatureWriter
from tpat_tpu_torch.utils.logging import profiler_trace
from tpat_tpu_torch.utils.weights import load_pth, state_dict_of


def get_args_parser():
    p = argparse.ArgumentParser("tpat_tpu_torch finetuning", add_help=False)
    p.add_argument("--batch_size", required=True, type=int)
    p.add_argument("--epochs", required=True, type=int)
    p.add_argument("--accum_iter", default=1, type=int)
    p.add_argument("--model", default="audiomae_vit_base",
                   choices=["audiomae_vit_base", "audiomae_vit_small",
                            "audiomae_vit_large", "audiomae_vit_tiny",
                            "ast_vit_base"])
    p.add_argument("--drop_path", type=float, default=0.1)
    # bf16 matmuls with f32 softmax and statistics, as the reference's
    # autocast; no loss scaler
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--gelu_impl", default="auto",
                   choices=["auto", "exact", "poly"])
    # a torch.profiler trace of one training epoch
    p.add_argument("--profile_dir", default=None, type=str)
    p.add_argument("--profile_epoch", default=1, type=int)
    # optimizer
    p.add_argument("--clip_grad", type=float, default=None)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--blr", type=float, default=1e-3)
    p.add_argument("--layer_decay", type=float, default=0.75)
    p.add_argument("--min_lr", type=float, default=1e-6)
    p.add_argument("--warmup_epochs", type=float, default=5)
    # checkpoints
    p.add_argument("--audioset_pretrained_model_path", default="")
    p.add_argument("--finetuned_model_path", default="")
    p.add_argument("--mean_pooling", type=str2bool, default=True)
    # data
    p.add_argument("--dataset", required=True,
                   choices=["audioset", "esc50", "spc2", "voxceleb1"])
    p.add_argument("--data_train", default="")
    p.add_argument("--data_eval", default="")
    p.add_argument("--label_csv", default="")
    p.add_argument("--voxceleb1_root", default=None)
    p.add_argument("--nb_classes", required=True, type=int)
    p.add_argument("--freqm", type=int, default=None)
    p.add_argument("--timem", type=int, default=None)
    p.add_argument("--mixup", type=float, default=0.0)
    p.add_argument("--roll_mag_aug", type=str2bool, default=False)
    p.add_argument("--mask_2d", type=str2bool, default=True)
    p.add_argument("--mask_t_prob", type=float, default=0.0)
    p.add_argument("--mask_f_prob", type=float, default=0.0)
    p.add_argument("--num_workers", default=4, type=int)
    p.add_argument("--model_axis", default=1, type=int,
                   help="tensor-parallel model axis: ranks per model "
                        "group (parallel/sharding.py); must divide the "
                        "process count")
    p.add_argument("--target_length", type=int, default=None,
                   help="override the preset target length (testing)")
    p.add_argument("--device_frontend", type=str2bool, default=False,
                   help="datasets emit raw waveforms; the fbank, SpecAug, "
                        "normalisation and noise run batched on the device "
                        "(ops/frontend.py)")
    p.add_argument("--device_dataset", default="auto",
                   choices=["auto", "true", "false"],
                   help="device-resident dataset cache "
                        "(data/device_cache.py): a set whose items are a "
                        "pure function of their index (no host-side "
                        "augmentation) is copied to the device once and "
                        "each batch is an index gather there; 'auto' caches "
                        "the eligible sets, 'true' requires it (raising the "
                        "reason), 'false' streams from the host loader")
    # run control
    p.add_argument("--output_dir", default="./output_dir")
    p.add_argument("--ramdisk_dir", default="")
    p.add_argument("--async_checkpoint", type=str2bool, default=False,
                   help="write best/last checkpoints on a background thread "
                        "(the payload is copied to host memory first)")
    p.add_argument("--best_on_device", type=str2bool, default=False,
                   help="keep the best state as a device copy and write it "
                        "once at the end; a crash before the end loses it")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--resume", default="")
    p.add_argument("--start_epoch", default=0, type=int)
    p.add_argument("--eval", action="store_true")
    p.add_argument("--dist_eval", action="store_true", default=False)
    p.add_argument("--first_eval_ep", default=0, type=int)
    p.add_argument("--result_path", type=str, default=None)
    p.add_argument("--save_every_epochs", type=int, default=0,
                   help="periodic crash-resume checkpoint (0 = off)")
    # feature extraction
    p.add_argument("--flag_extract_features", type=str2bool, default=False)
    p.add_argument("--extract_features_path", type=str, default=None)
    # pruning
    p.add_argument("--drop_loc", default="(3, 6, 9)", type=str)
    p.add_argument("--base_keep_rate", type=float, default=1.0)
    p.add_argument("--shrink_epochs", default=0, type=int)
    p.add_argument("--shrink_start_epoch", default=10, type=int)
    p.add_argument("--anneal_mode", default="hybrid",
                   choices=["hybrid", "masked", "bucketed"])
    p.add_argument("--anneal_buckets", default=4, type=int)
    # ablations
    p.add_argument("--custom_rank", default=None, choices=[None, "mean", "std"])
    p.add_argument("--retain_min", default=-100, type=float)
    p.add_argument("--retain_max", default=100, type=float)
    p.add_argument("--drop_token_blk_idx", type=int, default=None)
    return p


def args_checker(args):
    """main_finetune.py:220-233, as ``tpat_tpu/cli/finetune.py:160``."""
    assert args.mean_pooling, (
        "mean_pooling must be True (models_vit.py:307 asserts it)"
    )
    if not args.eval:
        assert not args.flag_extract_features, (
            "extract_features is only supported during evaluation"
        )
    else:
        assert args.finetuned_model_path, (
            "finetuned_model_path is required for evaluation"
        )
    if args.flag_extract_features:
        assert args.extract_features_path, (
            "extract_features_path is required for feature extraction"
        )
    # main_finetune.py:511: the engine applies one probability to both axes
    assert args.mask_t_prob == args.mask_f_prob, (
        f"mask_t_prob ({args.mask_t_prob}) must equal mask_f_prob "
        f"({args.mask_f_prob}) (main_finetune.py:511)"
    )
    if args.mask_t_prob > 0.0:
        assert args.mask_2d, "mask_t_prob > 0 requires --mask_2d True"


def make_mesh(args, world: int) -> Optional[sharding.Mesh2D]:
    """The (world / model_axis) x model_axis mesh under ``--model_axis`` >
    1 (``tpat_tpu/cli/finetune.py:264-271``), else None."""
    if args.model_axis <= 1:
        return None
    assert world % args.model_axis == 0, (
        f"model_axis {args.model_axis} must divide device count {world}"
    )
    return sharding.make_mesh_2d(world // args.model_axis, args.model_axis)


def build_everything(args, device, mesh=None):
    """(model_cfg, data_cfg, TrainModule, train loader or None, eval
    loader)."""
    preset = cfg_lib.DATASET_PRESETS[args.dataset]
    data_cfg = dataclasses.replace(
        preset,
        target_length=args.target_length or preset.target_length,
        num_classes=args.nb_classes,
        freqm=args.freqm if args.freqm is not None else preset.freqm,
        timem=args.timem if args.timem is not None else preset.timem,
        mixup=args.mixup,
        roll_mag_aug=args.roll_mag_aug,
    )
    drop_loc = tuple(ast.literal_eval(args.drop_loc))
    model_cfg = getattr(cfg_lib, args.model)(
        num_classes=args.nb_classes,
        target_length=data_cfg.target_length,
        drop_path_rate=args.drop_path,
        drop_loc=drop_loc,
        base_keep_rate=args.base_keep_rate,
        compute_dtype=args.compute_dtype,
        gelu_impl=args.gelu_impl,
    )

    wf = bool(args.device_frontend)
    if args.dataset == "voxceleb1":
        ds_train = VoxCeleb1Dataset(
            args.voxceleb1_root, "train", data_cfg, lr_pad=True, seed=args.seed,
            return_waveform=wf,
        )
        ds_val = VoxCeleb1Dataset(args.voxceleb1_root, "test", data_cfg,
                                  return_waveform=wf)
    else:
        ds_train = (
            AudiosetDataset(
                args.data_train, data_cfg, args.label_csv, train=True,
                roll_mag_aug=args.roll_mag_aug, seed=args.seed,
                return_waveform=wf,
            )
            if args.data_train
            else None
        )
        ds_val = AudiosetDataset(
            args.data_eval, data_cfg, args.label_csv, train=False,
            return_waveform=wf,
        )
    # each data rank loads only its shard (torch DistributedSampler
    # semantics, main_finetune.py:292-294); the global batch is batch_size
    # * the data ranks
    rank, world = dist_lib.data_rank_world()
    dd_mode = args.device_dataset
    loader_train = None
    if ds_train is not None:
        sampler = EpochShardSampler(len(ds_train), shuffle=True, seed=args.seed,
                                    world=world, rank=rank)
        loader_train = maybe_device_cached(
            ds_train, args.batch_size, sampler=sampler,
            num_workers=args.num_workers, drop_last=True, device=device,
            mode=dd_mode, label="train set",
        ) or DataLoader(
            ds_train, args.batch_size, sampler=sampler,
            num_workers=args.num_workers, drop_last=True,
        )
        dist_lib.check_equal(len(loader_train), "train steps per epoch")
    # --dist_eval reads each rank's shard through dist_eval_batches, so a
    # device copy of the whole eval set would be made for nothing
    eval_dd_mode = "false" if (args.dist_eval and world > 1) else dd_mode
    loader_val = maybe_device_cached(
        ds_val, args.batch_size, shuffle=False, num_workers=args.num_workers,
        drop_last=False, device=device, mode=eval_dd_mode, label="eval set",
    ) or DataLoader(
        ds_val, args.batch_size, shuffle=False,
        num_workers=args.num_workers, drop_last=False,
    )
    train_cfg = cfg_lib.TrainConfig(
        batch_size=args.batch_size,
        epochs=args.epochs,
        accum_iter=args.accum_iter,
        blr=args.blr,
        lr=args.lr,
        min_lr=args.min_lr,
        warmup_epochs=args.warmup_epochs,
        weight_decay=args.weight_decay,
        layer_decay=args.layer_decay,
        clip_grad=args.clip_grad,
        seed=args.seed,
        base_keep_rate=args.base_keep_rate,
        drop_loc=drop_loc,
        shrink_start_epoch=args.shrink_start_epoch,
        shrink_epochs=args.shrink_epochs,
        anneal_mode=args.anneal_mode,
        anneal_buckets=args.anneal_buckets,
        mask_t_prob=args.mask_t_prob,
        mask_f_prob=args.mask_f_prob,
        first_eval_ep=args.first_eval_ep,
        dist_eval=args.dist_eval,
        num_hosts=world,
    )
    module = TrainModule(
        model_cfg, train_cfg, data_cfg.loss_type,
        iters_per_epoch=len(loader_train) if loader_train else 1,
        device=device, custom_rank=args.custom_rank,
        preprocess=make_preprocess(data_cfg) if wf else None, mesh=mesh,
    )
    return module.model_cfg, data_cfg, module, loader_train, loader_val


def _read_finetuned(path: str, model_cfg) -> Dict[str, torch.Tensor]:
    """The model state dict of ``--finetuned_model_path``: the port's own
    checkpoint (``utils/checkpoint.py``, loaded strict), or a reference
    ``.pth`` at the model's geometry (an AST one through the AST importer;
    an AudioMAE one's crop is a no-op, the row check still holds it to the
    model's shape)."""
    ckpt_lib.refuse_orbax(path)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if ckpt_lib.is_payload(obj):
        return obj["model"]
    if model_cfg.num_extra_tokens == 2:
        return ti.ast_state_dict_for(state_dict_of(obj), model_cfg)
    return ti.audiomae_state_dict_for(
        state_dict_of(obj), model_cfg,
        ckpt_grid=(model_cfg.grid_f, model_cfg.grid_t),
    )


def initial_state_dict(args, model_cfg) -> Dict[str, torch.Tensor]:
    """The checkpoint surgery chain (main_finetune.py:384-426) over a model
    initialised from ``--seed``: the pretrained trunk overlaid, the head
    weight kept fresh (the reference re-initialises it with
    trunc_normal(2e-5) after the load, main_finetune.py:424), then a
    finetuned checkpoint over that.  An AST model takes an AST checkpoint
    through ``ast_state_dict_for``, its mlp_head kept where the class count
    matches (``tpat_tpu/cli/finetune.py:383-386``)."""
    model = AudioViT(model_cfg, generator=torch.Generator().manual_seed(args.seed))
    if args.audioset_pretrained_model_path:
        sd = load_pth(args.audioset_pretrained_model_path)
        if model_cfg.num_extra_tokens == 2:
            imported = ti.ast_state_dict_for(sd, model_cfg)
        else:
            imported = ti.audiomae_state_dict_for(
                sd, model_cfg, ckpt_grid=ti.checkpoint_grid(sd, model_cfg)
            )
            imported.pop("head.weight", None)
        ti.overlay_state_dict(model, imported)
        print(f"loaded pretrained checkpoint: {args.audioset_pretrained_model_path}")
    if args.finetuned_model_path:
        path = args.finetuned_model_path
        ti.overlay_state_dict(model, _read_finetuned(path, model_cfg))
        print(f"loaded finetuned checkpoint: {path}")
    return model.state_dict()


def dist_eval_batches(ds_val, batch_size, num_workers=4, world=None,
                      rank=None):
    """This rank's unpadded eval shard (DistributedEvalSampler semantics,
    ``util/sampler.py:73-99``) as (x, y, ids) batches: rank-strided
    indices, no wrap padding, so the gathered metrics are exact.  A rank
    whose shard is empty (fewer rows than ranks) gets one batch of a row
    with no ids, which scores no row.  ``world`` and ``rank`` default to
    the data ranks'."""
    g_rank, g_world = dist_lib.data_rank_world()
    world = g_world if world is None else world
    rank = g_rank if rank is None else rank
    sampler = EvalShardSampler(len(ds_val), world, rank)
    if not len(sampler):
        x, y, _ = ds_val[0]
        yield np.stack([x]), np.stack([y]), []
        return
    yield from DataLoader(ds_val, batch_size, sampler=sampler,
                          num_workers=num_workers, drop_last=False)


def _eval_once(args, model, module, loader_val, device, feature_writer=None,
               index_to_name=None, intensity_band=None) -> Dict[str, float]:
    """One eval pass, the one place of the dist-eval policy: with
    ``--dist_eval`` over several processes each rank scores its unpadded
    shard and the rows are gathered (engine_finetune.py:246-248), otherwise
    every rank scores the whole set.  Like the reference, which sets
    use_custom_rank model-wide (main_finetune.py:448-450), the custom rank
    applies to every single-label eval."""
    dist = args.dist_eval and dist_lib.world_size() > 1
    if dist:
        batches = ((x, y, len(ids)) for x, y, ids in dist_eval_batches(
            loader_val.dataset, args.batch_size,
            num_workers=loader_val.num_workers))
    else:
        batches = ((x, y) for x, y, _ in loader_val)
    if args.dataset == "audioset":
        return eval_lib.evaluate_multilabel(
            model, batches, args.batch_size, device,
            feature_writer=feature_writer, preprocess=module.preprocess,
            allgather=dist,
        )
    return eval_lib.evaluate_classification(
        model, batches, args.batch_size, device,
        feature_writer=feature_writer, index_to_name=index_to_name,
        custom_rank=args.custom_rank, intensity_band=intensity_band,
        preprocess=module.preprocess, allgather=dist,
    )


def run_eval(args, model, module, loader_val, device) -> Dict[str, float]:
    writer = index_to_name = None
    if args.flag_extract_features and dist_lib.world_size() > 1:
        # the reference's args_checker demands world_size 1 for extraction
        # (main_finetune.py:232); the ranks' batch files would collide
        raise ValueError(
            "feature extraction requires a single process "
            "(main_finetune.py:232)"
        )
    if args.flag_extract_features:
        # exist_ok=False (main_finetune.py:494): an earlier run's batch files
        # would be globbed into the analysis with the new ones
        Path(args.extract_features_path).mkdir(parents=True, exist_ok=False)
        writer = FeatureWriter(args.extract_features_path)
        if args.label_csv:
            index_to_name = make_name_dict(args.label_csv)
    band = None
    if args.drop_token_blk_idx is not None:
        # the reference asserts eval at keep 1.0 (main_finetune.py:336)
        assert args.base_keep_rate == 1.0, "band ablation needs keep 1.0"
        band = (args.retain_min, args.retain_max, args.drop_token_blk_idx)
    stats = _eval_once(args, model, module, loader_val, device,
                       feature_writer=writer, index_to_name=index_to_name,
                       intensity_band=band)
    metric = "mAP" if args.dataset == "audioset" else "acc1"
    # rank 0 writes; under --dist_eval every rank holds the same gathered
    # stats
    if dist_lib.is_main_process():
        print(f"{metric}: {stats[metric]:.4f}")
        if args.result_path:
            with open(args.result_path, "w") as f:
                f.write(f"{stats[metric]:.4f}")
    return stats


def _yaml_scalar(v) -> str:
    """One YAML scalar that ``yaml.safe_load`` reads back as ``v``: JSON's
    form of None, bools, ints and strings is YAML's too; a float keeps a
    dot in its mantissa (YAML 1.1 reads '1e-05' as a string)."""
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        s = repr(v)
        mant, _, exp = s.partition("e")
        if exp and "." not in mant:
            s = f"{mant}.0e{exp}"
        return s
    if v is None or isinstance(v, (bool, int, str)):
        return json.dumps(v)
    return json.dumps(str(v))


def write_args_yaml(path, args: dict):
    """``args.yaml`` without PyYAML (the card's image has none): one
    ``key: value`` line per argument, sorted as ``yaml.dump`` sorts."""
    with open(path, "w") as f:
        for k in sorted(args):
            f.write(f"{k}: {_yaml_scalar(args[k])}\n")


def main(args, device="cuda") -> Optional[Dict]:
    """Train (or, with ``--eval``, evaluate) as ``tpat_tpu.cli.finetune``
    does.  Returns the eval stats with ``--eval``, else the best score and
    epoch."""
    args_checker(args)
    # joins the process group under torchrun (or the JAX names); a no-op
    # for one process
    rank, world, device = dist_lib.init_distributed_mode(card_device(device))
    mesh = make_mesh(args, world)
    is_main = rank == 0
    np.random.seed(args.seed)

    model_cfg, data_cfg, module, loader_train, loader_val = build_everything(
        args, device, mesh
    )
    sd = initial_state_dict(args, model_cfg)

    if args.eval:
        model = AudioViT(model_cfg, device=device)
        model.load_state_dict(sd, strict=True)
        if mesh is not None:
            shard_model_(model, mesh)
        return run_eval(args, model, module, loader_val, device)

    out = Path(args.output_dir)
    if is_main:  # only rank 0 writes (misc.py:297-312)
        out.mkdir(parents=True, exist_ok=True)
        write_args_yaml(out / "args.yaml", vars(args))

    # refuse to clobber an existing run (main_finetune.py:313-316); a resume
    # appends to the same log.  Rank 0's verdict is broadcast, so every rank
    # stops together instead of waiting in the first gradient all-reduce.
    tb_dir = out / "tb_log"
    stop = dist_lib.broadcast_object(tb_dir.exists() and not args.resume)
    if stop:
        dist_lib.print_rank0(f"!! path {tb_dir} exists, stop training")
        raise SystemExit(1)
    tb = None
    if is_main:
        try:  # TensorBoard scalars where TensorBoard is installed
            from torch.utils.tensorboard import SummaryWriter

            tb = SummaryWriter(str(tb_dir))
        except ImportError:
            pass

    state = module.load(sd, seed=args.seed)
    if args.resume:
        payload = ckpt_lib.restore_checkpoint(args.resume)
        ckpt_lib.load_state(state, payload)
        args.start_epoch = payload["epoch"] + 1
        print(f"resumed from {args.resume} at epoch {args.start_epoch}")
    if args.profile_dir and not (
        args.start_epoch <= args.profile_epoch < args.epochs
    ):
        if args.resume and args.profile_epoch < args.epochs:
            print(
                f"note: resuming at epoch {args.start_epoch}, past "
                f"--profile_epoch {args.profile_epoch}; no new trace will "
                "be written this run"
            )
        else:
            raise SystemExit(
                f"--profile_dir set but --profile_epoch "
                f"{args.profile_epoch} is outside the training range "
                f"[{args.start_epoch}, {args.epochs}): no trace would "
                "ever be written"
            )
    # the other ranks track the same score without writing (and join the
    # gathers of a state cut by a model axis)
    keeper = ckpt_lib.BestCheckpointKeeper(
        args.ramdisk_dir or str(out / "scratch"), str(out),
        async_save=args.async_checkpoint,
        snapshot_on_device=args.best_on_device,
    ) if is_main else ckpt_lib.BestScore(
        snapshot_on_device=args.best_on_device)
    metric = "mAP" if args.dataset == "audioset" else "acc1"

    start = time.time()
    for epoch in range(args.start_epoch, args.epochs):
        loader_train.set_epoch(epoch)
        if args.base_keep_rate < 1.0 and epoch >= args.shrink_start_epoch:
            # augmentations off once the shrink begins
            # (main_finetune.py:518-522)
            loader_train.dataset.freqm = 0
            loader_train.dataset.timem = 0
        batches = ((x, y) for x, y, _ in loader_train)
        trace = (args.profile_dir
                 if epoch == args.profile_epoch and is_main else None)
        with profiler_trace(trace):
            state, train_stats = module.train_epoch(
                state, batches, epoch, log_every=20
            )
        if epoch >= args.first_eval_ep:
            test_stats = _eval_once(args, state.model, module, loader_val,
                                    device)
        else:
            test_stats = {metric: -1.0}
        score = test_stats[metric]
        dist_lib.print_rank0(
            f"epoch {epoch}: phase={train_stats['phase']} "
            f"train_loss={train_stats['loss']:.4f} {metric}={score:.4f}"
        )
        if epoch >= args.first_eval_ep:
            # never the -1.0 placeholder of an epoch without eval
            keeper.update(score, state, epoch)
        if (args.save_every_epochs
                and (epoch + 1) % args.save_every_epochs == 0):
            ckpt_lib.save_checkpoint(
                str(out / "last_checkpoint"), state, epoch,
                background=args.async_checkpoint, write=is_main,
            )
        log = {
            **{f"train_{k}": v for k, v in train_stats.items()},
            **{f"test_{k}": v for k, v in test_stats.items()},
            "epoch": epoch,
        }
        if is_main:
            with open(out / "log.txt", "a") as f:
                f.write(json.dumps(log) + "\n")
        if tb is not None:
            for k, v in train_stats.items():
                if isinstance(v, (int, float)):
                    tb.add_scalar(f"train/{k}", v, epoch)
            for k, v in test_stats.items():
                if isinstance(v, (int, float)):
                    tb.add_scalar(f"test/{k}", v, epoch)
            tb.flush()

    keeper.finalize()
    if is_main:
        ckpt_lib.wait_for_checkpoints()
        if tb is not None:
            tb.close()
        print(f"training time {time.time() - start:.1f}s, "
              f"best {metric}={keeper.best_score:.4f} @ epoch "
              f"{keeper.best_epoch}")
        if args.result_path:
            with open(args.result_path, "w") as f:
                f.write(f"{keeper.best_score:.4f}")
    # rank 0's files are on disk before any rank returns
    dist_lib.barrier()
    return {"best_score": keeper.best_score, "best_epoch": keeper.best_epoch}


def cli(argv=None):
    parser = argparse.ArgumentParser(
        "tpat_tpu_torch.cli.finetune", parents=[get_args_parser()]
    )
    main(parser.parse_args(argv))


if __name__ == "__main__":
    cli()
