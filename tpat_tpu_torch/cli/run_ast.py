"""AST CLI of the port: ``tpat_tpu/cli/run_ast.py`` (the reference's
``ast/src/run.py``) on PyTorch, with the same flags (dashes included),
defaults and artifacts.

    python -m tpat_tpu_torch.cli.run_ast \\
      --dataset esc50 --data-train train.json --data-val eval.json \\
      --label-csv labels.csv --n_class 50 --audio_length 512 --lr 1e-5 \\
      -b 48 --n-epochs 25 --freqm 24 --timem 96 --mixup 0 \\
      --dataset_mean -6.6268077 --dataset_std 5.358466 --metrics acc \\
      --loss CE --warmup False --lrscheduler_start 5 --lrscheduler_step 1 \\
      --lrscheduler_decay 0.85 --base_keep_rate 0.7 --drop_loc "(3, 6, 9)" \\
      --imagenet_pretrain True --audioset_pretrain True \\
      --audioset_pretrained_model_path audioset_16_16_0.4422.pth \\
      --exp-dir exp/esc50

    # eval of the kept model, optionally with an ablation
    python -m tpat_tpu_torch.cli.run_ast ... --eval [--custom_rank mean]
    python -m tpat_tpu_torch.cli.run_ast ... --eval --drop_token_blk_idx 3 \\
      --retain_min -0.6170 --retain_max 1.0952

The AST recipe: Adam with coupled L2, MultiStepLR and the optional
1000-step warmup (``engine/optimizer.py``), hard CE or BCE, epochs counted
from 1, the per-dataset SpecAug table, switched off once the shrink
starts.  The host loader emits (B, 1, T, F) and the CLI hands the model
AST's (B, 1, F, T).  The model starts from an AST AudioSet checkpoint
(``--audioset_pretrain True``: its mlp_head always fresh), from a DeiT
ImageNet checkpoint (``--imagenet_pretrain True`` alone), or from scratch.

``--exp-dir`` gets ``args.yaml``, ``result.csv`` (epoch, score, train loss,
0 per row), ``progress.pkl``, ``best_result.csv`` (best epoch, score) and
``models/best_audio_model`` (the first epoch of the best score);
speechcommands with ``--data-eval`` also ``eval_result.csv`` (validation
and test accuracy of the best model).  ``--eval`` scores
``models/best_audio_model`` and writes ``--eval_result_path``.

``--eval --flag_extract_features true --extract_features_path feats``
writes each eval batch's features as ``feats/{key}.{batch:04d}.pth``
(``utils/features.py``; the directory must not exist).
``--device_frontend true``: the loader ships raw waveforms, and the fbank,
SpecAug, normalisation and noise run on the device, then the transpose to
AST's orientation (``ops/frontend.py``).

``--device_dataset`` (``data/device_cache.py``, as in ``cli/finetune.py``):
'auto' copies the validation set, and the train set where no host-side
augmentation draws (no mixup, and SpecAug and noise off or on the device
under ``--device_frontend true``), to the device once; 'true' requires it
for both and raises the reason; 'false' streams.  The speechcommands test
split always streams, as in JAX.

Data parallelism, as ``cli/finetune.py`` (beyond the reference, whose AST
recipe is one process with ``nn.DataParallel``): ``python -m
torch.distributed.run --nproc_per_node N -m tpat_tpu_torch.cli.run_ast
...`` trains over a global batch of ``-b * N`` rows, each rank on its
sampler shard; every rank scores the whole validation set, and only rank 0
writes.  The speechcommands dual eval of the best model is skipped at more
than one process (rerun with ``--eval``), as in JAX.

``main(args, device="cuda")`` runs on the card unless the caller passes
another device (the CPU tests pass ``device="cpu"``); without CUDA it
raises.
"""

from __future__ import annotations

import argparse
import ast as pyast
import dataclasses
import os
import pickle
import time

import numpy as np
import torch

from tpat_tpu_torch import config as cfg_lib
from tpat_tpu_torch.cli import card_device, str2bool
from tpat_tpu_torch.cli.finetune import write_args_yaml
from tpat_tpu_torch.data.datasets import AudiosetDataset
from tpat_tpu_torch.data.device_cache import maybe_device_cached
from tpat_tpu_torch.data.loader import DataLoader
from tpat_tpu_torch.data.sampler import EpochShardSampler
from tpat_tpu_torch.engine import evaluate as eval_lib
from tpat_tpu_torch.engine.train import TrainModule
from tpat_tpu_torch.models.vit import AudioViT
from tpat_tpu_torch.ops.frontend import make_preprocess
from tpat_tpu_torch.parallel import distributed as dist_lib
from tpat_tpu_torch.utils import checkpoint as ckpt_lib
from tpat_tpu_torch.utils import torch_import as ti
from tpat_tpu_torch.utils.features import FeatureWriter
from tpat_tpu_torch.utils.weights import load_pth

# SpecAug strengths per dataset (run.py:150-158); --freqm/--timem override
FREQM = {"audioset": 48, "speechcommands": 48, "esc50": 24}
TIMEM = {"audioset": 192, "speechcommands": 48, "esc50": 96}


def get_parser():
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )
    p.add_argument("--data-train", type=str, default="")
    p.add_argument("--data-val", type=str, default="")
    p.add_argument("--data-eval", type=str, default="")
    p.add_argument("--label-csv", type=str, default="")
    p.add_argument("--n_class", type=int, default=527)
    p.add_argument("--model", type=str, default="ast")
    p.add_argument("--dataset", type=str, default="audioset")
    p.add_argument("--exp-dir", type=str, default="")
    p.add_argument("--ramdisk_dir", type=str, default="")
    p.add_argument("--async_checkpoint", type=str2bool, default=False,
                   help="write best checkpoints on a background thread")
    p.add_argument("--best_on_device", type=str2bool, default=False,
                   help="keep the best state as a device copy, written once "
                        "at the end")
    p.add_argument("--lr", "--learning-rate", default=0.001, type=float)
    p.add_argument("-b", "--batch-size", default=12, type=int)
    p.add_argument("-w", "--num-workers", default=8, type=int)
    p.add_argument("--n-epochs", type=int, default=1)
    p.add_argument("--n-print-steps", type=int, default=100)
    p.add_argument("--mixup", type=float, default=0)
    p.add_argument("--fstride", type=int, default=16)
    p.add_argument("--tstride", type=int, default=16)
    p.add_argument("--imagenet_pretrain", type=pyast.literal_eval, default="True")
    p.add_argument("--audioset_pretrain", type=pyast.literal_eval, default="False")
    p.add_argument("--dataset_mean", type=float, default=-4.2677393)
    p.add_argument("--dataset_std", type=float, default=4.5689974)
    p.add_argument("--audio_length", type=int, default=1024)
    p.add_argument("--noise", type=pyast.literal_eval, default="False")
    p.add_argument("--metrics", type=str, default=None, choices=["acc", "mAP"])
    p.add_argument("--loss", type=str, default=None, choices=["BCE", "CE"])
    p.add_argument("--warmup", type=pyast.literal_eval, default="False")
    p.add_argument("--lrscheduler_start", type=int, default=2)
    p.add_argument("--lrscheduler_step", type=int, default=1)
    p.add_argument("--lrscheduler_decay", type=float, default=0.5)
    # None: the per-dataset table (the reference has no such flags)
    p.add_argument("--freqm", type=int, default=None)
    p.add_argument("--timem", type=int, default=None)
    # EViT
    p.add_argument("--shrink_start_epoch", type=int, default=999)
    p.add_argument("--shrink_epochs", type=int, default=999)
    p.add_argument("--base_keep_rate", type=float, default=1.0)
    p.add_argument("--drop_loc", default="(3, 6, 9)", type=str)
    p.add_argument("--extract_features_path", type=str, default=None)
    p.add_argument("--flag_extract_features", type=str2bool, default=False)
    p.add_argument("--audioset_pretrained_model_path", type=str, default=None)
    # a local timm vit_deit_base_distilled_patch16_384 state dict, read with
    # --imagenet_pretrain True and --audioset_pretrain False (the reference
    # downloads it through timm)
    p.add_argument("--imagenet_pretrained_model_path", type=str, default=None)
    p.add_argument("--eval", action="store_true")
    p.add_argument("--model_size", type=str, default="base384")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--custom_rank", default=None, type=str)
    p.add_argument("--retain_min", default=-100.0, type=float)
    p.add_argument("--retain_max", default=100.0, type=float)
    p.add_argument("--drop_token_blk_idx", default=None, type=int)
    p.add_argument("--first_eval_epoch", default=0, type=int)
    p.add_argument("--eval_result_path", default="eval_result.csv", type=str)
    # bf16 matmuls with f32 softmax and statistics, as the reference's
    # autocast
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--gelu_impl", default="auto",
                   choices=["auto", "exact", "poly"])
    p.add_argument("--device_frontend", type=str2bool, default=False,
                   help="compute the Kaldi fbank on the device (the loader "
                        "emits raw waveforms)")
    p.add_argument("--device_dataset", default="auto",
                   choices=["auto", "true", "false"],
                   help="device-resident dataset cache (data/device_cache.py;"
                        " see cli/finetune.py --device_dataset)")
    return p


def configs(args):
    """(data config, model config) of the flags."""
    data_cfg = cfg_lib.DataConfig(
        name=args.dataset,
        num_classes=args.n_class,
        target_length=args.audio_length,
        norm_mean=args.dataset_mean,
        norm_std=args.dataset_std,
        multilabel=args.metrics == "mAP",
        use_noise=bool(args.noise),
        loss_type="bce" if args.loss == "BCE" else "ce_hard",
        freqm=args.freqm if args.freqm is not None else FREQM.get(args.dataset, 0),
        timem=args.timem if args.timem is not None else TIMEM.get(args.dataset, 0),
        mixup=args.mixup,
    )
    model_cfg = cfg_lib.ast_vit_base(
        num_classes=args.n_class,
        target_length=args.audio_length,
        drop_loc=tuple(pyast.literal_eval(args.drop_loc)),
        base_keep_rate=args.base_keep_rate,
        compute_dtype=args.compute_dtype,
        gelu_impl=args.gelu_impl,
    )
    if args.model_size == "tiny_debug":  # a test scale, not in the reference
        model_cfg = dataclasses.replace(
            model_cfg, embed_dim=192, depth=6, num_heads=3
        )
    else:
        assert args.model_size == "base384", "only base384 (ast_models.py:286)"
    return data_cfg, model_cfg


def initial_state_dict(args, model_cfg):
    """The construction branches of ``ast_models.py:273-381`` over a model
    initialised from ``--seed``: the AST AudioSet checkpoint (which needs
    ImageNet pretraining underneath; its mlp_head is never taken), the DeiT
    ImageNet checkpoint, or nothing (from scratch)."""
    model = AudioViT(model_cfg,
                     generator=torch.Generator().manual_seed(args.seed))
    if args.audioset_pretrained_model_path and not args.audioset_pretrain:
        # the reference reads the path only under audioset_pretrain
        # (ast_models.py:343-349): fail instead of ignoring it
        raise ValueError(
            "--audioset_pretrained_model_path was given but "
            "--audioset_pretrain is False; pass --audioset_pretrain True to "
            "load it"
        )
    if args.audioset_pretrain:
        if not args.imagenet_pretrain:
            raise ValueError(
                "audioset_pretrain requires imagenet_pretrain=True "
                "(ast_models.py:344-345)"
            )
        path = args.audioset_pretrained_model_path
        if not path or not os.path.exists(path):
            raise FileNotFoundError(
                f"--audioset_pretrained_model_path {path!r} not found"
            )
        imported = ti.ast_state_dict_for(load_pth(path), model_cfg)
        imported = {k: v for k, v in imported.items()
                    if not k.startswith("mlp_head.")}
        ti.overlay_state_dict(model, imported)
        print(f"loaded AST checkpoint {path}")
    elif args.imagenet_pretrain:
        path = args.imagenet_pretrained_model_path
        if not path or not os.path.exists(path):
            raise FileNotFoundError(
                "--imagenet_pretrain True needs a local DeiT checkpoint via "
                "--imagenet_pretrained_model_path (the reference downloads "
                "vit_deit_base_distilled_patch16_384 through timm, "
                f"ast_models.py:275); got {path!r}"
            )
        ti.overlay_state_dict(
            model, ti.deit_state_dict_for(load_pth(path), model_cfg))
        print(f"loaded DeiT ImageNet checkpoint {path}")
    return model.state_dict()


def ast_batches(loader, waveform: bool = False):
    """The loader's (B, 1, T, F) batches in AST's (B, 1, F, T) orientation
    (``ast_models.py:434-436``); waveform batches as they come (the
    preprocess transposes after the device frontend); a batch of the device
    cache is transposed on the device."""
    for x, y, _ids in loader:
        if not waveform:
            x = (x.transpose(2, 3).contiguous() if isinstance(x, torch.Tensor)
                 else np.ascontiguousarray(x.transpose(0, 1, 3, 2)))
        yield x, y


def _preprocess(args, data_cfg):
    return (make_preprocess(data_cfg, ast_orientation=True)
            if args.device_frontend else None)


def _score(args, model, loader, device, data_cfg, metrics=None,
           **kw) -> float:
    batches = ast_batches(loader, bool(args.device_frontend))
    kw["preprocess"] = _preprocess(args, data_cfg)
    if (metrics or args.metrics) == "acc":
        stats = eval_lib.evaluate_classification(
            model, batches, args.batch_size, device, **kw)
        return stats["acc1"] / 100.0
    stats = eval_lib.evaluate_multilabel(
        model, batches, args.batch_size, device, **kw)
    return stats["mAP"]


def _eval_loader(args, path, data_cfg, device=None):
    """The eval loader of ``path``: device-resident under
    ``--device_dataset`` where ``device`` is given (the validation set),
    else the host loader."""
    ds = AudiosetDataset(path, data_cfg, args.label_csv, train=False,
                         return_waveform=bool(args.device_frontend))
    cached = None
    if device is not None:
        cached = maybe_device_cached(
            ds, args.batch_size, shuffle=False, num_workers=args.num_workers,
            device=device, mode=args.device_dataset, label="eval set")
    return cached or DataLoader(ds, args.batch_size, shuffle=False,
                                num_workers=args.num_workers)


def _load_model(path, model_cfg, device) -> AudioViT:
    model = AudioViT(model_cfg, device=device)
    model.load_state_dict(ckpt_lib.restore_checkpoint(path)["model"],
                          strict=True)
    return model


def run_eval(args, model_cfg, data_cfg, loader_val, device) -> float:
    """``--eval``: score ``models/best_audio_model`` (speechcommands on its
    test split, others on the validation loader, run.py:264-270) and write
    [-1, score] to ``--eval_result_path``."""
    best = os.path.join(args.exp_dir, "models", "best_audio_model")
    if not os.path.exists(best):
        # the reference's torch.load fails on a missing best_audio_model
        raise FileNotFoundError(
            f"no best checkpoint at {best}; train first or fix --exp-dir"
        )
    model = _load_model(best, model_cfg, device)
    loader = (_eval_loader(args, args.data_eval, data_cfg)
              if args.dataset == "speechcommands" and args.data_eval
              else loader_val)
    band = None
    if args.drop_token_blk_idx is not None:
        band = (args.retain_min, args.retain_max, args.drop_token_blk_idx)
    writer = None
    if args.flag_extract_features:
        # exist_ok=False (run.py:261): an earlier run's batch files would be
        # globbed into the analysis with the new ones
        os.makedirs(args.extract_features_path, exist_ok=False)
        writer = FeatureWriter(args.extract_features_path)
    score = _score(args, model, loader, device, data_cfg,
                   custom_rank=args.custom_rank, intensity_band=band,
                   feature_writer=writer)
    if dist_lib.is_main_process():
        print(f"{args.metrics}: {score:.6f}")
        np.savetxt(os.path.join(args.exp_dir, args.eval_result_path),
                   [-1, score])
    return score


def main(args, device="cuda") -> float:
    """Train (or, with ``--eval``, evaluate) as ``tpat_tpu.cli.run_ast``
    does.  Returns the best validation score (the eval score with
    ``--eval``)."""
    assert args.fstride == 16 and args.tstride == 16, (
        "only fstride=tstride=16 (ast_models.py:258)"
    )
    assert args.model == "ast", f"only the ast model is supported, got {args.model!r}"
    rank, world, device = dist_lib.init_distributed_mode(card_device(device))
    is_main = rank == 0
    np.random.seed(args.seed)
    data_cfg, model_cfg = configs(args)
    loader_val = _eval_loader(args, args.data_val or args.data_eval, data_cfg,
                              device)
    if is_main:
        os.makedirs(args.exp_dir or ".", exist_ok=True)
    if args.eval:
        return run_eval(args, model_cfg, data_cfg, loader_val, device)

    if is_main:
        write_args_yaml(os.path.join(args.exp_dir, "args.yaml"), vars(args))
    ds_train = AudiosetDataset(args.data_train, data_cfg, args.label_csv,
                               train=True, seed=args.seed,
                               return_waveform=bool(args.device_frontend))
    sampler = EpochShardSampler(len(ds_train), shuffle=True, seed=args.seed,
                                world=world, rank=rank)
    loader_train = maybe_device_cached(
        ds_train, args.batch_size, sampler=sampler,
        num_workers=args.num_workers, drop_last=True, device=device,
        mode=args.device_dataset, label="train set",
    ) or DataLoader(
        ds_train, args.batch_size, sampler=sampler,
        num_workers=args.num_workers, drop_last=True,
    )
    dist_lib.check_equal(len(loader_train), "train steps per epoch")
    drop_loc = model_cfg.drop_loc
    train_cfg = cfg_lib.TrainConfig(
        batch_size=args.batch_size,
        epochs=args.n_epochs + 1,  # AST counts epochs 1..n_epochs
        lr=args.lr,
        seed=args.seed,
        base_keep_rate=args.base_keep_rate,
        drop_loc=drop_loc,
        shrink_start_epoch=args.shrink_start_epoch,
        shrink_epochs=args.shrink_epochs,
        optimizer="ast_adam",
        lrscheduler_start=args.lrscheduler_start,
        lrscheduler_step=args.lrscheduler_step,
        lrscheduler_decay=args.lrscheduler_decay,
        warmup=bool(args.warmup),
        keep_rate_iter_mode="per_epoch",
        epoch_base=1,
        num_hosts=world,
    )
    module = TrainModule(
        model_cfg, train_cfg, data_cfg.loss_type,
        iters_per_epoch=len(loader_train), device=device,
        custom_rank=args.custom_rank,  # run.py:204-206 sets it model-wide
        preprocess=_preprocess(args, data_cfg),
    )
    state = module.load(initial_state_dict(args, model_cfg), seed=args.seed)
    models_dir = os.path.join(args.exp_dir, "models")
    # AST keeps the FIRST epoch of a tied best (traintest.py:236-247)
    # the other ranks track the same score without writing
    keeper = ckpt_lib.BestCheckpointKeeper(
        os.path.join(args.ramdisk_dir or args.exp_dir, "models"), models_dir,
        ties="first", async_save=args.async_checkpoint,
        snapshot_on_device=args.best_on_device,
    ) if is_main else ckpt_lib.BestScore(ties="first")

    progress = []  # progress.pkl (traintest.py:72-76)
    start = time.time()
    result = np.zeros([args.n_epochs, 4])
    for epoch in range(1, args.n_epochs + 1):
        loader_train.set_epoch(epoch)
        if args.base_keep_rate < 1.0 and epoch >= args.shrink_start_epoch:
            loader_train.dataset.freqm = 0
            loader_train.dataset.timem = 0
        state, tstats = module.train_epoch(
            state, ast_batches(loader_train, bool(args.device_frontend)), epoch,
            log_every=args.n_print_steps,
        )
        score = _score(args, state.model, loader_val, device, data_cfg)
        dist_lib.print_rank0(
            f"epoch {epoch}: train_loss={tstats['loss']:.4f} score={score:.6f}")
        result[epoch - 1] = [epoch, score, tstats["loss"], 0.0]
        if is_main:
            np.savetxt(os.path.join(args.exp_dir, "result.csv"), result,
                       delimiter=",")
        if epoch >= args.first_eval_epoch:
            if is_main:
                keeper.update(score, state, epoch)
            else:
                keeper.track(score, epoch)
        progress.append([epoch, epoch * len(loader_train), keeper.best_epoch,
                         keeper.best_score, time.time() - start])
        if is_main:
            with open(os.path.join(args.exp_dir, "progress.pkl"), "wb") as f:
                pickle.dump(progress, f)

    if not is_main:
        dist_lib.barrier()  # rank 0's files are on disk before it returns
        return keeper.best_score
    keeper.finalize()
    best = os.path.join(models_dir, "best_audio_model")
    if os.path.exists(os.path.join(models_dir, "best_model")):
        os.replace(os.path.join(models_dir, "best_model"), best)
    np.savetxt(os.path.join(args.exp_dir, "best_result.csv"),
               [keeper.best_epoch, keeper.best_score], delimiter=",")

    # speechcommands: the best-on-validation model on the held-out test set
    # too, eval_result.csv = [val acc, 0, test acc, 0] (run.py:230-255);
    # at more than one process rank 0 skips it, as the JAX CLI does
    if args.dataset == "speechcommands" and args.data_eval and world > 1:
        print("[run_ast] skipping the final speechcommands dual eval at more "
              "than one process; rerun it in one process with --eval")
    elif args.dataset == "speechcommands" and args.data_eval:
        model = _load_model(best, model_cfg, device)
        val = _score(args, model, loader_val, device, data_cfg, metrics="acc")
        test = _score(args, model, _eval_loader(args, args.data_eval, data_cfg),
                      device, data_cfg, metrics="acc")
        np.savetxt(os.path.join(args.exp_dir, "eval_result.csv"),
                   [val, 0.0, test, 0.0])
        print(f"valid acc {val:.6f}, test acc {test:.6f}")
    dist_lib.barrier()
    return keeper.best_score


def cli(argv=None):
    main(get_parser().parse_args(argv))


if __name__ == "__main__":
    cli()
