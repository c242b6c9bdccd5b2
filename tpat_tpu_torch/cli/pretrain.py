"""MAE pretraining CLI of the port: ``tpat_tpu/cli/pretrain.py`` on
PyTorch, with the same flags, defaults and artifacts.

    python -m tpat_tpu_torch.cli.pretrain \\
      --dataset audioset --data_train train.json --label_csv labels.csv \\
      --model mae_vit_base --batch_size 256 --epochs 32 --blr 2e-4 \\
      --mask_2d --mask_t_prob 0.7 --mask_f_prob 0.3 --decoder_mode 1 \\
      --norm_pix_loss --output_dir pretrain_out

(``scripts/run_pretrain.sh``'s flags.)  The host pipeline reads the WAVs
and takes the fbank (SpecAug, noise and mixup off; roll-mag from
``--roll_mag_aug``); ``engine/pretrain.py`` trains the masked autoencoder
(``models/mae.py``: the swin decoder at ``--decoder_mode 1``, the plain
transformer decoder at 0) with AdamW betas (0.9, 0.95), lr = blr * batch /
256 (unless ``--lr``), per-iteration warmup and a cosine to ``--min_lr``.
A non-finite epoch loss stops the run with ``FloatingPointError``.

``--output_dir`` gets ``log.txt`` (one JSON line per epoch: ``epoch``,
``loss``), ``checkpoint-{epoch:03d}`` every ``--save_every_epochs`` epochs
and at the last (``utils/checkpoint.py``'s payload: model, optimizer, step,
epoch and the next step's generator state; written on a background thread
with ``--async_checkpoint true``, joined before exit) and
``mae_pretrained.pth``, ``{"model": state dict, "epoch": epochs - 1}`` in
the reference ``models_mae.py`` layout, which the finetune CLIs import.

``--resume``: a checkpoint of this CLI continues at its epoch + 1 and
step; a reference full-MAE ``.pth`` (``utils/torch_import.py::
mae_state_dict_for``) gives the weights only, with a fresh optimizer, from
epoch 0; an orbax directory of the JAX package is refused (convert it with
``tpat-convert``).

Data parallelism, as ``cli/finetune.py``: ``python -m
torch.distributed.run --nproc_per_node N -m tpat_tpu_torch.cli.pretrain
...`` trains over a global batch of ``batch_size * N`` rows, each rank on
its sampler shard, with lr = blr * batch_size * N / 256 (the global
effective batch); the epoch loss is the mean over the ranks, and only rank
0 writes.

``main(args, device="cuda")`` runs on the card unless the caller passes
another device (the CPU tests pass ``device="cpu"``); without CUDA it
raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import types
from pathlib import Path

import torch

from tpat_tpu_torch import config as cfg_lib
from tpat_tpu_torch.cli import card_device, str2bool
from tpat_tpu_torch.data.datasets import AudiosetDataset
from tpat_tpu_torch.data.loader import DataLoader
from tpat_tpu_torch.data.sampler import EpochShardSampler
from tpat_tpu_torch.engine import pretrain
from tpat_tpu_torch.models.mae import (
    MAEConfig, MaskedAutoencoderViT, mae_vit_base_dec512d8b,
)
from tpat_tpu_torch.parallel import distributed as dist_lib
from tpat_tpu_torch.utils import checkpoint as ckpt_lib
from tpat_tpu_torch.utils import torch_import as ti
from tpat_tpu_torch.utils.weights import state_dict_of


def get_args_parser():
    p = argparse.ArgumentParser("tpat_tpu_torch MAE pretraining", add_help=False)
    p.add_argument("--batch_size", default=64, type=int)
    p.add_argument("--epochs", default=32, type=int)
    p.add_argument("--blr", type=float, default=2e-4)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--min_lr", type=float, default=0.0)
    p.add_argument("--warmup_epochs", type=float, default=4)
    p.add_argument("--weight_decay", type=float, default=0.0001)
    p.add_argument("--mask_ratio", default=0.8, type=float)
    p.add_argument("--mask_2d", action="store_true")
    p.add_argument("--mask_t_prob", default=0.7, type=float)
    p.add_argument("--mask_f_prob", default=0.3, type=float)
    p.add_argument("--norm_pix_loss", action="store_true")
    p.add_argument("--decoder_mode", default=1, type=int)
    p.add_argument("--dataset", default="audioset")
    p.add_argument("--target_length", default=None, type=int,
                   help="override the preset's frame count")
    p.add_argument("--data_train", required=True)
    p.add_argument("--label_csv", required=True)
    p.add_argument("--roll_mag_aug", default=True, type=str2bool)
    p.add_argument("--output_dir", default="./pretrain_out")
    p.add_argument("--num_workers", default=4, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--save_every_epochs", default=4, type=int)
    p.add_argument("--async_checkpoint", type=str2bool, default=False,
                   help="write the periodic checkpoints on a background "
                        "thread (joined before exit)")
    # bf16 matmuls with f32 statistics, the reference's AMP; f32 opt-out
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    # 'exact' forces erf GELU even under bfloat16 (ops/fast_gelu.py)
    p.add_argument("--gelu_impl", default="auto",
                   choices=["auto", "exact", "poly"])
    p.add_argument("--resume", default="",
                   help="a checkpoint of this CLI to resume from, or a "
                        "reference-layout full-MAE .pth to continue "
                        "pretraining from (fresh optimizer)")
    p.add_argument("--export_torch", default=True, type=str2bool,
                   help="also write mae_pretrained.pth (reference "
                        "models_mae.py layout) at the end")
    p.add_argument("--model", default="mae_vit_base",
                   choices=["mae_vit_base", "mae_vit_tiny"])
    return p


def model_config(args, data_cfg):
    """The MAE configuration of ``--model``: ``mae_vit_base_dec512d8b``, or
    the tiny one (192 wide, depth 6 as ``audiomae_vit_tiny``, 3 heads; a
    decoder 128 wide, 2 deep, 4 heads)."""
    common = dict(
        target_length=data_cfg.target_length,
        num_mel_bins=data_cfg.num_mel_bins,
        decoder_mode=args.decoder_mode,
        norm_pix_loss=args.norm_pix_loss,
        mask_2d=args.mask_2d,
        mask_t_prob=args.mask_t_prob,
        mask_f_prob=args.mask_f_prob,
        compute_dtype=args.compute_dtype,
        gelu_impl=args.gelu_impl,
    )
    if args.model == "mae_vit_base":
        return mae_vit_base_dec512d8b(**common)
    return MAEConfig(embed_dim=192, depth=6, num_heads=3,
                     decoder_embed_dim=128, decoder_depth=2,
                     decoder_num_heads=4, **common)


def _resume(args, model, optimizer, cfg) -> tuple:
    """(step, start epoch) after ``--resume``: a checkpoint of this CLI
    restores the model, the optimizer and the step; a reference ``.pth``
    the weights only."""
    ckpt_lib.refuse_orbax(args.resume)
    obj = torch.load(args.resume, map_location="cpu", weights_only=True)
    if ckpt_lib.is_payload(obj):
        model.load_state_dict(obj["model"], strict=True)
        optimizer.load_state_dict(obj["optimizer"])
        step, start = int(obj["step"]), int(obj["epoch"]) + 1
        print(f"resumed from {args.resume}: epoch {start}, step {step}")
        return step, start
    model.load_state_dict(ti.mae_state_dict_for(state_dict_of(obj), cfg),
                          strict=True)
    print(f"initialized from torch checkpoint {args.resume}")
    return 0, 0


def main(args, device="cuda"):
    """Pretrain as ``tpat_tpu.cli.pretrain`` does.  Returns the per-epoch
    mean losses of this run."""
    rank, world, device = dist_lib.init_distributed_mode(card_device(device))
    is_main = rank == 0
    preset = cfg_lib.DATASET_PRESETS[args.dataset]
    data_cfg = dataclasses.replace(preset, freqm=0, timem=0, mixup=0.0)
    if args.target_length:
        data_cfg = dataclasses.replace(data_cfg,
                                       target_length=args.target_length)
    ds = AudiosetDataset(args.data_train, data_cfg, args.label_csv,
                         train=True, roll_mag_aug=args.roll_mag_aug,
                         seed=args.seed)
    loader = DataLoader(
        ds, args.batch_size,
        sampler=EpochShardSampler(len(ds), shuffle=True, seed=args.seed,
                                  world=world, rank=rank),
        num_workers=args.num_workers, drop_last=True,
    )
    dist_lib.check_equal(len(loader), "steps per epoch")

    cfg = model_config(args, data_cfg)
    model = MaskedAutoencoderViT(
        cfg, generator=torch.Generator().manual_seed(args.seed),
        device=device)
    dist_lib.broadcast_(list(model.state_dict().values()))
    # blr scales with the global effective batch (batch_size per rank x
    # world), main_finetune.py:443-449's convention
    lr = args.lr if args.lr else args.blr * args.batch_size * world / 256.0
    lr_fn = pretrain.mae_lr_fn(
        lr=lr, min_lr=args.min_lr, warmup_epochs=args.warmup_epochs,
        epochs=args.epochs, iters_per_epoch=len(loader),
    )
    optimizer = pretrain.make_mae_optimizer(
        model, weight_decay=args.weight_decay,
        pos_trainable=cfg.pos_trainable)
    step, start_epoch = 0, 0
    if args.resume:
        step, start_epoch = _resume(args, model, optimizer, cfg)
    train_step = pretrain.make_mae_train_step(
        model, optimizer, args.mask_ratio, lr_fn, seed=args.seed)

    out = Path(args.output_dir)
    if is_main:
        out.mkdir(parents=True, exist_ok=True)
    losses = []
    t0 = time.time()
    for epoch in range(start_epoch, args.epochs):
        loader.set_epoch(epoch)
        loss_sum = torch.zeros((), device=device)
        n = 0
        for x, _y, _ids in loader:
            loss_sum = train_step(loss_sum, step,
                                  torch.as_tensor(x, device=device))
            step += 1
            n += 1
        dist_lib.all_reduce_mean_([loss_sum])  # the global batch's loss
        mean_loss = pretrain.check_epoch_loss(float(loss_sum) / max(n, 1),
                                              epoch)
        losses.append(mean_loss)
        if not is_main:
            continue
        print(f"epoch {epoch}: loss={mean_loss:.4f} lr={lr_fn(step):.2e}")
        with open(out / "log.txt", "a") as f:
            f.write(json.dumps({"epoch": epoch, "loss": mean_loss}) + "\n")
        if ((args.save_every_epochs > 0
                and (epoch + 1) % args.save_every_epochs == 0)
                or epoch == args.epochs - 1):
            state = types.SimpleNamespace(
                model=model, optimizer=optimizer, step=step,
                generator=pretrain.step_generator(args.seed, step, "cpu"))
            ckpt_lib.save_checkpoint(
                str(out / f"checkpoint-{epoch:03d}"), state, epoch,
                background=args.async_checkpoint,
            )
    if args.export_torch and is_main:
        sd = {k: v.detach().to("cpu", torch.float32)
              for k, v in model.state_dict().items()}
        torch.save({"model": sd, "epoch": args.epochs - 1},
                   out / "mae_pretrained.pth")
        print(f"wrote {out / 'mae_pretrained.pth'}")
    if is_main:
        ckpt_lib.wait_for_checkpoints()  # join background writes, re-raise
    dist_lib.barrier()  # rank 0's files are on disk before any rank returns
    dist_lib.print_rank0(f"pretraining done in {time.time() - t0:.1f}s")
    return losses


def cli(argv=None):
    """``get_args_parser`` is ``add_help=False`` (composable); this parser
    answers ``--help``."""
    parser = argparse.ArgumentParser("tpat_tpu_torch.cli.pretrain",
                                     parents=[get_args_parser()])
    main(parser.parse_args(argv))


if __name__ == "__main__":
    cli()
