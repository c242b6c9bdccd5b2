"""Export a trained model as a serving artifact for the port.

Same flags as ``tpat_tpu/cli/export_serving.py``.  Reads a reference-layout
``.pth`` (an AudioMAE one loaded strict: a finetuned checkpoint carries the
model's own geometry, so no surgery; an AST one, ``module.v.*`` and
``module.mlp_head.*``, through the AST importer over a fresh model) and
writes ``params.npz`` + ``meta.json`` (``utils/serving.py``), which
``utils.serving.load_forward`` serves on the GPU with bucketed dispatch.
The input is (n, 1, target_length, mel bins) for AudioMAE and AST's
(n, 1, mel bins, target_length) for an ``ast_*`` model; with
``--device_frontend``, raw waveforms (n, num_samples), and the served
forward runs the device frontend first (``ops/frontend.py``; short clips
carry a NaN tail, as ``meta.json`` states).

Example:
    python -m tpat_tpu_torch.cli.export_serving \\
        --model audiomae_vit_base --dataset esc50 --nb_classes 50 \\
        --base_keep_rate 0.7 --drop_loc "(3, 6, 9)" \\
        --finetuned_model_path best_model.pth \\
        --batch_size 1,8,32,128 --out_dir serving/esc50
"""

from __future__ import annotations

import argparse
import ast as pyast


def get_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="audiomae_vit_base",
                   help="config factory name in tpat_tpu_torch.config")
    p.add_argument("--dataset", default="esc50")
    p.add_argument("--nb_classes", type=int, required=True)
    p.add_argument("--target_length", type=int, default=None)
    p.add_argument("--base_keep_rate", type=float, default=1.0)
    p.add_argument("--drop_loc", default="(3, 6, 9)", type=str)
    p.add_argument("--compute_dtype", default="bfloat16")
    p.add_argument("--finetuned_model_path", required=True,
                   help="a reference-layout .pth (convert an orbax "
                        "checkpoint with tpat-convert first)")
    p.add_argument("--batch_size", type=str, default="64",
                   help="one int fixes the artifact's batch; a comma list "
                        "(e.g. '1,8,32,128') makes it bucketed: the loader "
                        "pads each request to the smallest bucket that fits")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--platforms", default=None,
                   help="accepted for flag parity with tpat_tpu; the port's "
                        "artifact holds no lowered program, so it is unused")
    p.add_argument("--device_frontend", action="store_true",
                   help="serve raw PCM (batch, num_samples): the fbank, "
                        "pad with the minimum and normalisation run on the "
                        "device before the model (NaN head/tail short-clip "
                        "contract, stated in meta.json)")
    p.add_argument("--num_samples", type=int, default=None,
                   help="waveform length for --device_frontend; default: "
                        "exactly target_length frames (400 + "
                        "(target_length - 1) * 160 samples at 16 kHz)")
    return p


def _parse_batch_sizes(raw) -> list:
    """Validate --batch_size before any checkpoint is read."""
    try:
        batches = [int(b) for b in str(raw).split(",") if b.strip()]
    except ValueError:
        batches = []
    if not batches or any(b < 1 for b in batches):
        raise SystemExit(
            f"--batch_size must be one or more positive ints "
            f"(comma-separated), got {raw!r}"
        )
    return batches


def main(args):
    batches = _parse_batch_sizes(args.batch_size)
    path = args.finetuned_model_path
    if not path.endswith(".pth"):
        raise SystemExit(
            f"{path!r} is not a .pth: tpat_tpu_torch does not read orbax "
            "checkpoints; convert it with tpat-convert (orbax -> pth) first"
        )

    from tpat_tpu_torch import config as cfg_lib
    from tpat_tpu_torch.models.vit import AudioViT
    from tpat_tpu_torch.ops.frontend import FrontendConfig
    from tpat_tpu_torch.utils import serving
    from tpat_tpu_torch.utils import torch_import as ti
    from tpat_tpu_torch.utils.weights import load_pth

    preset = cfg_lib.DATASET_PRESETS.get(args.dataset)
    target_length = args.target_length or (
        preset.target_length if preset else 1024
    )
    cfg = getattr(cfg_lib, args.model)(
        num_classes=args.nb_classes,
        target_length=target_length,
        drop_loc=tuple(pyast.literal_eval(args.drop_loc)),
        base_keep_rate=args.base_keep_rate,
        drop_path_rate=0.0,
        compute_dtype=args.compute_dtype,
    )
    model = AudioViT(cfg)
    sd = load_pth(path)
    ast_family = cfg.pos_embed_mode != "pre_cls"
    if ast_family and any(k.startswith("v.") for k in sd):
        ti.overlay_state_dict(model, ti.ast_state_dict_for(sd, cfg))
    else:
        model.load_state_dict(sd, strict=True)

    # AudioMAE takes (B, 1, T, F), AST (B, 1, F, T) (ast_models.py:434-436)
    frontend = None
    if args.device_frontend:
        frontend = FrontendConfig(
            num_mel_bins=cfg.num_mel_bins,
            target_length=cfg.target_length,
            norm_mean=preset.norm_mean if preset else -6.6268077,
            norm_std=preset.norm_std if preset else 5.358466,
        )
        fb = frontend.fbank_cfg
        shape = (batches[0], args.num_samples or (
            fb.window_size + (cfg.target_length - 1) * fb.window_shift))
    elif ast_family:
        shape = (batches[0], 1, cfg.num_mel_bins, cfg.target_length)
    else:
        shape = (batches[0], 1, cfg.target_length, cfg.num_mel_bins)
    out = serving.export_forward(
        model, shape, args.out_dir,
        batch_sizes=batches if len(batches) > 1 else None,
        frontend=frontend, ast_orientation=ast_family,
    )
    desc = shape if len(batches) == 1 else (tuple(batches),) + shape[1:]
    print(f"serving artifact written to {out} (input {desc})")
    return out


def cli(argv=None):
    main(get_parser().parse_args(argv))


if __name__ == "__main__":
    cli()
