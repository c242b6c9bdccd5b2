"""The port's pretraining CLI (tpat_tpu_torch.cli.pretrain) end to end on
the CPU, through its argparse entry point, on the tone corpus of
tests/test_cli_e2e.py (16 clips of 1 s, 4 classes) at ``mae_vit_tiny``,
target length 128, batch 8; the pretrain -> finetune chain; and one run
beside ``tpat_tpu.cli.pretrain`` on the same corpus and weights.

Every ``main`` call passes ``device="cpu"``: the default is the card."""

import argparse
import json
import math
import sys

import numpy as np
import pytest
import torch

from tpat_tpu_torch.cli import finetune as ft
from tpat_tpu_torch.cli import pretrain as pt
from tpat_tpu_torch.data.wav import save_wav
from tpat_tpu_torch.engine import pretrain as pretrain_lib
from tpat_tpu_torch.models import mae
from tpat_tpu_torch.models import pos_embed as pe
from tpat_tpu_torch.utils import torch_import as ti
from tpat_tpu_torch.utils import weights

# per-epoch losses of the port's log.txt against the JAX CLI's (f32, the
# plain decoder, the JAX masking noise handed to the port)
CLI_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for these tiny models beside the other test
    workers (as test_torch_finetune_cli), restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_pretrain_corpus")
    rng = np.random.default_rng(0)
    entries = {"tr": [], "ev": []}
    for split, n in (("tr", 16), ("ev", 8)):
        for i in range(n):
            cls = i % 4
            t = np.arange(16000) / 16000
            w = 0.4 * np.sin(2 * math.pi * (300 + 200 * cls) * t)
            w += 0.02 * rng.normal(size=t.size)
            path = str(root / f"{split}{i}.wav")
            save_wav(path, w.astype(np.float32), 16000)
            entries[split].append({"wav": path, "labels": f"/m/{cls:02d}"})
    json.dump({"data": entries["tr"]}, open(root / "train.json", "w"))
    json.dump({"data": entries["ev"]}, open(root / "eval.json", "w"))
    with open(root / "labels.csv", "w") as f:
        f.write("index,mid,display_name\n")
        for c in range(4):
            f.write(f'{c},/m/{c:02d},"tone {c}"\n')
    return root


def _base(corpus, out, *extra):
    return [
        "--dataset", "esc50", "--model", "mae_vit_tiny",
        "--target_length", "128",
        "--data_train", str(corpus / "train.json"),
        "--label_csv", str(corpus / "labels.csv"),
        "--batch_size", "8", "--warmup_epochs", "1",
        "--save_every_epochs", "1", "--num_workers", "2",
        "--output_dir", str(out), *extra,
    ]


def _run(argv):
    return pt.main(pt.get_args_parser().parse_args(argv), device="cpu")


def _log(out):
    return [json.loads(line) for line in open(out / "log.txt") if line.strip()]


@pytest.mark.parametrize("decoder_mode", ["0", "1"])
def test_pretrain_cli_smoke_resume_and_export(corpus, tmp_path, decoder_mode):
    """test_cli_e2e's pretrain smoke: two epochs, a resume from
    checkpoint-001 to three, the exported .pth in the reference layout
    (loads strict through the MAE importer, the decoder flavour's keys
    present), and --resume of that .pth at epoch 0."""
    out = tmp_path / "pre"
    mode = ["--decoder_mode", decoder_mode]
    _run(_base(corpus, out, "--epochs", "2", *mode))
    logs = _log(out)
    assert [e["epoch"] for e in logs] == [0, 1]
    assert all(np.isfinite(e["loss"]) for e in logs)
    assert (out / "checkpoint-001").exists()
    assert (out / "mae_pretrained.pth").exists()

    _run(_base(corpus, out, "--epochs", "3", "--resume",
               str(out / "checkpoint-001"), *mode))
    assert [e["epoch"] for e in _log(out)] == [0, 1, 2]

    obj = torch.load(out / "mae_pretrained.pth", weights_only=True)
    assert obj["epoch"] == 2
    args = pt.get_args_parser().parse_args(_base(corpus, out, *mode))
    cfg = pt.model_config(args, argparse.Namespace(target_length=128,
                                                   num_mel_bins=128))
    sd = ti.mae_state_dict_for(weights.state_dict_of(obj), cfg)
    mae.MaskedAutoencoderViT(cfg).load_state_dict(sd, strict=True)
    swin = "decoder_blocks.0.attn.logit_scale" in sd
    assert swin == (decoder_mode == "1")

    out2 = tmp_path / "pre_from_pth"
    _run(_base(corpus, out2, "--epochs", "1", "--resume",
               str(out / "mae_pretrained.pth"), *mode))
    logs2 = _log(out2)
    assert [e["epoch"] for e in logs2] == [0] and np.isfinite(logs2[0]["loss"])


def test_pretrain_to_finetune_chain(corpus, tmp_path, monkeypatch):
    """test_cli_e2e's chain: pretrain, export, then finetune from the
    .pth at target length 64 (the (8, 8) -> (8, 4) time crop of the pos
    embed); the finetuned best_model's frozen pos embed is the cropped
    pretrain table."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    pre = tmp_path / "pre"
    _run(_base(corpus, pre, "--epochs", "1"))
    pth = pre / "mae_pretrained.pth"
    out = tmp_path / "ft"
    ft.main(ft.get_args_parser().parse_args([
        "--dataset", "esc50", "--model", "audiomae_vit_tiny",
        "--target_length", "64",
        "--audioset_pretrained_model_path", str(pth),
        "--data_train", str(corpus / "train.json"),
        "--data_eval", str(corpus / "eval.json"),
        "--label_csv", str(corpus / "labels.csv"),
        "--nb_classes", "4", "--batch_size", "8", "--epochs", "1",
        "--blr", "2e-3", "--warmup_epochs", "1",
        "--base_keep_rate", "0.6", "--drop_loc", "(1, 3)",
        "--shrink_start_epoch", "2", "--shrink_epochs", "1",
        "--output_dir", str(out),
        "--result_path", str(tmp_path / "chain_result.txt"),
        "--num_workers", "2",
    ]), device="cpu")
    logs = [json.loads(line) for line in open(out / "log.txt")]
    assert len(logs) == 1 and np.isfinite(logs[0]["train_loss"])
    sd = weights.load_pth(str(pth))
    best = torch.load(out / "best_model", weights_only=True)["model"]
    want = pe.crop_time_audio_pos_embed(sd["pos_embed"].numpy(), (8, 8),
                                        (8, 4), num_extra_tokens=1)
    assert want.shape == tuple(best["pos_embed"].shape) == (1, 33, 192)
    np.testing.assert_array_equal(best["pos_embed"].numpy(), want)


def test_pretrain_cli_matches_jax_cli(corpus, tmp_path, monkeypatch):
    """The port's CLI beside ``tpat_tpu.cli.pretrain`` (two epochs of two
    steps, f32, ``--decoder_mode 0``, roll-mag on), both resuming one
    ``.pth`` exported from the JAX model's init: the JAX masking noise of
    each step (its key as the JAX step derives it) is handed to the port's
    step, and the per-epoch losses of the two log.txt agree within rtol
    1e-4."""
    import jax
    import jax.numpy as jnp

    from tpat_tpu.cli import pretrain as jpt
    from tpat_tpu.models import mae as jmae
    from tpat_tpu.utils import torch_export as jte

    flags = ["--epochs", "2", "--decoder_mode", "0",
             "--compute_dtype", "float32"]
    jcfg = jmae.MAEConfig(
        embed_dim=192, depth=6, num_heads=3, decoder_embed_dim=128,
        decoder_depth=2, decoder_num_heads=4, target_length=128,
        num_mel_bins=128, decoder_mode=0, compute_dtype="float32")
    jm = jmae.MaskedAutoencoderViT(jcfg)
    x0 = jnp.zeros((1, 1, 128, 128))
    params = jm.init({"params": jax.random.PRNGKey(5),
                      "masking": jax.random.PRNGKey(1)}, x0, 0.8)["params"]
    pth = str(tmp_path / "init.pth")
    jte.save_pth(pth, params, flavor="mae", epoch=0)

    jout = tmp_path / "jax"
    jpt.main(jpt.get_args_parser().parse_args(
        _base(corpus, jout, *flags, "--resume", pth)))

    def jax_noise(step, batch):
        """The (B, L) noise the JAX step draws at ``step``: its masking
        key is fold_in(PRNGKey(seed), step) split, then the model's
        make_rng('masking')."""
        r_mask, _ = jax.random.split(
            jax.random.fold_in(jax.random.PRNGKey(0), step))
        key = jm.apply({"params": params},
                       method=lambda m: m.make_rng("masking"),
                       rngs={"masking": r_mask})
        return torch.from_numpy(np.array(
            jax.random.uniform(key, (batch, jcfg.num_patches))))

    current = {}
    step_generator = pretrain_lib.step_generator

    def recording(seed, step, device):
        current["step"] = step
        return step_generator(seed, step, device)

    monkeypatch.setattr(pretrain_lib, "step_generator", recording)
    monkeypatch.setattr(
        mae.MaskedAutoencoderViT, "masking_noise",
        lambda self, batch, mask_2d, generator, device=None:
            jax_noise(current["step"], batch).to(device))
    pout = tmp_path / "port"
    _run(_base(corpus, pout, *flags, "--resume", pth))

    got, want = _log(pout), _log(jout)
    assert [e["epoch"] for e in got] == [e["epoch"] for e in want] == [0, 1]
    np.testing.assert_allclose([e["loss"] for e in got],
                               [e["loss"] for e in want], rtol=CLI_RTOL)
    assert sorted(p.name for p in pout.iterdir()) == [
        "checkpoint-000", "checkpoint-001", "log.txt", "mae_pretrained.pth"]


def test_cli_answers_help_and_parser_matches_jax(capsys):
    """``cli(['--help'])`` prints the usage; every flag of
    ``tpat_tpu.cli.pretrain``'s parser, with its default, choices and
    nargs, is the port's."""
    from tpat_tpu.cli import pretrain as jpt

    with pytest.raises(SystemExit) as e:
        pt.cli(["--help"])
    assert e.value.code == 0
    assert "--decoder_mode" in capsys.readouterr().out

    def flags(parser):
        return {a.option_strings[0]: (a.default, a.choices, a.nargs,
                                      a.required, type(a).__name__)
                for a in parser._actions if a.option_strings}

    assert flags(pt.get_args_parser()) == flags(jpt.get_args_parser())


def test_refusals(corpus, tmp_path, monkeypatch):
    """No CUDA: the default device raises; an orbax directory to resume
    from is refused, pointing to tpat-convert; more than one process (run
    across ranks in test_torch_distributed.py) without rank 0's address is
    refused before any data is read; a non-finite epoch loss stops the
    run."""
    args = pt.get_args_parser().parse_args(
        _base(corpus, tmp_path / "o", "--epochs", "1"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.main(args)
    orbax = tmp_path / "orbax_ckpt"
    orbax.mkdir()
    with pytest.raises(ValueError, match="tpat-convert"):
        _run(_base(corpus, tmp_path / "o", "--resume", str(orbax)))
    for var in ("MASTER_ADDR", "COORDINATOR_ADDRESS", "NUM_PROCESSES"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="rank 0's address"):
        _run(_base(corpus, tmp_path / "o2"))
    assert not (tmp_path / "o2").exists()
    with pytest.raises(FloatingPointError, match="epoch 3"):
        pretrain_lib.check_epoch_loss(float("nan"), 3)
    assert pretrain_lib.check_epoch_loss(0.5, 3) == 0.5
