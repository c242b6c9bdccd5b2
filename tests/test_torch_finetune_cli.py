"""The port's finetune CLI (tpat_tpu_torch.cli.finetune) end to end on
the CPU, through its argparse entry point, on the tone corpus of
tests/test_cli_e2e.py (16 train and 8 eval clips of 1 s, 4 classes) at
audiomae_vit_tiny and target length 128 or 96; and one run of the JAX
CLI beside it on the same corpus and the same seeded ``.pth``.

Every ``main`` call passes ``device="cpu"``: the default is the card."""

import json
import math
import os
import sys

import numpy as np
import pytest
import torch

from tpat_tpu_torch.cli import finetune as ft
from tpat_tpu_torch.config import audiomae_vit_tiny
from tpat_tpu_torch.data.wav import save_wav
from tpat_tpu_torch.models.vit import AudioViT
from tpat_tpu_torch.utils import checkpoint as ckpt_lib

# per-epoch train_loss, test_acc1 and test_loss of the port's log against
# the JAX CLI's, f32, no drop-path and no 2D masking (their draws come
# from different generators): the same items, weights and updates in two
# frameworks
CLI_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tiny models run thousands of small torch ops; beside the other
    test workers, intra-op threads only contend (this file took minutes
    with all threads in a parallel run, seconds alone), so one thread for
    this module, restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    """Both CLIs write TensorBoard scalars only where TensorBoard imports;
    here it does not (its import pulls in TensorFlow, ~10 s a process), so
    the runs take the CLIs' ImportError path."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli_corpus")
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


def _argv(corpus, out, *extra, target=128):
    return [
        "--dataset", "esc50", "--model", "audiomae_vit_tiny",
        "--target_length", str(target),
        "--data_train", str(corpus / "train.json"),
        "--data_eval", str(corpus / "eval.json"),
        "--label_csv", str(corpus / "labels.csv"),
        "--nb_classes", "4", "--batch_size", "8",
        "--blr", "2e-3", "--warmup_epochs", "1",
        "--base_keep_rate", "0.6", "--drop_loc", "(1, 3)",
        "--output_dir", str(out), "--num_workers", "2", *extra,
    ]


def _run(argv, device="cpu"):
    return ft.main(ft.get_args_parser().parse_args(argv), device=device)


def _logs(out):
    return [json.loads(line) for line in open(out / "log.txt")]


def test_finetune_cli_full_loop(corpus, tmp_path):
    """dense, anneal and static epochs with SpecAug, roll-mag, drop-path and
    2D masking; async best checkpoints; args.yaml, log.txt, one best marker,
    best_model and the result file; then --eval on best_model reproduces the
    logged best acc1 and test loss."""
    out = tmp_path / "out"
    argv = _argv(corpus, out, "--epochs", "3", "--shrink_start_epoch", "1",
                 "--shrink_epochs", "1", "--freqm", "4", "--timem", "8",
                 "--roll_mag_aug", "true", "--drop_path", "0.1",
                 "--mask_t_prob", "0.3", "--mask_f_prob", "0.3",
                 "--result_path", str(tmp_path / "result.txt"),
                 "--async_checkpoint", "True")
    best = _run(argv)
    logs = _logs(out)
    assert [entry["train_phase"] for entry in logs] == ["dense", "anneal", "static"]
    assert all(math.isfinite(entry["train_loss"]) for entry in logs)
    assert set(logs[0]) == {"train_loss", "train_grad_norm", "train_phase",
                            "test_acc1", "test_acc5", "test_loss", "epoch"}
    markers = [p for p in os.listdir(out) if p.startswith("best-")]
    assert markers == [f"best-{best['best_epoch']:03d}-{best['best_score']:.4f}.txt"]
    assert (out / "best_model").is_file()
    assert float(open(tmp_path / "result.txt").read()) == round(best["best_score"], 4)
    logged = logs[best["best_epoch"]]
    assert logged["test_acc1"] == best["best_score"]

    yaml = pytest.importorskip("yaml")
    written = yaml.safe_load(open(out / "args.yaml"))
    assert written == vars(ft.get_args_parser().parse_args(argv))

    stats = _run(argv + ["--eval", "--finetuned_model_path", str(out / "best_model"),
                         "--result_path", str(tmp_path / "eval.txt")])
    assert stats["acc1"] == logged["test_acc1"]
    assert stats["loss"] == logged["test_loss"]
    # the same weights as a reference-layout .pth ({'model': state dict})
    pth = tmp_path / "best.pth"
    torch.save({"model": ckpt_lib.restore_checkpoint(str(out / "best_model"))["model"],
                "epoch": best["best_epoch"]}, pth)
    assert _run(argv + ["--eval", "--finetuned_model_path", str(pth)]) == stats

    # a TensorBoard log of an earlier run: no clobbering unless --resume
    (out / "tb_log").mkdir(exist_ok=True)
    with pytest.raises(SystemExit):
        _run(argv)


def test_finetune_cli_resume(corpus, tmp_path):
    """--save_every_epochs + --resume continues from the saved epoch, and
    the resumed run logs the epochs of a run that never stopped, number
    for number (LR schedule, step counter, generator, loader epoch)."""
    base = ["--save_every_epochs", "1", "--drop_path", "0.1",
            "--mask_t_prob", "0.3", "--mask_f_prob", "0.3", "--freqm", "4",
            "--timem", "8", "--shrink_start_epoch", "1", "--shrink_epochs", "1"]
    straight = tmp_path / "straight"
    _run(_argv(corpus, straight, *base, "--epochs", "3", target=96))
    out = tmp_path / "resumed"
    _run(_argv(corpus, out, *base, "--epochs", "1", target=96))
    assert (out / "last_checkpoint").is_file()
    assert len(_logs(out)) == 1
    _run(_argv(corpus, out, *base, "--epochs", "3", "--resume",
               str(out / "last_checkpoint"), target=96))
    assert [entry["epoch"] for entry in _logs(out)] == [0, 1, 2]
    assert _logs(out) == _logs(straight)


def test_finetune_cli_profile_trace(corpus, tmp_path):
    """--profile_dir writes a torch.profiler Chrome trace of
    --profile_epoch; an epoch outside the run is refused up front."""
    out, trace = tmp_path / "out", tmp_path / "trace"
    base = _argv(corpus, out, "--epochs", "1", "--profile_dir", str(trace),
                 target=96)
    with pytest.raises(SystemExit, match="profile_epoch"):
        _run(base)  # --profile_epoch defaults to 1
    _run(base + ["--profile_epoch", "0"])
    events = json.load(open(trace / "trace.json"))["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_finetune_args_checker_mask_probs():
    args = ft.get_args_parser().parse_args(
        ["--data_train", "x", "--data_eval", "y", "--label_csv", "z",
         "--dataset", "esc50", "--nb_classes", "4",
         "--batch_size", "8", "--epochs", "1",
         "--mask_t_prob", "0.7", "--mask_f_prob", "0.3"])
    with pytest.raises(AssertionError, match="mask_t_prob"):
        ft.args_checker(args)


def test_pretrained_head_kernel_reinitialized(corpus, tmp_path):
    """After a pretrained load the head weight is freshly initialised
    (trunc_normal 2e-5) even when the checkpoint carries a head of the
    right width; the bias overlays; the trunk comes from the checkpoint."""
    cfg = audiomae_vit_tiny(compute_dtype="float32", target_length=64,
                            num_classes=4, drop_loc=(1,), base_keep_rate=0.6,
                            drop_path_rate=0.0)
    donor = AudioViT(cfg, generator=torch.Generator().manual_seed(9)).state_dict()
    donor["head.weight"] = torch.full_like(donor["head.weight"], 7.0)
    donor["head.bias"] = torch.full_like(donor["head.bias"], 3.0)
    pth = tmp_path / "donor.pth"
    torch.save({"model": donor, "epoch": 0}, pth)
    args = ft.get_args_parser().parse_args(_argv(
        corpus, tmp_path / "o", "--epochs", "1", "--drop_loc", "(1,)",
        "--audioset_pretrained_model_path", str(pth), target=64))
    sd = ft.initial_state_dict(args, cfg)
    assert sd["head.weight"].abs().max() < 1e-3
    assert torch.equal(sd["head.bias"], donor["head.bias"])
    assert torch.equal(sd["cls_token"], donor["cls_token"])
    assert torch.equal(sd["blocks.2.attn.qkv.weight"], donor["blocks.2.attn.qkv.weight"])


@pytest.mark.parametrize("flags,item", [
    (["--eval", "--finetuned_model_path", "{pth}", "--flag_extract_features",
      "true", "--extract_features_path", "{feats}"], "A7"),
    (["--device_frontend", "true", "--freqm", "0", "--timem", "0"], "A8"),
    (["--device_dataset", "true", "--roll_mag_aug", "true"], "A10"),
])
def test_unported_flags_refused(corpus, tmp_path, flags, item, monkeypatch):
    """The flags of A7, A8 and A10, refused until they were ported, now
    run: feature extraction
    writes every block's features for the analysis (held against the JAX
    CLI in test_torch_features.py), the device frontend trains beside
    tpat_tpu.cli.finetune with the same flags (without SpecAug or noise):
    the log within rtol 1e-4, and --device_dataset true takes the device
    cache, which refuses a train set under roll-mag with its reason (its
    runs are held in test_torch_device_cache.py)."""
    if item == "A7":
        pth, feats = tmp_path / "model.pth", tmp_path / "feats"
        _pretrained_pth(pth)
        cfg = audiomae_vit_tiny(target_length=128, num_classes=4, drop_loc=(1, 3))
        sd = torch.load(pth)["model"]
        sd = {k: v[:, :cfg.num_patches + 1] if k == "pos_embed" else v
              for k, v in sd.items()}
        sd["head.weight"], sd["head.bias"] = sd["head.weight"][:4], sd["head.bias"][:4]
        torch.save({"model": sd}, pth)
        argv = [f.format(pth=pth, feats=feats) for f in flags]
        _run(_argv(corpus, tmp_path / "o", "--epochs", "1", *argv))
        names = set(os.listdir(feats))
        for key in ("mel", "labels", "block-1.topk_idx", "block-3.topk_idx",
                    *(f"block-{i}.attn_score" for i in range(cfg.depth))):
            assert f"{key}.0000.pth" in names, key
        from tpat_tpu_torch.analysis import extract_stats
        taus, _ = extract_stats.kendall_rank(str(feats), None, "mean",
                                             num_blocks=cfg.depth)
        assert len(taus) == cfg.depth
        return
    if item == "A8":
        _finetune_beside_jax(corpus, tmp_path, monkeypatch, flags)
        return
    if item == "A10":
        with pytest.raises(ValueError, match="train set cannot be cached: "
                                             "roll-mag"):
            _run(_argv(corpus, tmp_path / "o", "--epochs", "1", *flags))
        return


def test_model_axis_must_divide_the_world(corpus, tmp_path):
    """--model_axis 2 (tensor parallelism, held across ranks in
    test_torch_tensor_parallel.py) in one process: JAX's assert that the
    model axis divide the device count, one process per device here."""
    with pytest.raises(AssertionError,
                       match="model_axis 2 must divide device count 1"):
        _run(_argv(corpus, tmp_path / "o", "--epochs", "1", "--model_axis", "2"))


def test_device_frontend_specaug_only_in_the_dense_epoch(corpus, tmp_path,
                                                        monkeypatch):
    """--device_frontend with SpecAug on: the preprocess of every train step
    gets specaug=True in the dense epoch only, and False at the hybrid
    anneal's t = 0 step, which stays a hybrid step instead of taking the
    dense one (whose SpecAug the shrink must keep off); eval forwards get
    train=False."""
    calls = []
    real = ft.make_preprocess

    def recording(data_cfg, **kw):
        pre = real(data_cfg, **kw)

        def wrapped(x, generator, specaug, train):
            calls.append((specaug, train))
            return pre(x, generator, specaug, train)
        return wrapped

    monkeypatch.setattr(ft, "make_preprocess", recording)
    phases = []
    real_step = ft.TrainModule.train_step

    def step(self, state, acc, x, y, phase, *a, **kw):
        phases.append(phase)
        return real_step(self, state, acc, x, y, phase, *a, **kw)

    monkeypatch.setattr(ft.TrainModule, "train_step", step)
    _run(_argv(corpus, tmp_path / "o", "--epochs", "3", "--shrink_start_epoch",
               "1", "--shrink_epochs", "1", "--device_frontend", "true",
               "--freqm", "4", "--timem", "8", "--first_eval_ep", "2"))
    train = [specaug for specaug, is_train in calls if is_train]
    assert train == [True, True, False, False, False, False]
    assert phases == ["dense", "dense", "anneal", "anneal", "static", "static"]
    assert [c for c in calls if not c[1]] == [(False, False)]  # one eval batch


def _as_rank_0_of_2(monkeypatch):
    """The launcher's environment of rank 0 of two, the process group
    left out (the runs across ranks are in test_torch_distributed.py)."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(ft.dist_lib, "init_distributed_mode",
                        lambda device: (0, 2, torch.device(device)))


def test_more_than_one_process_refused(corpus, tmp_path, monkeypatch, capsys):
    """More than one process runs now (data parallelism, held in
    test_torch_distributed.py); what it still refuses, as the JAX CLI
    does: feature extraction (main_finetune.py:232), and the device
    dataset cache, which 'true' raises for and 'auto' declines, saying
    why."""
    _as_rank_0_of_2(monkeypatch)
    pth = tmp_path / "model.pth"
    torch.save({"model": AudioViT(audiomae_vit_tiny(
        target_length=128, num_classes=4, drop_loc=(1, 3))).state_dict()}, pth)
    with pytest.raises(ValueError, match="single process"):
        _run(_argv(corpus, tmp_path / "o", "--epochs", "1", "--eval",
                   "--finetuned_model_path",
                   str(pth), "--flag_extract_features", "true",
                   "--extract_features_path", str(tmp_path / "feats")))
    assert not (tmp_path / "feats").exists()
    assert "eval set: streamed from the host (a multi-process run" in (
        capsys.readouterr().out)
    with pytest.raises(ValueError, match="train set cannot be cached: "
                                         "multi-process run"):
        _run(_argv(corpus, tmp_path / "o", "--epochs", "1",
                   "--device_dataset", "true"))


def test_finetune_needs_cuda_unless_cpu_is_asked(corpus, tmp_path, monkeypatch):
    """The default device is the card; without CUDA the CLI raises
    before it reads any data, and never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ft.main(ft.get_args_parser().parse_args(
            _argv(corpus, tmp_path / "o", "--epochs", "1")))
    assert not (tmp_path / "o").exists()


def test_eval_refuses_orbax_directory(corpus, tmp_path):
    (tmp_path / "orbax_ckpt").mkdir()
    with pytest.raises(ValueError, match="tpat-convert"):
        _run(_argv(corpus, tmp_path / "o", "--epochs", "1", "--eval",
                   "--finetuned_model_path", str(tmp_path / "orbax_ckpt")))


def _pretrained_pth(path, seed=0):
    """A seeded 'AudioSet-pretrained' ViT-tiny .pth: 513 pos rows over the
    (8, 64) grid and a 527-class head (dropped on import); qkv N(0, 1), the
    rest N(0, 0.05^2), so the top-k choices are well separated."""
    cfg = audiomae_vit_tiny(target_length=1024, num_classes=527, drop_loc=(1, 3))
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in AudioViT(cfg).state_dict().items():
        scale = 1.0 if "qkv" in k else 0.05
        sd[k] = torch.from_numpy((rng.normal(size=tuple(v.shape)) * scale)
                                 .astype(np.float32))
    torch.save({"model": sd}, path)


def test_finetune_cli_matches_jax_cli(corpus, tmp_path, monkeypatch):
    """The JAX CLI and the port's on the same corpus, flags and seeded
    .pth, in f32 without drop-path or 2D masking: per-epoch train_loss,
    test_acc1 and test_loss within rtol 1e-4.  The head weight, which each
    CLI draws fresh from its own generator, is carried from the JAX run
    into the port's."""
    _finetune_beside_jax(corpus, tmp_path, monkeypatch,
                         ["--freqm", "4", "--timem", "8"])


def _finetune_beside_jax(corpus, tmp_path, monkeypatch, extra):
    from tpat_tpu.cli import finetune as jft

    pth = tmp_path / "pretrained.pth"
    _pretrained_pth(pth)
    flags = ["--epochs", "3", "--shrink_start_epoch", "1", "--shrink_epochs", "1",
             "--compute_dtype", "float32", "--drop_path", "0.0",
             "--mask_t_prob", "0.0", "--mask_f_prob", "0.0",
             "--roll_mag_aug", "true",
             "--audioset_pretrained_model_path", str(pth), "--blr", "5e-3",
             *extra]
    heads = []
    real_load = jft.load_params

    def load_params(args, model, model_cfg):
        params = real_load(args, model, model_cfg)
        heads.append(np.asarray(params["head"]["kernel"]))
        return params

    monkeypatch.setattr(jft, "load_params", load_params)
    jout = tmp_path / "jax"
    jft.main(jft.get_args_parser().parse_args(_argv(corpus, jout, *flags)))

    real_init = ft.initial_state_dict

    def initial_state_dict(args, model_cfg):
        sd = real_init(args, model_cfg)
        sd["head.weight"] = torch.from_numpy(np.ascontiguousarray(heads[0].T))
        return sd

    monkeypatch.setattr(ft, "initial_state_dict", initial_state_dict)
    out = tmp_path / "port"
    _run(_argv(corpus, out, *flags))
    got, want = _logs(out), _logs(jout)
    assert [e["train_phase"] for e in got] == [e["train_phase"] for e in want] \
        == ["dense", "anneal", "static"]
    for g, w in zip(got, want):
        for key in ("train_loss", "test_acc1", "test_loss"):
            np.testing.assert_allclose(g[key], w[key], rtol=CLI_RTOL, err_msg=key)
    assert [p for p in os.listdir(out) if p.startswith("best-")] == \
        [p for p in os.listdir(jout) if p.startswith("best-")]
    assert ckpt_lib.restore_checkpoint(str(out / "best_model"))["epoch"] == \
        int(next(p for p in os.listdir(out) if p.startswith("best-"))[5:8])


def _tiny_ast(factory):
    """``ast_vit_base`` at a test width: the AST flavour, 192 x 2 blocks."""
    import dataclasses

    def tiny(**kw):
        return dataclasses.replace(factory(**kw), embed_dim=192, depth=2,
                                   num_heads=3)
    return tiny


def test_finetune_cli_ast_model_matches_jax_cli(corpus, tmp_path, monkeypatch):
    """``--model ast_vit_base`` (the factory cut to 192 x 2 blocks in both
    packages) through the port's CLI and the JAX CLI for one epoch, f32,
    from the JAX run's initial weights and an AST AudioSet-layout .pth
    whose 4-class mlp_head both keep: train_loss, test_acc1 and test_loss
    within rtol 1e-4.  The loader's (B, 1, T, F) batches go to the model
    as they come, as the JAX CLI feeds them."""
    from tests.test_reference_layout import _fake_ast_timm_state_dict
    from tpat_tpu import config as jcfg
    from tpat_tpu.cli import finetune as jft
    from tpat_tpu_torch import config as cfg_lib
    from tpat_tpu_torch.utils.weights import state_dict_from_jax

    monkeypatch.setattr(jcfg, "ast_vit_base", _tiny_ast(jcfg.ast_vit_base))
    monkeypatch.setattr(cfg_lib, "ast_vit_base", _tiny_ast(cfg_lib.ast_vit_base))
    sd = _fake_ast_timm_state_dict(np.random.default_rng(5), depth=2, d=192, nc=4)
    pth = tmp_path / "ast.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pth)
    flags = ["--model", "ast_vit_base", "--drop_loc", "(1,)", "--epochs", "1",
             "--compute_dtype", "float32", "--drop_path", "0.0", "--freqm", "4",
             "--timem", "8",
             "--audioset_pretrained_model_path", str(pth), "--blr", "5e-3"]
    loaded = []
    real_load = jft.load_params

    def load_params(args, model, model_cfg):
        params = real_load(args, model, model_cfg)
        loaded.append(params)
        return params

    monkeypatch.setattr(jft, "load_params", load_params)
    jout = tmp_path / "jax"
    jft.main(jft.get_args_parser().parse_args(_argv(corpus, jout, *flags)))
    real_init = ft.initial_state_dict
    port_init = {}

    def initial_state_dict(args, model_cfg):
        port_init.update(real_init(args, model_cfg))
        return state_dict_from_jax(loaded[0], "ast")

    monkeypatch.setattr(ft, "initial_state_dict", initial_state_dict)
    out = tmp_path / "port"
    _run(_argv(corpus, out, *flags))
    # the port's own import took the same checkpoint entries
    for k in ("cls_token", "dist_token", "norm.weight", "mlp_head.1.weight"):
        src = sd["module." + ("v." if not k.startswith("mlp_head") else "") + k]
        assert torch.equal(port_init[k], torch.from_numpy(src)), k
    (g,), (w,) = _logs(out), _logs(jout)
    assert g["train_phase"] == w["train_phase"] == "dense"
    for key in ("train_loss", "test_acc1", "test_loss"):
        np.testing.assert_allclose(g[key], w[key], rtol=CLI_RTOL, err_msg=key)


@pytest.mark.parametrize("ablation", [
    ["--custom_rank", "mean"],
    ["--base_keep_rate", "1.0", "--drop_token_blk_idx", "1",
     "--retain_min", "-0.2", "--retain_max", "0.6"],
])
def test_eval_ablations_match_jax_cli(corpus, tmp_path, ablation, monkeypatch):
    """--eval of a finetuned reference .pth with the custom-rank ablation
    and with the intensity band (after block 1, at keep 1.0) through both
    CLIs: the same acc1, and test loss within rtol 1e-4."""
    from tpat_tpu.cli import finetune as jft

    cfg = audiomae_vit_tiny(compute_dtype="float32", target_length=128,
                            num_classes=4, drop_loc=(1, 3), base_keep_rate=0.6)
    rng = np.random.default_rng(8)
    sd = {k: torch.from_numpy((rng.normal(size=tuple(v.shape))
                               * (1.0 if "qkv" in k else 0.05)).astype(np.float32))
          for k, v in AudioViT(cfg).state_dict().items()}
    pth = tmp_path / "finetuned.pth"
    torch.save({"model": sd}, pth)
    argv = _argv(corpus, tmp_path / "o", "--epochs", "1", "--eval",
                 "--compute_dtype", "float32", "--finetuned_model_path", str(pth),
                 *ablation)
    got = _run(argv)
    stats = {}
    real_run_eval = jft.run_eval
    monkeypatch.setattr(jft, "run_eval", lambda *a, **kw: stats.update(
        real_run_eval(*a, **kw)))
    jft.main(jft.get_args_parser().parse_args(argv))
    assert 0.0 < got["acc1"] and got["acc1"] == stats["acc1"]
    np.testing.assert_allclose(got["loss"], stats["loss"], rtol=CLI_RTOL)
