"""The port's AST CLI (tpat_tpu_torch.cli.run_ast) end to end on the
CPU, through its argparse entry point, on the tone corpus of
tests/test_cli_e2e.py (16 train and 8 eval clips of 1 s, 4 classes) at
``--model_size tiny_debug`` and 128 frames; and one run of tpat_tpu's
run_ast beside it on the same corpus and initial weights.

Every ``main`` call passes ``device="cpu"``: the default is the card."""

import json
import math
import os
import pickle
import sys

import numpy as np
import pytest
import torch

import jax

from tpat_tpu_torch.cli import run_ast
from tpat_tpu_torch.data.wav import save_wav
from tpat_tpu_torch.models.vit import AudioViT
from tpat_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_reference_layout import (
    _fake_ast_timm_state_dict,
    _fake_deit_state_dict,
)

# result.csv's per-epoch score and train loss against the JAX CLI's, f32:
# the same items, weights and updates in two frameworks
CLI_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Thousands of small torch ops: intra-op threads only contend beside
    the other test workers, so one thread for this module, restored
    after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_ast_corpus")
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


def _argv(corpus, exp, *extra):
    return [
        "--dataset", "esc50", "--model_size", "tiny_debug",
        "--data-train", str(corpus / "train.json"),
        "--data-val", str(corpus / "eval.json"),
        "--label-csv", str(corpus / "labels.csv"),
        "--n_class", "4", "-b", "8", "--audio_length", "128",
        "--metrics", "acc", "--loss", "CE", "--drop_loc", "(1, 3)",
        "--base_keep_rate", "0.6", "--exp-dir", str(exp), "-w", "2", *extra,
    ]


def _run(argv, device="cpu"):
    return run_ast.main(run_ast.get_parser().parse_args(argv), device=device)


def test_run_ast_matches_jax_cli(corpus, tmp_path, monkeypatch):
    """tpat_tpu's run_ast and the port's on the same corpus and flags, from
    scratch, f32, three epochs (dense, anneal at the cosine's t = 0, static)
    with SpecAug until the shrink: result.csv's scores and train losses
    within rtol 1e-4, the same best_result.csv and the same files; the
    initial weights, which each CLI draws from its own generator, are
    carried from the JAX run into the port's.  Then --eval of the port's
    best_audio_model gives the logged best score, and --eval with
    --custom_rank mean and with the intensity band give tpat_tpu's
    scores on the same kept model."""
    from tpat_tpu.cli import run_ast as jrun
    from tpat_tpu.engine import train as jtrain

    flags = ["--n-epochs", "3", "--shrink_start_epoch", "2", "--shrink_epochs",
             "1", "--imagenet_pretrain", "False", "--compute_dtype", "float32",
             "--lr", "1e-3", "--lrscheduler_start", "2"]
    first = []
    real_load = jtrain.TrainModule.load

    def load(self, params, seed=None):
        first.append(jax.tree_util.tree_map(np.asarray, params))
        return real_load(self, params, seed)

    monkeypatch.setattr(jtrain.TrainModule, "load", load)
    jexp = tmp_path / "jax"
    jbest = jrun.main(jrun.get_parser().parse_args(_argv(corpus, jexp, *flags)))
    monkeypatch.setattr(run_ast, "initial_state_dict",
                        lambda args, cfg: state_dict_from_jax(first[0], "ast"))
    exp = tmp_path / "port"
    best = _run(_argv(corpus, exp, *flags))

    got = np.loadtxt(exp / "result.csv", delimiter=",")
    want = np.loadtxt(jexp / "result.csv", delimiter=",")
    assert got.shape == want.shape == (3, 4)
    np.testing.assert_array_equal(got[:, 0], [1, 2, 3])
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=CLI_RTOL)
    assert np.isfinite(got).all()
    assert best == jbest
    np.testing.assert_array_equal(np.loadtxt(exp / "best_result.csv", delimiter=","),
                                  np.loadtxt(jexp / "best_result.csv", delimiter=","))
    assert sorted(os.listdir(exp)) == sorted(os.listdir(jexp)) == [
        "args.yaml", "best_result.csv", "models", "progress.pkl", "result.csv"]
    assert "best_audio_model" in os.listdir(exp / "models")
    progress = pickle.load(open(exp / "progress.pkl", "rb"))
    assert [row[:4] for row in progress] == [
        row[:4] for row in pickle.load(open(jexp / "progress.pkl", "rb"))]
    yaml = pytest.importorskip("yaml")
    assert yaml.safe_load(open(exp / "args.yaml")) == vars(
        run_ast.get_parser().parse_args(_argv(corpus, exp, *flags)))

    assert _run(_argv(corpus, exp, *flags, "--eval")) == best
    assert np.loadtxt(exp / "eval_result.csv").tolist() == [-1.0, best]
    for ablation in (["--custom_rank", "mean"],
                     ["--drop_token_blk_idx", "1", "--retain_min", "-0.2",
                      "--retain_max", "0.6", "--eval_result_path", "band.csv"]):
        score = _run(_argv(corpus, exp, *flags, "--eval", *ablation))
        want_score = jrun.main(jrun.get_parser().parse_args(
            _argv(corpus, jexp, *flags, "--eval", *ablation)))
        assert math.isfinite(score) and score == want_score, ablation
    assert (exp / "band.csv").is_file()


def test_run_ast_speechcommands_dual_eval(corpus, tmp_path):
    """speechcommands with --data-eval: after training, the best model is
    scored on the validation and the test manifests, eval_result.csv =
    [val acc, 0, test acc, 0] (run.py:230-255); the BCE loss path; --eval
    then scores the test split."""
    exp = tmp_path / "spc"
    argv = [a if a != "esc50" else "speechcommands"
            for a in _argv(corpus, exp, "--n-epochs", "1", "--loss", "BCE",
                           "--imagenet_pretrain", "False",
                           "--data-eval", str(corpus / "train.json"))]
    best = _run(argv)
    val, zero, test, zero2 = np.loadtxt(exp / "eval_result.csv")
    assert val == best and zero == zero2 == 0.0 and 0.0 <= test <= 1.0
    assert _run(argv + ["--eval"]) == test


def test_run_ast_eval_requires_checkpoint(corpus, tmp_path):
    """--eval of a missing best_audio_model fails loudly (run.py:258)."""
    with pytest.raises(FileNotFoundError, match="best checkpoint"):
        _run(_argv(corpus, tmp_path / "nope", "--imagenet_pretrain", "False",
                   "--eval"))


def test_run_ast_deit_branch(corpus, tmp_path):
    """--imagenet_pretrain True (alone) reads a local DeiT checkpoint: the
    trunk is its RGB-summed patch conv and adapted pos grid, the DeiT heads
    are not read; a missing path fails naming DeiT (the reference downloads
    it); from scratch differs."""
    sd = _fake_deit_state_dict(np.random.default_rng(21), depth=6, d=192)
    pth = tmp_path / "deit.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pth)
    exp = tmp_path / "exp"
    argv = _argv(corpus, exp, "--imagenet_pretrain", "True",
                 "--imagenet_pretrained_model_path", str(pth), "--n-epochs", "1")
    args = run_ast.get_parser().parse_args(argv)
    _, cfg = run_ast.configs(args)
    init = run_ast.initial_state_dict(args, cfg)
    np.testing.assert_allclose(init["patch_embed.proj.weight"].numpy(),
                               sd["patch_embed.proj.weight"].sum(1, keepdims=True),
                               rtol=1e-6)
    assert torch.equal(init["dist_token"], torch.from_numpy(sd["dist_token"]))
    scratch = run_ast.initial_state_dict(run_ast.get_parser().parse_args(
        _argv(corpus, exp, "--imagenet_pretrain", "False")), cfg)
    assert not torch.equal(scratch["cls_token"], init["cls_token"])
    score = _run(argv)
    assert 0.0 <= score <= 1.0 and (exp / "models" / "best_audio_model").is_file()
    bad = argv[:]
    bad[bad.index(str(pth))] = str(tmp_path / "missing.pth")
    with pytest.raises(FileNotFoundError, match="DeiT"):
        _run(bad)


def test_run_ast_audioset_branch_keeps_the_head_fresh(corpus, tmp_path):
    """--audioset_pretrain True: the trunk, dist token and final norm from
    the AST .pth (its (8, 64) pos grid centre-cut to 8 frames), the
    mlp_head fresh even at a matching class count (ast_models.py:352)."""
    sd = _fake_ast_timm_state_dict(np.random.default_rng(4), depth=6, d=192,
                                   nc=4)
    pth = tmp_path / "ast.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pth)
    args = run_ast.get_parser().parse_args(_argv(
        corpus, tmp_path / "e", "--audioset_pretrain", "True",
        "--audioset_pretrained_model_path", str(pth)))
    _, cfg = run_ast.configs(args)
    init = run_ast.initial_state_dict(args, cfg)
    assert torch.equal(init["norm.weight"], torch.from_numpy(sd["module.v.norm.weight"]))
    pos = sd["module.v.pos_embed"][:, 2:].reshape(8, 64, 192)[:, 28:36]
    np.testing.assert_array_equal(init["pos_embed"][0, 2:].numpy(),
                                  pos.reshape(64, 192))
    fresh = AudioViT(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    for k in ("mlp_head.1.weight", "mlp_head.1.bias", "mlp_head.0.bias"):
        assert torch.equal(init[k], fresh[k]), k


@pytest.mark.parametrize("flags,err,match", [
    (["--imagenet_pretrain", "False", "--audioset_pretrained_model_path", "x.pth"],
     ValueError, "audioset_pretrain"),
    (["--imagenet_pretrain", "False", "--audioset_pretrain", "True",
      "--audioset_pretrained_model_path", "x.pth"], ValueError, "imagenet_pretrain"),
    (["--audioset_pretrain", "True", "--audioset_pretrained_model_path",
      "/missing.pth"], FileNotFoundError, "not found"),
])
def test_run_ast_construction_guards(corpus, tmp_path, flags, err, match):
    """The three loud failures of the construction branches."""
    with pytest.raises(err, match=match):
        _run(_argv(corpus, tmp_path / "g", "--n-epochs", "1", *flags))


def test_specaug_table_and_switch_off(corpus, tmp_path):
    """The per-dataset SpecAug table (run.py:150-158), flags overriding it;
    the loader's dataset reads freqm/timem per item, so zeroing them from
    shrink_start_epoch on (as main does) turns SpecAug off."""
    for ds, fm, tm in (("esc50", 24, 96), ("audioset", 48, 192),
                       ("speechcommands", 48, 48), ("other", 0, 0)):
        args = run_ast.get_parser().parse_args(["--dataset", ds])
        data_cfg, _ = run_ast.configs(args)
        assert (data_cfg.freqm, data_cfg.timem) == (fm, tm)
    args = run_ast.get_parser().parse_args(["--freqm", "3", "--timem", "5"])
    assert run_ast.configs(args)[0].freqm == 3
    from tpat_tpu_torch.data.datasets import AudiosetDataset

    data_cfg, _ = run_ast.configs(run_ast.get_parser().parse_args(
        _argv(corpus, tmp_path)))
    ds = AudiosetDataset(str(corpus / "train.json"), data_cfg,
                         str(corpus / "labels.csv"), train=True, seed=0)
    masked = ds[0][0]
    ds.freqm = ds.timem = 0
    plain = ds[0][0]
    assert not np.array_equal(masked, plain)
    ref = AudiosetDataset(str(corpus / "train.json"), data_cfg,
                          str(corpus / "labels.csv"), train=False)
    np.testing.assert_array_equal(plain, ref[0][0])


@pytest.mark.parametrize("flags,item", [
    (["--eval", "--flag_extract_features", "true",
      "--extract_features_path", "{feats}"], "A7"),
    (["--device_frontend", "true", "--freqm", "0", "--timem", "0",
      "--noise", "False"], "A8"),
    (["--device_dataset", "true"], "A10"),
])
def test_unported_flags_refused(corpus, tmp_path, flags, item, monkeypatch):
    """The flags of A7, A8 and A10, refused until they were ported, now
    run: --eval of a kept model writes its features (cls scores at every
    block, the drop blocks' top-k, the spectrogram in AST's orientation),
    the device frontend trains beside tpat_tpu.cli.run_ast with the same
    flags, from the same initial weights: result.csv within rtol 1e-4, and
    --device_dataset true takes the device cache, which refuses the train
    set under the ESC-50 SpecAug of the AST recipe with its reason (run_ast
    has no roll-mag flag, in JAX either; the runs are held in
    test_torch_device_cache.py)."""
    if item == "A7":
        exp = tmp_path / "o"
        _run(_argv(corpus, exp, "--n-epochs", "1", "--imagenet_pretrain",
                   "False"))
        feats = tmp_path / "feats"
        _run(_argv(corpus, exp, "--imagenet_pretrain", "False",
                   *[f.format(feats=feats) for f in flags]))
        names = set(os.listdir(feats))
        for key in ("mel", "labels", "block-1.topk_idx", "block-3.topk_idx",
                    *(f"block-{i}.attn_score" for i in range(6))):
            assert f"{key}.0000.pth" in names, key
        mel = torch.load(feats / "mel.0000.pth")
        assert mel.shape == (8, 1, 128, 128)
        assert torch.load(feats / "labels.0000.pth") == ["temp"] * 8
        with pytest.raises(FileExistsError):
            _run(_argv(corpus, exp, "--imagenet_pretrain", "False",
                       *[f.format(feats=feats) for f in flags]))
        return
    if item == "A8":
        from tpat_tpu.cli import run_ast as jrun
        from tpat_tpu.engine import train as jtrain

        run = ["--n-epochs", "3", "--shrink_start_epoch", "2", "--shrink_epochs",
               "1", "--imagenet_pretrain", "False", "--compute_dtype", "float32",
               "--lr", "1e-3", "--lrscheduler_start", "2", *flags]
        first = []
        real_load = jtrain.TrainModule.load

        def load(self, params, seed=None):
            first.append(jax.tree_util.tree_map(np.asarray, params))
            return real_load(self, params, seed)

        monkeypatch.setattr(jtrain.TrainModule, "load", load)
        jexp = tmp_path / "jax"
        jbest = jrun.main(jrun.get_parser().parse_args(_argv(corpus, jexp, *run)))
        monkeypatch.setattr(run_ast, "initial_state_dict",
                            lambda args, cfg: state_dict_from_jax(first[0], "ast"))
        exp = tmp_path / "port"
        best = _run(_argv(corpus, exp, *run))
        got = np.loadtxt(exp / "result.csv", delimiter=",")
        want = np.loadtxt(jexp / "result.csv", delimiter=",")
        np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=CLI_RTOL)
        assert np.isfinite(got).all() and best == jbest
        return
    with pytest.raises(ValueError, match="train set cannot be cached: "
                                         "host-side SpecAug"):
        _run(_argv(corpus, tmp_path / "o", *flags))


def test_more_than_one_process_refused(corpus, tmp_path, monkeypatch, capsys):
    """More than one process runs now (data parallelism, held in
    test_torch_distributed.py); the device dataset cache still refuses it,
    as in JAX: 'true' raises, 'auto' declines and says why.  Rank 0 of two
    is faked from the launcher's environment, without a process group."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(run_ast.dist_lib, "init_distributed_mode",
                        lambda device: (0, 2, torch.device(device)))
    with pytest.raises(ValueError, match="eval set cannot be cached: "
                                         "multi-process run"):
        _run(_argv(corpus, tmp_path / "o", "--device_dataset", "true"))
    from tpat_tpu_torch.data.datasets import AudiosetDataset
    from tpat_tpu_torch.data.device_cache import maybe_device_cached

    data_cfg, _ = run_ast.configs(run_ast.get_parser().parse_args(
        _argv(corpus, tmp_path)))
    ds = AudiosetDataset(str(corpus / "eval.json"), data_cfg,
                         str(corpus / "labels.csv"), train=False)
    assert maybe_device_cached(ds, 8, device="cpu", label="eval set") is None
    assert "eval set: streamed from the host (a multi-process run" in (
        capsys.readouterr().out)


def test_run_ast_needs_cuda_unless_cpu_is_asked(corpus, tmp_path, monkeypatch):
    """The default device is the card; without CUDA the CLI raises
    before it reads any data or writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_ast.main(run_ast.get_parser().parse_args(
            _argv(corpus, tmp_path / "o")))
    assert not (tmp_path / "o").exists()
