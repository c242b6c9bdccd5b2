"""Feature extraction in the port (tpat_tpu_torch.utils.features and
``cli.finetune --eval --flag_extract_features true``) against the JAX
package's, on the CPU: each package's feature files read by the other's
combiner, and both finetune CLIs extracting features from the same corpus
and weights in f32 with sharpened qkv (the parity rule under which the two
packages keep the same top-k sets): the same file names, equal
``topk_idx`` and labels, ``attn_score`` and ``mel`` within rtol 1e-4."""

import json
import math
import os
import sys

import numpy as np
import pytest
import torch

from tpat_tpu.utils import features as jfeatures
from tpat_tpu_torch.cli import finetune as ft
from tpat_tpu_torch.config import audiomae_vit_tiny
from tpat_tpu_torch.data.wav import save_wav
from tpat_tpu_torch.models.vit import AudioViT
from tpat_tpu_torch.utils.features import FeatureWriter, combine_feature_dict

FEATURE_RTOL = 1e-4


def _feature_batches(rng):
    return [{"mel": rng.normal(size=(2, 1, 32, 16)).astype(np.float32),
             "block-1.topk_idx": rng.integers(0, 4, size=(2, 3)),
             "labels": ["x", "y"]} for _ in range(3)]


@pytest.mark.parametrize("writer", ["jax_pth", "jax_npy", "port"])
def test_feature_files_cross_read(tmp_path, rng, writer):
    """The JAX writer's .pth files (torch present) and .npy files (its
    torch-less mode) read by the port's combine_feature_dict, and the
    port's .pth files read by the JAX combiner: equal arrays and label
    lists, None for a missing key."""
    batches = _feature_batches(rng)
    if writer == "port":
        write, combine = FeatureWriter(str(tmp_path)), jfeatures.combine_feature_dict
    else:
        write = jfeatures.FeatureWriter(str(tmp_path),
                                        use_torch=writer == "jax_pth")
        combine = combine_feature_dict
    for i, b in enumerate(batches):
        write(b, i)
    ext = ".npy" if writer == "jax_npy" else ".pth"
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"{k}.{i:04d}{ext}" for i in range(3) for k in batches[0])
    for key in ("mel", "block-1.topk_idx"):
        np.testing.assert_array_equal(
            combine(str(tmp_path), key),
            np.concatenate([b[key] for b in batches]))
    assert list(combine(str(tmp_path), "labels")) == ["x", "y"] * 3
    assert combine(str(tmp_path), "block-2.topk_idx") is None


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Twelve 1-s tone clips of four classes, the manifests and labels, and a
    finetuned .pth at the model's geometry (target 128: 64 patches) with
    sharpened qkv."""
    root = tmp_path_factory.mktemp("torch_feature_corpus")
    rng = np.random.default_rng(0)
    entries = []
    for i in range(12):
        cls = i % 4
        t = np.arange(16000) / 16000
        w = 0.4 * np.sin(2 * math.pi * (300 + 200 * cls) * t)
        w += 0.02 * rng.normal(size=t.size)
        path = str(root / f"ev{i}.wav")
        save_wav(path, w.astype(np.float32), 16000)
        entries.append({"wav": path, "labels": f"/m/{cls:02d}"})
    json.dump({"data": entries}, open(root / "eval.json", "w"))
    with open(root / "labels.csv", "w") as f:
        f.write("index,mid,display_name\n")
        for c in range(4):
            f.write(f'{c},/m/{c:02d},"tone {c}"\n')
    cfg = audiomae_vit_tiny(target_length=128, num_classes=4, drop_loc=(1, 3),
                            base_keep_rate=0.6, compute_dtype="float32")
    sd = {}
    for k, v in AudioViT(cfg).state_dict().items():
        scale = 1.0 if "qkv" in k else 0.05
        sd[k] = torch.from_numpy((rng.normal(size=tuple(v.shape)) * scale)
                                 .astype(np.float32))
    torch.save({"model": sd}, root / "finetuned.pth")
    return root


def extract_argv(corpus, out, feats, *extra):
    return [
        "--dataset", "esc50", "--model", "audiomae_vit_tiny",
        "--target_length", "128", "--data_eval", str(corpus / "eval.json"),
        "--label_csv", str(corpus / "labels.csv"), "--nb_classes", "4",
        "--batch_size", "8", "--epochs", "1", "--base_keep_rate", "0.6",
        "--drop_loc", "(1, 3)", "--compute_dtype", "float32",
        "--output_dir", str(out), "--num_workers", "2", "--eval",
        "--finetuned_model_path", str(corpus / "finetuned.pth"),
        "--flag_extract_features", "true", "--extract_features_path", str(feats),
        *extra,
    ]


def test_extract_features_matches_jax_cli(corpus, tmp_path, monkeypatch):
    """``finetune --eval --flag_extract_features true`` through both CLIs
    (twelve clips in batches of 8, the last ragged): the same file names
    ({key}.{idx:04d}.pth for mel, labels and every block's attn_score,
    topk_idx at the drop blocks), topk_idx and labels equal, attn_score
    and mel within rtol 1e-4; the same acc1.  A second extraction into
    the same directory is refused (exist_ok=False)."""
    from tpat_tpu.cli import finetune as jft

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    feats, jfeats = tmp_path / "port", tmp_path / "jax"
    stats = ft.main(ft.get_args_parser().parse_args(
        extract_argv(corpus, tmp_path / "o", feats)), device="cpu")
    jstats = {}
    real = jft.run_eval
    monkeypatch.setattr(jft, "run_eval", lambda *a, **kw: jstats.update(real(*a, **kw)))
    jft.main(jft.get_args_parser().parse_args(
        extract_argv(corpus, tmp_path / "jo", jfeats)))
    names = sorted(os.listdir(feats))
    assert names == sorted(os.listdir(jfeats))
    depth = audiomae_vit_tiny(drop_loc=(1, 3)).depth
    keys = {"mel", "labels", "block-1.topk_idx", "block-3.topk_idx",
            *(f"block-{i}.attn_score" for i in range(depth))}
    assert names == sorted(f"{k}.{i:04d}.pth" for k in keys for i in range(2))
    for name in names:
        got = torch.load(feats / name, weights_only=False)
        want = torch.load(jfeats / name, weights_only=False)
        if name.startswith("labels"):
            assert got == want and got[0] == "tone 0"
        elif "topk_idx" in name:
            torch.testing.assert_close(got, want, rtol=0, atol=0, check_dtype=False)
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       rtol=FEATURE_RTOL, atol=1e-6, err_msg=name)
    # 64 patches kept at 0.6: ceil(38.4) = 39 at block 1, ceil(23.4) = 24
    assert combine_feature_dict(str(feats), "block-1.topk_idx").shape == (12, 39)
    assert combine_feature_dict(str(feats), "block-3.topk_idx").shape == (12, 24)
    assert stats["acc1"] == jstats["acc1"]
    with pytest.raises(FileExistsError):
        ft.main(ft.get_args_parser().parse_args(
            extract_argv(corpus, tmp_path / "o", feats)), device="cpu")
