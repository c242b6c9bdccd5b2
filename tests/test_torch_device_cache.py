"""The port's device-resident dataset cache (tpat_tpu_torch.data.
device_cache) on the CPU, the "device" here being the CPU: its batches
equal the streaming loader's and the JAX package's cache's bit for bit, one
copy is shared, the datasets whose items draw randomness are refused (and
'auto' takes exactly the sets JAX's 'auto' takes), and the finetune CLI
gives the same run cached and streamed.  Mirrors tests/test_device_cache.py
on the tone corpus there (10 clips of 1 s, 4 classes)."""

import dataclasses
import json
import math
import sys

import numpy as np
import pytest
import torch

from tpat_tpu_torch.config import DATASET_PRESETS
from tpat_tpu_torch.data import device_cache as dc
from tpat_tpu_torch.data.datasets import AudiosetDataset
from tpat_tpu_torch.data.loader import DataLoader
from tpat_tpu_torch.data.sampler import EpochShardSampler
from tpat_tpu_torch.data.wav import save_wav


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_dc_corpus")
    sr = 16000
    rng = np.random.default_rng(7)
    entries = []
    for i in range(10):
        t = np.arange(sr) / sr
        wave = 0.4 * np.sin(2 * math.pi * (250 + 150 * (i % 4)) * t)
        wave += 0.02 * rng.normal(size=sr)
        path = str(root / f"c{i}.wav")
        save_wav(path, wave.astype(np.float32), sr)
        entries.append({"wav": path, "labels": f"/m/{i % 4:02d}"})
    manifest = str(root / "data.json")
    json.dump({"data": entries}, open(manifest, "w"))
    label_csv = str(root / "labels.csv")
    with open(label_csv, "w") as f:
        f.write("index,mid,display_name\n")
        for c in range(4):
            f.write(f'{c},/m/{c:02d},"tone {c}"\n')
    return manifest, label_csv


def _cfg(presets=DATASET_PRESETS, **kw):
    base = dict(target_length=128, num_classes=4, freqm=0, timem=0,
                mixup=0.0, roll_mag_aug=False)
    base.update(kw)
    return dataclasses.replace(presets["esc50"], **base)


def _batches(loader, epoch):
    loader.set_epoch(epoch)
    return [(np.asarray(x.cpu()) if isinstance(x, torch.Tensor) else x,
             np.asarray(y.cpu()) if isinstance(y, torch.Tensor) else y, ids)
            for x, y, ids in loader]


@pytest.mark.parametrize("waveform", [False, True])
def test_cached_loader_matches_streaming(corpus, waveform):
    """Two epochs: the same arrays, labels and ids in the same order, the
    cached ones tensors on the cache's device."""
    manifest, label_csv = corpus
    dc.clear_cache()
    ds = AudiosetDataset(manifest, _cfg(), label_csv, train=True,
                         return_waveform=waveform)
    kw = dict(batch_size=4, num_workers=2, drop_last=True)
    streaming = DataLoader(
        ds, sampler=EpochShardSampler(len(ds), shuffle=True, seed=3), **kw)
    cached = dc.DeviceCachedLoader(
        ds, sampler=EpochShardSampler(len(ds), shuffle=True, seed=3),
        device="cpu", **kw)
    for epoch in (0, 1):
        cached.set_epoch(epoch)
        first = next(iter(cached))
        assert isinstance(first[0], torch.Tensor) and first[0].device.type == "cpu"
        got_s, got_c = _batches(streaming, epoch), _batches(cached, epoch)
        assert len(got_s) == len(got_c) == len(cached) > 0
        for (xs, ys, ids_s), (xc, yc, ids_c) in zip(got_s, got_c):
            np.testing.assert_array_equal(xs, xc)
            np.testing.assert_array_equal(ys, yc)
            assert ids_s == ids_c


@pytest.mark.parametrize("waveform", [False, True])
def test_cached_batches_equal_the_jax_cache(corpus, waveform):
    """The port's cached batches against ``tpat_tpu.data.device_cache``'s
    on the same corpus and sampler, two epochs (a ragged last batch kept):
    bit for bit, ids equal."""
    from tpat_tpu.config import DATASET_PRESETS as JAX_PRESETS
    from tpat_tpu.data import datasets as jdatasets
    from tpat_tpu.data import device_cache as jdc
    from tpat_tpu.data.sampler import EpochShardSampler as JaxSampler

    manifest, label_csv = corpus
    dc.clear_cache()
    jdc.clear_cache()
    ds = AudiosetDataset(manifest, _cfg(), label_csv, train=True,
                         return_waveform=waveform)
    jds = jdatasets.AudiosetDataset(manifest, _cfg(JAX_PRESETS), label_csv,
                                    train=True, return_waveform=waveform)
    cached = dc.DeviceCachedLoader(
        ds, 4, sampler=EpochShardSampler(len(ds), shuffle=True, seed=5),
        device="cpu")
    jcached = jdc.DeviceCachedLoader(
        jds, 4, sampler=JaxSampler(len(jds), shuffle=True, seed=5))
    for epoch in (0, 1):
        got, want = _batches(cached, epoch), _batches(jcached, epoch)
        assert [len(b[2]) for b in got] == [4, 4, 2]
        for (x, y, ids), (jx, jy, jids) in zip(got, want):
            np.testing.assert_array_equal(x, np.asarray(jx))
            np.testing.assert_array_equal(y, np.asarray(jy))
            assert ids == jids


def test_registry_shares_one_device_copy(corpus):
    """Datasets of one signature (a train and an eval set over one
    manifest) share one device copy; ``clear_cache`` drops it."""
    manifest, label_csv = corpus
    dc.clear_cache()
    ds1 = AudiosetDataset(manifest, _cfg(), label_csv, train=True)
    ds2 = AudiosetDataset(manifest, _cfg(), label_csv, train=False)
    l1 = dc.DeviceCachedLoader(ds1, batch_size=4, device="cpu")
    l2 = dc.DeviceCachedLoader(ds2, batch_size=4, device="cpu")
    next(iter(l1)), next(iter(l2))
    assert l1._store[0] is l2._store[0]
    assert len(dc._REGISTRY) == 1
    dc.clear_cache()
    assert len(dc._REGISTRY) == 0


def test_nondeterminism_refusal(corpus):
    manifest, label_csv = corpus
    noisy = AudiosetDataset(manifest, _cfg(freqm=4, timem=4), label_csv,
                            train=True)
    assert "SpecAug" in dc.nondeterminism_reason(noisy)
    with pytest.raises(ValueError, match="SpecAug"):
        dc.DeviceCachedLoader(noisy, batch_size=4, device="cpu")
    assert dc.maybe_device_cached(noisy, 4, mode="auto", device="cpu") is None
    with pytest.raises(ValueError, match="SpecAug"):
        dc.maybe_device_cached(noisy, 4, mode="true", device="cpu")
    # the same knobs in waveform mode: SpecAug runs on the device
    wf = AudiosetDataset(manifest, _cfg(freqm=4, timem=4), label_csv,
                         train=True, return_waveform=True)
    assert dc.nondeterminism_reason(wf) is None
    mix = AudiosetDataset(manifest, _cfg(mixup=0.5), label_csv, train=True,
                          return_waveform=True)
    assert "mixup" in dc.nondeterminism_reason(mix)
    small = AudiosetDataset(manifest, _cfg(), label_csv, train=True)
    assert dc.maybe_device_cached(small, 4, mode="auto", max_bytes=1,
                                  device="cpu") is None
    assert dc.maybe_device_cached(small, 4, mode="false", device="cpu") is None
    with pytest.raises(ValueError, match="budget"):
        dc.maybe_device_cached(small, 4, mode="true", max_bytes=1,
                               device="cpu")


@pytest.mark.parametrize("kw,train,waveform", [
    ({}, True, False),
    (dict(freqm=4), True, False),
    (dict(freqm=4), True, True),
    (dict(roll_mag_aug=True), True, True),
    (dict(roll_mag_aug=True), False, False),
    (dict(mixup=0.5), True, True),
    (dict(mixup=0.5), False, True),
    (dict(use_noise=True), True, False),
    (dict(use_noise=True), True, True),
])
def test_auto_caches_what_jax_auto_caches(corpus, kw, train, waveform):
    """'auto' declines or caches a dataset exactly as the JAX package's
    'auto' does, with the same reason."""
    from tpat_tpu.config import DATASET_PRESETS as JAX_PRESETS
    from tpat_tpu.data import datasets as jdatasets
    from tpat_tpu.data import device_cache as jdc

    manifest, label_csv = corpus
    roll = kw.pop("roll_mag_aug", False)
    ds = AudiosetDataset(manifest, _cfg(**kw), label_csv, train=train,
                         roll_mag_aug=roll, return_waveform=waveform)
    jds = jdatasets.AudiosetDataset(manifest, _cfg(JAX_PRESETS, **kw),
                                    label_csv, train=train, roll_mag_aug=roll,
                                    return_waveform=waveform)
    assert dc.nondeterminism_reason(ds) == jdc.nondeterminism_reason(jds)
    got = dc.maybe_device_cached(ds, 4, mode="auto", device="cpu")
    want = jdc.maybe_device_cached(jds, 4, mode="auto")
    assert (got is None) == (want is None)


def test_cli_parity_cached_vs_streaming(corpus, tmp_path, monkeypatch):
    """The port's finetune CLI with --device_dataset true (both sets on
    the device) reproduces the streaming run: per-epoch losses within rel
    1e-6, equal accuracies and best score."""
    from tpat_tpu_torch.cli.finetune import get_args_parser, main

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    manifest, label_csv = corpus
    threads = torch.get_num_threads()
    torch.set_num_threads(1)

    def run(tag, device_dataset):
        out = tmp_path / tag
        main(get_args_parser().parse_args([
            "--dataset", "esc50", "--model", "audiomae_vit_tiny",
            "--target_length", "128",
            "--data_train", manifest, "--data_eval", manifest,
            "--label_csv", label_csv,
            "--nb_classes", "4", "--batch_size", "8", "--epochs", "2",
            "--blr", "2e-3", "--warmup_epochs", "1",
            "--base_keep_rate", "0.6", "--drop_loc", "(1, 3)",
            "--shrink_start_epoch", "1", "--shrink_epochs", "1",
            "--freqm", "0", "--timem", "0", "--num_workers", "2",
            "--device_dataset", device_dataset,
            "--output_dir", str(out),
            "--result_path", str(out / "result.txt"),
        ]), device="cpu")
        logs = [json.loads(line) for line in open(out / "log.txt")]
        return ([e["train_loss"] for e in logs], [e["test_acc1"] for e in logs],
                float(open(out / "result.txt").read()))

    try:
        dc.clear_cache()
        loss_s, acc_s, best_s = run("streaming", "false")
        assert not dc._REGISTRY
        loss_c, acc_c, best_c = run("cached", "true")
        assert len(dc._REGISTRY) == 1  # the train and eval sets: one copy
    finally:
        torch.set_num_threads(threads)
        dc.clear_cache()
    assert loss_s == pytest.approx(loss_c, rel=1e-6)
    assert acc_s == acc_c
    assert best_s == best_c
