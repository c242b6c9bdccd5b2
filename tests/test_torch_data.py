"""The port's host data pipeline (tpat_tpu_torch.ops.fbank, data/*,
cli/get_norm_stats.py, cli/create_voxceleb1_csv.py) against the JAX
package's, on the CPU, from the same seeded WAVs and generators.

Everything here is numpy on the host in both packages, so the port must give
the same bits: fbanks, items, sampler indices and batches are compared with
``np.testing.assert_array_equal`` (tolerance 0)."""

import json
import math
import threading
import time
import wave

import numpy as np
import pytest

from tpat_tpu import config as jcfg
from tpat_tpu.cli import create_voxceleb1_csv as jvox_csv
from tpat_tpu.cli import get_norm_stats as jnorm
from tpat_tpu.data import augment as jaug
from tpat_tpu.data import datasets as jds
from tpat_tpu.data import loader as jloader
from tpat_tpu.data import native as jnative
from tpat_tpu.data import sampler as jsampler
from tpat_tpu.data import wav as jwav
from tpat_tpu.ops import fbank as jfb
from tpat_tpu_torch import config as cfg_lib
from tpat_tpu_torch.cli import create_voxceleb1_csv as vox_csv
from tpat_tpu_torch.cli import get_norm_stats as norm
from tpat_tpu_torch.data import augment as aug
from tpat_tpu_torch.data import datasets as ds_lib
from tpat_tpu_torch.data import loader as loader_lib
from tpat_tpu_torch.data import native
from tpat_tpu_torch.data import sampler as sampler_lib
from tpat_tpu_torch.data import wav as wav_lib
from tpat_tpu_torch.ops import fbank as fb

SR = 16000


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Six tones with noise, of 1 s, 0.7 s (fewer frames than the target:
    padded) and 1.6 s (cropped), an 8 kHz clip, a manifest with a
    two-label item, and a label CSV."""
    root = tmp_path_factory.mktemp("torch_data")
    rng = np.random.default_rng(0)
    entries = []
    for i, (secs, sr) in enumerate([(1.0, SR), (0.7, SR), (1.6, SR),
                                    (1.0, 8000), (1.0, SR), (0.9, SR)]):
        t = np.arange(int(secs * sr)) / sr
        w = 0.4 * np.sin(2 * math.pi * (300 + 150 * i) * t)
        w += 0.02 * rng.normal(size=t.size)
        path = str(root / f"c{i}.wav")
        wav_lib.save_wav(path, w.astype(np.float32), sr)
        labels = f"/m/{i % 4:02d}" + (",/m/03" if i == 4 else "")
        entries.append({"wav": path, "labels": labels})
    manifest = str(root / "data.json")
    with open(manifest, "w") as f:
        json.dump({"data": entries}, f)
    label_csv = str(root / "labels.csv")
    with open(label_csv, "w") as f:
        f.write("index,mid,display_name\n")
        for c in range(4):
            f.write(f'{c},/m/{c:02d},"tone {c}"\n')
    return manifest, label_csv, root


def _data_cfg(cfg_mod, **kw):
    base = dict(name="t", num_classes=4, target_length=96, norm_mean=-6.0,
                norm_std=5.0, multilabel=False, use_noise=False,
                loss_type="ce")
    base.update(kw)
    return cfg_mod.DataConfig(**base)


# -- fbank -------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {}, {"window_type": "povey"}, {"num_mel_bins": 64},
    {"sample_rate": 8000, "low_freq": 40.0}, {"window_type": "rectangular"},
])
def test_fbank_and_mel_banks_match_jax(kw):
    """fbank_numpy and mel_banks bit for bit."""
    rng = np.random.default_rng(1)
    w = (0.2 * rng.normal(size=12345)).astype(np.float32)
    mine, theirs = fb.FbankConfig(**kw), jfb.FbankConfig(**kw)
    np.testing.assert_array_equal(fb.mel_banks(mine), jfb.mel_banks(theirs))
    got = fb.fbank_numpy(w, mine)
    assert got.shape == (mine.num_frames(w.size), mine.num_mel_bins)
    np.testing.assert_array_equal(got, jfb.fbank_numpy(w, theirs))


@pytest.mark.parametrize("n,target,left", [(50, 64, 0), (50, 64, 9),
                                           (80, 64, 0), (64, 64, 0)])
def test_pad_or_crop_and_normalize_match_jax(n, target, left):
    x = np.random.default_rng(n).normal(size=(n, 16)).astype(np.float32)
    got = fb.pad_or_crop(x, target, pad_left=left)
    assert got.shape == (target, 16)
    np.testing.assert_array_equal(got, jfb.pad_or_crop(x, target, pad_left=left))
    np.testing.assert_array_equal(fb.normalize(got, -6.6268077, 5.358466),
                                  jfb.normalize(got, -6.6268077, 5.358466))


# -- wav ---------------------------------------------------------------------


def _write_pcm(path, width, channels, n, seed):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, size=n * channels * width, dtype=np.uint8)
    with wave.open(path, "wb") as f:
        f.setnchannels(channels)
        f.setsampwidth(width)
        f.setframerate(SR)
        f.writeframes(raw.tobytes())


@pytest.mark.parametrize("width,channels", [(1, 1), (2, 1), (2, 2), (3, 1), (4, 2)])
def test_wav_decode_matches_jax(tmp_path, width, channels):
    path = str(tmp_path / "x.wav")
    _write_pcm(path, width, channels, 1000, width * 10 + channels)
    got, sr = wav_lib.load_wav_python(path)
    want, want_sr = jwav.load_wav_python(path)
    assert sr == want_sr == SR and got.shape == (channels, 1000)
    np.testing.assert_array_equal(got, want)


def test_save_wav_matches_jax(tmp_path):
    w = np.clip(np.random.default_rng(0).normal(size=(2, 3000)) * 0.4, -1.2, 1.2)
    wav_lib.save_wav(str(tmp_path / "a.wav"), w.astype(np.float32), SR)
    jwav.save_wav(str(tmp_path / "b.wav"), w.astype(np.float32), SR)
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()


def test_native_frontend_matches_jax(corpus):
    """The native decoder and fbank through the port's binding equal the
    JAX package's binding of the same library; skips where it is not built
    (``make -C native``), as tests/test_native_frontend.py does."""
    if not (native.available() and jnative.available()):
        pytest.skip("native/libtpat_audio.so is not built (make -C native)")
    path = json.load(open(corpus[0]))["data"][0]["wav"]
    w, sr = native.load_wav(path)
    want_w, want_sr = jnative.load_wav(path)
    assert sr == want_sr
    np.testing.assert_array_equal(w, want_w)
    np.testing.assert_array_equal(native.fbank(w[0], sr, 128),
                                  jnative.fbank(want_w[0], sr, 128))


# -- augmentations, samplers -------------------------------------------------


def test_augmentations_match_jax():
    """The same generator state gives the same bits and leaves the
    generator in the same state (so later draws agree too)."""
    x = np.random.default_rng(0).normal(size=(1, 7000)).astype(np.float32)
    x2 = np.random.default_rng(1).normal(size=(1, 5000)).astype(np.float32)
    mel = np.random.default_rng(2).normal(size=(96, 128)).astype(np.float32)
    for seed in range(4):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        np.testing.assert_array_equal(aug.roll_mag_aug(x, a), jaug.roll_mag_aug(x, b))
        for w1, w2 in ((x, x2), (x2, x)):
            (m1, l1), (m2, l2) = (aug.mixup_waveforms(w1, w2, a),
                                  jaug.mixup_waveforms(w1, w2, b))
            assert l1 == l2
            np.testing.assert_array_equal(m1, m2)
        for fm, tm in ((24, 96), (48, 192), (0, 8), (300, 0)):
            np.testing.assert_array_equal(aug.spec_masking(mel, fm, tm, a),
                                          jaug.spec_masking(mel, fm, tm, b))
        np.testing.assert_array_equal(aug.noise_aug(mel, a), jaug.noise_aug(mel, b))
        assert a.random() == b.random()


@pytest.mark.parametrize("n,world,rank,shuffle", [
    (10, 1, 0, True), (10, 1, 0, False), (11, 3, 2, True), (7, 4, 1, True),
])
def test_samplers_match_jax(n, world, rank, shuffle):
    mine = sampler_lib.EpochShardSampler(n, shuffle=shuffle, seed=5,
                                         world=world, rank=rank)
    theirs = jsampler.EpochShardSampler(n, shuffle=shuffle, seed=5,
                                        world=world, rank=rank)
    for epoch in range(3):
        mine.set_epoch(epoch)
        theirs.set_epoch(epoch)
        assert list(mine) == list(theirs) and len(mine) == len(theirs)
    assert sampler_lib.eval_shard(n, world, rank) == jsampler.eval_shard(n, world, rank)
    weights = np.random.default_rng(n).random(n) + 0.1
    mine = sampler_lib.WeightedShardSampler(weights, seed=3, world=world, rank=rank)
    theirs = jsampler.WeightedShardSampler(weights, seed=3, world=world, rank=rank)
    for epoch in range(3):
        mine.set_epoch(epoch)
        theirs.set_epoch(epoch)
        assert list(mine) == list(theirs)


# -- datasets ----------------------------------------------------------------


@pytest.mark.parametrize("mode", ["eval", "train_specaug_rollmag",
                                  "train_mixup_noise", "skip_norm"])
def test_audioset_items_match_jax(corpus, mode):
    """Every item of two epochs bit-equal to the JAX AudiosetDataset's: x,
    the (soft) labels and the name (both packages pick the same fbank
    backend by the same rule)."""
    manifest, label_csv, _ = corpus
    kw = {"eval": {}, "train_specaug_rollmag": dict(freqm=24, timem=40),
          "train_mixup_noise": dict(freqm=8, timem=8, mixup=0.6,
                                    use_noise=True, multilabel=True),
          "skip_norm": {}}[mode]
    train = mode.startswith("train")
    args = dict(train=train, roll_mag_aug=train, seed=7,
                skip_norm=mode == "skip_norm")
    mine = ds_lib.AudiosetDataset(manifest, _data_cfg(cfg_lib, **kw), label_csv, **args)
    theirs = jds.AudiosetDataset(manifest, _data_cfg(jcfg, **kw), label_csv, **args)
    assert len(mine) == len(theirs) == 6 and mine.label_num == theirs.label_num
    for epoch in (0, 1):
        mine.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for i in range(len(mine)):
            (x, y, name), (wx, wy, wname) = mine[i], theirs[i]
            assert x.shape == (1, 96, 128) and x.dtype == np.float32
            np.testing.assert_array_equal(x, wx)
            np.testing.assert_array_equal(y, wy)
            assert name == wname


def test_label_maps_match_jax(corpus):
    _, label_csv, _ = corpus
    assert ds_lib.make_index_dict(label_csv) == jds.make_index_dict(label_csv)
    assert ds_lib.make_name_dict(label_csv) == jds.make_name_dict(label_csv)


def test_waveform_mode_refused(corpus):
    """The waveform mode (refused until the device frontend was ported) now
    runs: over two epochs of a train set with mixup, roll-magnitude and the
    noise flag, and of the eval set, every item's waveform (its NaN tail
    included), soft labels and name bit-equal to the JAX dataset's."""
    manifest, label_csv, _ = corpus
    kw = dict(freqm=8, timem=8, mixup=0.6, use_noise=True)
    for train in (True, False):
        args = dict(train=train, roll_mag_aug=train, seed=5,
                    return_waveform=True)
        mine = ds_lib.AudiosetDataset(manifest, _data_cfg(cfg_lib, **kw),
                                      label_csv, **args)
        theirs = jds.AudiosetDataset(manifest, _data_cfg(jcfg, **kw),
                                     label_csv, **args)
        assert mine.num_samples == theirs.num_samples == 95 * 160 + 400
        for epoch in (0, 1):
            mine.set_epoch(epoch)
            theirs.set_epoch(epoch)
            for i in range(len(mine)):
                (x, y, name), (wx, wy, wname) = mine[i], theirs[i]
                assert x.shape == (mine.num_samples,) and x.dtype == np.float32
                np.testing.assert_array_equal(x, wx)
                np.testing.assert_array_equal(y, wy)
                assert name == wname
    assert np.isnan(mine[1][0]).any()  # the 0.7-s clip: a NaN tail


@pytest.fixture(scope="module")
def voxceleb_tree(tmp_path_factory):
    """root/wav/<speaker>/clipA/<utt>.wav with non-contiguous speaker ids,
    clips shorter than the target (lr_pad draws) and iden_split.txt."""
    root = tmp_path_factory.mktemp("torch_vox")
    rng = np.random.default_rng(0)
    lines = []
    for s, spk in enumerate(["id10001", "id10007", "id10500"]):
        for u in range(3):
            rel = f"{spk}/clipA/{u:05d}.wav"
            (root / "wav" / spk / "clipA").mkdir(parents=True, exist_ok=True)
            n = int(SR * (0.6 + 0.2 * u))
            w = 0.3 * np.sin(2 * math.pi * (200 + 100 * s) * np.arange(n) / SR)
            w += 0.01 * rng.normal(size=n)
            wav_lib.save_wav(str(root / "wav" / rel), w.astype(np.float32), SR)
            lines.append(f"{1 if u < 2 else 3} {rel}")
    (root / "iden_split.txt").write_text("\n".join(lines) + "\n")
    return str(root)


@pytest.mark.parametrize("subset", ["train", "test"])
def test_voxceleb_items_match_jax(voxceleb_tree, subset):
    kw = dict(target_length=128, use_noise=True, freqm=16, timem=24,
              roll_mag_aug=True, num_classes=3)
    mine = ds_lib.VoxCeleb1Dataset(voxceleb_tree, subset, _data_cfg(cfg_lib, **kw),
                                   lr_pad=True, seed=3)
    theirs = jds.VoxCeleb1Dataset(voxceleb_tree, subset, _data_cfg(jcfg, **kw),
                                  lr_pad=True, seed=3)
    assert mine.id2class == theirs.id2class
    assert mine.files == theirs.files and len(mine) == (6 if subset == "train" else 3)
    for epoch in (0, 2):
        mine.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for i in range(len(mine)):
            (x, y, rel), (wx, wy, wrel) = mine[i], theirs[i]
            assert x.shape == (1, 128, 128)
            np.testing.assert_array_equal(x, wx)
            np.testing.assert_array_equal(y, wy)
            assert rel == wrel


# -- loader ------------------------------------------------------------------


@pytest.mark.parametrize("drop_last,workers", [(True, 2), (False, 3)])
def test_loader_batches_match_jax(corpus, drop_last, workers):
    """Batch count, order and contents of a shuffled train epoch."""
    manifest, label_csv, _ = corpus
    kw = dict(freqm=8, timem=8)
    mine_ds = ds_lib.AudiosetDataset(manifest, _data_cfg(cfg_lib, **kw), label_csv,
                                     train=True, roll_mag_aug=True, seed=1)
    theirs_ds = jds.AudiosetDataset(manifest, _data_cfg(jcfg, **kw), label_csv,
                                    train=True, roll_mag_aug=True, seed=1)
    mine = loader_lib.DataLoader(
        mine_ds, 4, sampler=sampler_lib.EpochShardSampler(6, seed=1),
        num_workers=workers, drop_last=drop_last)
    theirs = jloader.DataLoader(
        theirs_ds, 4, sampler=jsampler.EpochShardSampler(6, seed=1),
        num_workers=workers, drop_last=drop_last)
    for epoch in (0, 1):
        mine.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got, want = list(mine), list(theirs)
        assert len(got) == len(want) == len(mine) == (1 if drop_last else 2)
        for (x, y, ids), (wx, wy, wids) in zip(got, want):
            np.testing.assert_array_equal(x, wx)
            np.testing.assert_array_equal(y, wy)
            assert ids == wids


class _Items:
    def __init__(self, n, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise RuntimeError("bad wav")
        return np.full((1, 4, 4), i, np.float32), np.zeros(2, np.float32), str(i)


def test_loader_propagates_worker_exception():
    """A dataset failure raises in the consumer instead of hanging it."""
    dl = loader_lib.DataLoader(_Items(8, fail_at=5), batch_size=2, num_workers=2)
    with pytest.raises(RuntimeError, match="bad wav"):
        for _ in dl:
            pass


def test_loader_early_exit_does_not_leak_threads():
    """An abandoned iterator stops its producer thread."""
    before = threading.active_count()
    for _ in range(5):
        it = iter(loader_lib.DataLoader(_Items(64), batch_size=2,
                                        num_workers=2, prefetch=1))
        next(it)
        it.close()
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_prefetch_iter_orders_propagates_and_stops():
    assert list(loader_lib.prefetch_iter(iter(range(7)), prefetch=2)) == list(range(7))

    def boom():
        yield 1
        raise RuntimeError("producer died")

    it = loader_lib.prefetch_iter(boom())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="producer died"):
        next(it)
    before = threading.active_count()
    gen = loader_lib.prefetch_iter(iter(range(10_000)), prefetch=1)
    assert next(gen) == 0
    gen.close()
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


# -- small CLIs --------------------------------------------------------------


def test_compute_norm_stats_matches_jax(corpus, capsys):
    """compute_norm_stats on skip_norm datasets and the CLI's printout, equal
    to the JAX ones (the same batches of the same fbanks)."""
    manifest, label_csv, _ = corpus
    mine = ds_lib.AudiosetDataset(manifest, _data_cfg(cfg_lib), label_csv,
                                  train=False, skip_norm=True)
    theirs = jds.AudiosetDataset(manifest, _data_cfg(jcfg), label_csv,
                                 train=False, skip_norm=True)
    for b in (2, 4, 256):
        assert norm.compute_norm_stats(mine, b) == jnorm.compute_norm_stats(theirs, b)
    with pytest.raises(ValueError, match="skip_norm"):
        norm.compute_norm_stats(ds_lib.AudiosetDataset(
            manifest, _data_cfg(cfg_lib), label_csv, train=False))
    argv = ["--manifest", manifest, "--label_csv", label_csv,
            "--target_length", "96", "--batch_size", "4"]
    assert norm.main(argv) == jnorm.main(argv)


def test_create_voxceleb1_csv_matches_jax(tmp_path):
    vox_csv.main(["--out", str(tmp_path / "a.csv")])
    jvox_csv.main(["--out", str(tmp_path / "b.csv")])
    text = (tmp_path / "a.csv").read_text()
    assert text == (tmp_path / "b.csv").read_text()
    assert len(text.splitlines()) == 1253


def test_native_switch_respects_disable(monkeypatch):
    """TPAT_DISABLE_NATIVE=1 keeps the library unloaded."""
    monkeypatch.setenv("TPAT_DISABLE_NATIVE", "1")
    native._load.cache_clear()
    try:
        assert not native.available()
        with pytest.raises(RuntimeError, match="not loaded"):
            native.fbank(np.zeros(800, np.float32), SR)
    finally:
        native._load.cache_clear()
