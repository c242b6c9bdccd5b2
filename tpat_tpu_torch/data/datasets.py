"""Host-side datasets (copy of ``tpat_tpu/data/datasets.py``).

- ``AudiosetDataset``: a JSON manifest ``{"data": [{"wav": path, "labels":
  "/m/x,/m/y"}]}`` and a label CSV ``(index, mid, display_name)``; per item:
  wav -> DC removal -> [roll-mag] -> [waveform mixup with soft labels] ->
  Kaldi fbank -> pad with the minimum or crop -> [SpecAug] ->
  (x - mean) / (2 std) -> [noise].
- ``VoxCeleb1Dataset``: speaker identification over ``iden_split.txt``,
  one-hot speaker labels, an optional random left/right split of the
  padding (lr_pad).

Each item draws from a generator seeded by (seed, epoch, index), so the
same manifest, seed and epoch give the same items as the JAX package's.
Decoding and the fbank run on the host.  In the waveform mode
(``return_waveform``, the ``--device_frontend`` path) an item is the
centred (and roll-magnitude or mixup augmented) clip at ``num_samples``,
and the fbank, SpecAug, normalisation and noise run on the device
(``ops/frontend.py``).  A short clip gets a NaN tail; VoxCeleb's random
left pad becomes a NaN head of ``pad_left`` x 160 samples.  The draws come
from the same generator stream as the mel path's, so a clip's draws equal
the JAX package's.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from tpat_tpu_torch.config import DataConfig
from tpat_tpu_torch.data import augment, native
from tpat_tpu_torch.data.wav import load_wav
from tpat_tpu_torch.ops import fbank as fb


def _host_fbank(wav: np.ndarray, sr: int, num_mel_bins: int) -> np.ndarray:
    """Kaldi fbank for the host pipeline, its backend chosen by core count
    (``tpat_tpu/data/datasets.py:33-59``).

    The numpy path is faster on one thread but holds the GIL through its
    framing, so the threaded loader cannot spread it over cores; the native
    kernel releases the GIL for the whole computation.  So with more than
    one core (affinity-aware) and the native library loaded, the native
    kernel runs; otherwise numpy.  Both implement the same Kaldi spec and
    agree to about 1e-4; TPAT_DISABLE_NATIVE=1 forces numpy."""
    try:
        n_cores = len(os.sched_getaffinity(0))
    except AttributeError:  # not Linux
        n_cores = os.cpu_count() or 1
    if native.available() and n_cores > 1:
        return native.fbank(wav, sr, num_mel_bins)
    return fb.fbank_numpy(
        wav, fb.FbankConfig(sample_rate=sr, num_mel_bins=num_mel_bins)
    )


def _default_num_samples(data_cfg: DataConfig) -> int:
    """The samples that ``target_length`` snip-edges frames cover at 16 kHz:
    (target_length - 1) * 160 + 400."""
    return (data_cfg.target_length - 1) * 160 + 400


def make_index_dict(label_csv: str) -> Dict[str, int]:
    """mid -> class index."""
    out = {}
    with open(label_csv) as f:
        for row in csv.DictReader(f):
            out[row["mid"]] = int(row["index"])
    return out


def make_name_dict(label_csv: str) -> Dict[int, str]:
    """class index -> display name."""
    out = {}
    with open(label_csv) as f:
        for row in csv.DictReader(f):
            out[int(row["index"])] = row["display_name"]
    return out


class AudiosetDataset:
    def __init__(
        self,
        manifest_json: str,
        data_cfg: DataConfig,
        label_csv: str,
        train: bool = True,
        roll_mag_aug: bool = False,
        seed: int = 0,
        return_waveform: bool = False,
        num_samples: Optional[int] = None,
        skip_norm: bool = False,
    ):
        with open(manifest_json) as f:
            self.data: List[dict] = json.load(f)["data"]
        # the dataset's identity for the device cache's registry
        # (data/device_cache.py): the same manifest and label map give the
        # same items
        self.source = (os.path.abspath(manifest_json),
                       os.path.abspath(label_csv))
        self.cfg = data_cfg
        self.return_waveform = return_waveform
        if return_waveform and num_samples is None:
            num_samples = _default_num_samples(data_cfg)
        self.num_samples = num_samples
        self.train = train
        self.index_dict = make_index_dict(label_csv)
        self.label_num = len(self.index_dict)
        self.roll_mag = roll_mag_aug and train
        # mutable augmentation knobs: cli/finetune.py zeroes freqm and timem when
        # the shrink starts
        self.freqm = data_cfg.freqm if train else 0
        self.timem = data_cfg.timem if train else 0
        self.mixup = data_cfg.mixup if train else 0.0
        self.noise = data_cfg.use_noise and train
        # skip_norm: emit un-normalised fbanks, so that (mean, std) of a new
        # dataset can be computed (cli/get_norm_stats.py)
        self.skip_norm = skip_norm
        self.seed = seed
        self.epoch = 0  # set by the loader each epoch

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return len(self.data)

    def _load_centered(self, path: str, rng) -> Tuple[np.ndarray, int]:
        wav, sr = load_wav(path)
        wav = wav - wav.mean()
        if self.roll_mag:
            wav = augment.roll_mag_aug(wav, rng)
        return wav, sr

    def _wav2fbank(self, path: str, rng, path2: Optional[str] = None):
        # mixup takes file 1's sample rate for the fbank, as the reference
        w1, sr = self._load_centered(path, rng)
        lam = 0.0
        if path2 is not None:
            w2, _ = self._load_centered(path2, rng)
            w1, lam = augment.mixup_waveforms(w1, w2, rng)
        mel = _host_fbank(w1[0], sr, self.cfg.num_mel_bins)
        mel = fb.pad_or_crop(mel, self.cfg.target_length)
        return mel, lam

    def _fixed_waveform(self, path: str, rng, path2: Optional[str] = None):
        """The clip (mixed with ``path2``'s) at ``num_samples``: cropped, or
        padded with a NaN tail that the device frontend reads as the true
        length.  Returns (waveform, lam)."""
        w1, _ = self._load_centered(path, rng)
        lam = 0.0
        if path2 is not None:
            w2, _ = self._load_centered(path2, rng)
            w1, lam = augment.mixup_waveforms(w1, w2, rng)
        wav = w1.reshape(-1)
        n = self.num_samples
        if len(wav) < n:
            wav = np.pad(wav, (0, n - len(wav)), constant_values=np.nan)
        else:
            wav = wav[:n]
        return wav.astype(np.float32), lam

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray, str]:
        # a generator local to this call: the threaded loader runs
        # __getitem__ concurrently on one dataset object
        rng = np.random.default_rng((self.seed, self.epoch, index))
        datum = self.data[index]
        labels = np.zeros(self.label_num, dtype=np.float32)
        do_mixup = rng.random() < self.mixup
        partner = (
            self.data[int(rng.integers(len(self.data)))]
            if do_mixup
            else None
        )
        if self.return_waveform:
            wav, lam = self._fixed_waveform(
                datum["wav"], rng, partner["wav"] if partner else None
            )
            if partner is not None:
                for s in datum["labels"].split(","):
                    labels[self.index_dict[s.strip()]] += lam
                for s in partner["labels"].split(","):
                    labels[self.index_dict[s.strip()]] += 1.0 - lam
            else:
                for s in datum["labels"].split(","):
                    labels[self.index_dict[s.strip()]] = 1.0
            return wav, labels, datum["wav"]
        if do_mixup:
            mel, lam = self._wav2fbank(datum["wav"], rng, partner["wav"])
            for s in datum["labels"].split(","):
                labels[self.index_dict[s.strip()]] += lam
            for s in partner["labels"].split(","):
                labels[self.index_dict[s.strip()]] += 1.0 - lam
        else:
            mel, _ = self._wav2fbank(datum["wav"], rng)
            for s in datum["labels"].split(","):
                labels[self.index_dict[s.strip()]] = 1.0

        if self.freqm or self.timem:
            mel = augment.spec_masking(mel, self.freqm, self.timem, rng)
        if not self.skip_norm:
            mel = fb.normalize(mel, self.cfg.norm_mean, self.cfg.norm_std)
        if self.noise:
            mel = augment.noise_aug(mel, rng)
        return mel[None].astype(np.float32), labels, datum["wav"]


class VoxCeleb1Dataset:
    """Speaker identification over a VoxCeleb1 tree,
    ``root/wav/id10001/<clip>/<utt>.wav`` with ``iden_split.txt`` (1 train,
    2 dev, 3 test); 'train' reads split 1 and 'test' split 3.  The speaker
    index comes from a sorted scan of ``root/wav``, so it stays right on
    subset or non-contiguous speaker trees."""

    SPLIT = {"train": 1, "dev": 2, "test": 3}

    def __init__(
        self,
        root: str,
        subset: str,
        data_cfg: DataConfig,
        lr_pad: bool = False,
        seed: int = 0,
        skip_norm: bool = False,
        return_waveform: bool = False,
        num_samples: Optional[int] = None,
    ):
        if subset not in ("train", "test"):
            raise ValueError(f"subset must be 'train' or 'test', got {subset!r}")
        self.root = root
        self.source = (os.path.abspath(root), subset)  # see AudiosetDataset
        self.cfg = data_cfg
        self.return_waveform = return_waveform
        if return_waveform and num_samples is None:
            num_samples = _default_num_samples(data_cfg)
        self.num_samples = num_samples
        self.train = subset == "train"
        self.lr_pad = lr_pad and self.train
        self.freqm = data_cfg.freqm if self.train else 0
        self.timem = data_cfg.timem if self.train else 0
        self.noise = data_cfg.use_noise and self.train
        self.roll_mag = data_cfg.roll_mag_aug and self.train
        self.skip_norm = skip_norm
        self.seed = seed
        self.epoch = 0

        want = self.SPLIT[subset]
        self.files: List[str] = []
        with open(os.path.join(root, "iden_split.txt")) as f:
            for line in f:
                part, rel = line.split()
                if int(part) == want:
                    self.files.append(rel)
        base = os.path.join(root, "wav")
        speakers = sorted(d for d in os.listdir(base) if d.startswith("id"))
        self.id2class: Dict[str, int] = {s: i for i, s in enumerate(speakers)}
        self.total_classes = len(speakers)

    def __len__(self):
        return len(self.files)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __getitem__(self, index: int):
        # a generator local to this call (see AudiosetDataset.__getitem__)
        rng = np.random.default_rng((self.seed, self.epoch, index))
        rel = self.files[index]
        label = np.zeros(self.total_classes, dtype=np.float32)
        label[self.id2class[rel.split("/")[0]]] = 1.0

        wav, sr = load_wav(os.path.join(self.root, "wav", rel))
        wav = wav - wav.mean()
        if self.roll_mag:
            wav = augment.roll_mag_aug(wav, rng)
        if self.return_waveform:
            return self._fixed_waveform(wav, sr, rng), label, rel
        mel = _host_fbank(wav[0], sr, self.cfg.num_mel_bins)
        pad_left = 0
        deficit = self.cfg.target_length - mel.shape[0]
        if self.lr_pad and deficit > 0:
            pad_left = int(rng.integers(0, deficit + 1))
        mel = fb.pad_or_crop(mel, self.cfg.target_length, pad_left=pad_left)
        if self.freqm or self.timem:
            mel = augment.spec_masking(mel, self.freqm, self.timem, rng)
        if not self.skip_norm:
            mel = fb.normalize(mel, self.cfg.norm_mean, self.cfg.norm_std)
        if self.noise:
            mel = augment.noise_aug(mel, rng)
        return mel[None].astype(np.float32), label, rel

    def _fixed_waveform(self, wav: np.ndarray, sr: int, rng) -> np.ndarray:
        """The clip at ``num_samples``: cropped, or after a NaN head of
        ``pad_left`` x 160 samples (the mel path's lr_pad draw, in frames)
        and before a NaN tail."""
        if sr != 16000:
            raise ValueError(f"the waveform mode assumes 16 kHz, got {sr}")
        flat = wav.reshape(-1)
        n, shift, window = self.num_samples, 160, 400
        out = np.full(n, np.nan, dtype=np.float32)
        if len(flat) >= n:
            out[:] = flat[:n]
            return out
        real_frames = 1 + (len(flat) - window) // shift if len(flat) >= window else 0
        deficit = self.cfg.target_length - real_frames
        pad_left = (int(rng.integers(0, deficit + 1))
                    if self.lr_pad and deficit > 0 else 0)
        start = pad_left * shift
        m = min(len(flat), n - start)
        out[start:start + m] = flat[:m]
        return out
