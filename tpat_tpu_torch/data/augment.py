"""Host-side audio augmentations (copy of ``tpat_tpu/data/augment.py``),
drawing from the caller's ``np.random.Generator`` in the same calls and
order, so the same generator state gives the same items:

- roll-mag: a Beta(10, 10) + 0.5 gain (the reference's circular roll is
  vestigial: its roll index is always 0, see ``roll_mag_aug``);
- waveform mixup with lambda ~ Beta(10, 10), building soft labels;
- SpecAug frequency/time masking before normalisation, masking with zeros,
  torchaudio semantics: value ~ U[0, param), min ~ U[0, size - value),
  band = [int(min), int(min) + int(value));
- additive noise and a random time roll (SPC-2, VoxCeleb).
"""

from __future__ import annotations

import numpy as np


def roll_mag_aug(waveform: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """The reference draws its roll index from ``len`` of a (1, N) tensor,
    which is 1, so the index is always 0 and only the Beta(10,10)+0.5 gain
    ever applies.  Kept so: an actual roll would change every augmented
    sample against the reference run."""
    mag = rng.beta(10, 10) + 0.5
    return (waveform * mag).astype(np.float32)


def mixup_waveforms(
    w1: np.ndarray, w2: np.ndarray, rng: np.random.Generator
):
    """Pad or cut w2 to w1's length, mix with lambda ~ Beta(10, 10) and
    re-centre.  Returns (mix, lam)."""
    n1, n2 = w1.shape[-1], w2.shape[-1]
    if n1 != n2:
        if n1 > n2:
            tmp = np.zeros_like(w1)
            tmp[..., :n2] = w2[..., :n2]
            w2 = tmp
        else:
            w2 = w2[..., :n1]
    lam = float(rng.beta(10, 10))
    mix = lam * w1 + (1 - lam) * w2
    mix = mix - mix.mean()
    return mix.astype(np.float32), lam


def spec_masking(
    fbank: np.ndarray,
    freqm: int,
    timem: int,
    rng: np.random.Generator,
    mask_value: float = 0.0,
) -> np.ndarray:
    """SpecAug on a (T, F) fbank, one mask each (torchaudio's
    ``_mask_along_axis``): value ~ U[0, param), min ~ U[0, size - value),
    mask [int(min), int(min) + int(value)), start and width truncated
    separately, as torchaudio's ``min_value.long() + value.long()``."""
    fbank = fbank.copy()
    t, f = fbank.shape

    def band(size, param):
        # torchaudio does not clamp param to the axis at the transforms'
        # default p=1.0; value > size makes the start draw negative, and
        # .long() truncates toward zero
        value = rng.uniform(0.0, param)
        min_v = rng.random() * (size - value)
        start = int(min_v)
        return start, start + int(value)

    if freqm > 0:
        s, e = band(f, freqm)
        fbank[:, max(s, 0) : max(e, 0)] = mask_value
    if timem > 0:
        s, e = band(t, timem)
        fbank[max(s, 0) : max(e, 0), :] = mask_value
    return fbank


def noise_aug(fbank: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Add uniform noise scaled by a random factor and roll the time axis by
    U[-10, 10)."""
    fbank = fbank + rng.random(fbank.shape).astype(np.float32) * (
        rng.random() / 10.0
    )
    shift = int(rng.integers(-10, 10))
    return np.roll(fbank, shift, axis=0).astype(np.float32)
