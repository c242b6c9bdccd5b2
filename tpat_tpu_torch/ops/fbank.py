"""Kaldi-compatible log-mel filterbank on the host (copy of the numpy half of
``tpat_tpu/ops/fbank.py``: ``FbankConfig`` :47, ``mel_banks`` :103,
``fbank_numpy`` :165, ``pad_or_crop`` :232, ``normalize`` :250).

The reference computes features with ``torchaudio.compliance.kaldi.fbank(
htk_compat=True, use_energy=False, window_type='hanning', num_mel_bins=128,
dither=0.0, frame_shift=10)``; this is that pipeline from the Kaldi
feature-extraction specification:

  frame (snip_edges, 25 ms window / 10 ms shift)
  -> per-frame DC removal
  -> pre-emphasis 0.97 (left-replicated)
  -> hanning window (symmetric, 0.5 - 0.5 cos(2 pi n / (N-1)))
  -> zero-pad to the next power of two
  -> rFFT -> power spectrum
  -> triangular mel bank on the Kaldi mel scale 1127 ln(1 + f/700),
     bins spanning [low_freq=20, nyquist], nyquist column zeroed
  -> log(max(x, eps32))

Copied rather than imported (the port imports nothing of ``tpat_tpu``).
``fbank_numpy`` is the host version, numpy only.  ``fbank_torch`` is the
batched version of ``fbank_jax`` (``:186-233``) for the device frontend
(``ops/frontend.py``): it runs on the device of its input, frames by
``Tensor.unfold``, and takes the rFFT and the mel product from the library
(cuFFT and cuBLAS on the card), all in float32.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np

EPSILON = float(np.finfo(np.float32).eps)  # 1.1920928955078125e-07


@dataclasses.dataclass(frozen=True)
class FbankConfig:
    sample_rate: int = 16000
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    num_mel_bins: int = 128
    low_freq: float = 20.0
    high_freq: float = 0.0  # <= 0: offset from nyquist
    preemphasis: float = 0.97
    remove_dc_offset: bool = True
    window_type: str = "hanning"  # 'hanning' | 'povey' | 'rectangular'
    round_to_power_of_two: bool = True
    snip_edges: bool = True
    use_power: bool = True
    use_log_fbank: bool = True

    @property
    def window_shift(self) -> int:
        return int(self.sample_rate * self.frame_shift_ms / 1000.0)

    @property
    def window_size(self) -> int:
        return int(self.sample_rate * self.frame_length_ms / 1000.0)

    @property
    def padded_window_size(self) -> int:
        if self.round_to_power_of_two:
            return 1 << (self.window_size - 1).bit_length()
        return self.window_size

    def num_frames(self, num_samples: int) -> int:
        if not self.snip_edges:
            raise NotImplementedError("only snip_edges=True (the reference path)")
        if num_samples < self.window_size:
            return 0
        return 1 + (num_samples - self.window_size) // self.window_shift


def mel_scale(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


@functools.lru_cache(maxsize=8)
def _window_fn(window_type: str, window_size: int) -> np.ndarray:
    n = np.arange(window_size, dtype=np.float64)
    if window_type == "hanning":
        w = 0.5 - 0.5 * np.cos(2.0 * math.pi * n / (window_size - 1))
    elif window_type == "povey":
        w = (0.5 - 0.5 * np.cos(2.0 * math.pi * n / (window_size - 1))) ** 0.85
    elif window_type == "rectangular":
        w = np.ones(window_size)
    else:
        raise ValueError(f"unknown window type {window_type}")
    return w.astype(np.float32)


@functools.lru_cache(maxsize=8)
def mel_banks(cfg: FbankConfig) -> np.ndarray:
    """Triangular mel filterbank, shape (num_mel_bins, nfft//2 + 1).

    Kaldi semantics: filters are defined over fft bins 0..nfft/2-1 (the
    nyquist bin is excluded, so its column is zero), centres spaced
    uniformly in mel between low_freq and high_freq with num_bins+1
    intervals.
    """
    nfft = cfg.padded_window_size
    num_fft_bins = nfft // 2
    nyquist = 0.5 * cfg.sample_rate
    high_freq = cfg.high_freq if cfg.high_freq > 0 else nyquist + cfg.high_freq
    if not (0 <= cfg.low_freq < high_freq <= nyquist):
        raise ValueError(f"bad mel range [{cfg.low_freq}, {high_freq}]")

    fft_bin_width = cfg.sample_rate / nfft
    mel_low = mel_scale(cfg.low_freq)
    mel_high = mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (cfg.num_mel_bins + 1)

    bins = np.arange(cfg.num_mel_bins, dtype=np.float64)[:, None]
    left_mel = mel_low + bins * mel_delta
    center_mel = mel_low + (bins + 1.0) * mel_delta
    right_mel = mel_low + (bins + 2.0) * mel_delta

    mel = mel_scale(fft_bin_width * np.arange(num_fft_bins, dtype=np.float64))[None, :]
    up = (mel - left_mel) / (center_mel - left_mel)
    down = (right_mel - mel) / (right_mel - center_mel)
    bank = np.maximum(0.0, np.minimum(up, down))
    bank = np.concatenate(
        [bank, np.zeros((cfg.num_mel_bins, 1))], axis=1
    )  # zero nyquist column
    return bank.astype(np.float32)


def _frame(waveform: np.ndarray, cfg: FbankConfig) -> np.ndarray:
    n = cfg.num_frames(waveform.shape[-1])
    shift, size = cfg.window_shift, cfg.window_size
    idx = np.arange(size)[None, :] + shift * np.arange(n)[:, None]
    return waveform[idx]


def _process_frames(frames: np.ndarray, cfg: FbankConfig) -> np.ndarray:
    """DC removal, pre-emphasis, window and zero pad of (..., window_size)
    frames, in float32."""
    x = frames.astype(np.float32)
    if cfg.remove_dc_offset:
        x = x - x.mean(axis=-1, keepdims=True)
    if cfg.preemphasis != 0.0:
        prev = np.concatenate([x[..., :1], x[..., :-1]], axis=-1)
        x = x - cfg.preemphasis * prev
    x = x * _window_fn(cfg.window_type, cfg.window_size)
    pad = cfg.padded_window_size - cfg.window_size
    if pad:
        x = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
    return x


def fbank_numpy(waveform: np.ndarray, cfg: Optional[FbankConfig] = None) -> np.ndarray:
    """(num_samples,) float waveform -> (num_frames, num_mel_bins) log-mel,
    as ``torchaudio.compliance.kaldi.fbank`` with the reference's arguments
    (dither=0, hanning, htk_compat, use_energy=False)."""
    cfg = cfg or FbankConfig()
    waveform = np.asarray(waveform, dtype=np.float32).reshape(-1)
    frames = _process_frames(_frame(waveform, cfg), cfg)
    spec = np.abs(np.fft.rfft(frames, axis=-1)) ** (2 if cfg.use_power else 1)
    mel = spec.astype(np.float32) @ mel_banks(cfg).T
    if cfg.use_log_fbank:
        mel = np.log(np.maximum(mel, EPSILON))
    return mel.astype(np.float32)


def pad_or_crop(
    fbank: np.ndarray, target_length: int, pad_left: int = 0
) -> np.ndarray:
    """Pad (with the utterance's minimum, as the reference dataset does) or
    crop the time axis to target_length.  ``pad_left`` is VoxCeleb's random
    left/right split of the padding."""
    n = fbank.shape[0]
    p = target_length - n
    if p > 0:
        fill = fbank.min()
        left = np.full((pad_left, fbank.shape[1]), fill, dtype=fbank.dtype)
        right = np.full((p - pad_left, fbank.shape[1]), fill, dtype=fbank.dtype)
        return np.concatenate([left, fbank, right], axis=0)
    if p < 0:
        return fbank[:target_length]
    return fbank


def normalize(fbank, mean: float, std: float):
    """(fbank - mean) / (2 * std), the reference dataset's normalisation."""
    return (fbank - mean) / (std * 2.0)


def fbank_torch(waveforms, cfg: Optional[FbankConfig] = None):
    """Batched log-mel on the device of ``waveforms``: (B, num_samples) ->
    (B, num_frames, num_mel_bins) float32 (a 1-D waveform gives
    (num_frames, num_mel_bins))."""
    import torch

    cfg = cfg or FbankConfig()
    x = torch.as_tensor(waveforms).float()
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    num_frames = cfg.num_frames(x.shape[-1])
    size = cfg.window_size
    frames = x[:, : (num_frames - 1) * cfg.window_shift + size]
    frames = frames.unfold(1, size, cfg.window_shift)  # (B, F, size)
    if cfg.remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if cfg.preemphasis != 0.0:
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - cfg.preemphasis * prev
    window = torch.from_numpy(_window_fn(cfg.window_type, size)).to(x.device)
    frames = frames * window
    pad = cfg.padded_window_size - size
    if pad:
        frames = torch.nn.functional.pad(frames, (0, pad))
    spec = torch.fft.rfft(frames, dim=-1).abs()
    if cfg.use_power:
        spec = spec * spec
    banks = torch.from_numpy(mel_banks(cfg)).to(x.device)
    mel = spec @ banks.T
    if cfg.use_log_fbank:
        mel = torch.log(torch.clamp_min(mel, EPSILON))
    return mel[0] if squeeze else mel
