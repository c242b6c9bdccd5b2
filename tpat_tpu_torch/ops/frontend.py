"""The device frontend (port of ``tpat_tpu/ops/frontend.py``): a batch of raw
waveforms -> model-ready spectrograms on the device of the batch.

The order is the host dataset's: fbank -> pad with the clip's minimum or
crop to ``target_length`` -> SpecAug (zero fill, before normalisation) ->
(x - mean) / (2 std) -> noise and a time roll.  The fbank is
``ops.fbank.fbank_torch``; the rest are elementwise passes, a masked min and
a row gather.

Training draws its random numbers from the caller's ``torch.Generator``
through ``frontend_draws``, one helper for all of them (SpecAug's widths and
starts, the noise, its per-clip scale and the per-clip roll), so that a
caller can hand ``device_frontend`` draws of its own instead.
Under data parallelism each draw is made at the global batch's shape and
cut to the rank's rows (``parallel/mesh.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from tpat_tpu_torch.ops import fbank as fb
from tpat_tpu_torch.ops.pruning import take_rows
from tpat_tpu_torch.parallel.mesh import draw_rows, rand_rows


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    sample_rate: int = 16000
    num_mel_bins: int = 128
    target_length: int = 512
    norm_mean: float = -6.6268077
    norm_std: float = 5.358466
    freqm: int = 0
    timem: int = 0
    noise: bool = False

    @property
    def fbank_cfg(self) -> fb.FbankConfig:
        return fb.FbankConfig(
            sample_rate=self.sample_rate, num_mel_bins=self.num_mel_bins
        )


def frontend_draws(
    batch: int, cfg: FrontendConfig, generator: torch.Generator, device=None,
) -> Dict[str, torch.Tensor]:
    """The random numbers of one training batch, in this order: SpecAug's
    uniforms for the frequency band's width and start and the time band's
    width and start ((B,) each, where ``freqm`` and ``timem`` ask for
    them), then the noise's per-clip scale ((B,), already / 10),
    its uniforms ((B, target_length, mel bins)) and the per-clip roll
    ((B,) ints in [-10, 10)), where ``noise`` asks for them."""
    def uniform(*shape):
        return rand_rows(shape, generator, device)

    draws = {}
    if cfg.freqm > 0:
        draws["freq_width"], draws["freq_start"] = uniform(batch), uniform(batch)
    if cfg.timem > 0:
        draws["time_width"], draws["time_start"] = uniform(batch), uniform(batch)
    if cfg.noise:
        draws["noise_scale"] = uniform(batch) / 10.0
        draws["noise"] = uniform(batch, cfg.target_length, cfg.num_mel_bins)
        draws["roll"] = draw_rows(
            lambda n: torch.randint(-10, 10, (n,), generator=generator,
                                    device=device), batch)
    return draws


def _band_keep(size: int, param: float, width_u, start_u) -> torch.Tensor:
    """(B, size) True where kept.  torchaudio's ``_mask_along_axis``: width
    ~ U[0, param) and start ~ U[0, size - width), the band
    [trunc(start), trunc(start) + trunc(width)): start and width are
    truncated separately, and ``param`` is not clamped to ``size`` (a
    negative start truncates toward zero and the band clips at 0)."""
    width = width_u * param
    start = start_u * (size - width)
    lo = torch.trunc(start)
    hi = lo + torch.trunc(width)
    idx = torch.arange(size, dtype=torch.float32, device=width.device)[None, :]
    return ~((idx >= lo[:, None]) & (idx < hi[:, None]))


def _spec_masking_device(mel, freqm: int, timem: int, draws: Dict[str, torch.Tensor]):
    """SpecAug on (B, T, F) ``mel`` from ``frontend_draws``' uniforms
    (``tpat_tpu/ops/frontend.py:47-81``)."""
    _b, t, f = mel.shape
    if freqm > 0:
        keep = _band_keep(f, float(freqm), draws["freq_width"], draws["freq_start"])
        mel = mel * keep[:, None, :]
    if timem > 0:
        keep = _band_keep(t, float(timem), draws["time_width"], draws["time_start"])
        mel = mel * keep[:, :, None]
    return mel


def device_frontend(
    waveforms: torch.Tensor,
    cfg: FrontendConfig,
    generator: Optional[torch.Generator] = None,
    train: bool = False,
    draws: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """(B, num_samples) float32 -> (B, 1, target_length, num_mel_bins) on the
    waveforms' device.  ``train=True`` applies SpecAug and noise as ``cfg``
    asks, from ``draws`` or else from ``frontend_draws`` on ``generator``.

    The NaN contract (``tpat_tpu/ops/frontend.py:84-141``): the datasets pad
    a short clip to ``num_samples`` with a NaN tail, which PCM cannot hold.
    The true length is the count of finite samples; frames that length
    cannot produce take the clip's minimum over its real frames, as the
    reference pads the mel of the unpadded clip with ``fbank.min()``.  A
    NaN head is VoxCeleb's random left pad and must be a multiple of the
    frame shift (160 samples), so that the real frames line up with the
    unpadded clip's.  The NaNs are zeroed before the FFT; a finite batch is
    unaffected."""
    finite = torch.isfinite(waveforms)
    n_samp = finite.sum(dim=1)
    head = torch.argmax(finite.to(torch.int32), dim=1)  # first real sample
    waveforms = torch.where(finite, waveforms, torch.zeros_like(waveforms))

    fcfg = cfg.fbank_cfg
    mel = fb.fbank_torch(waveforms, fcfg)  # (B, frames, bins)
    b, n_frames, bins = mel.shape
    valid = torch.where(
        n_samp < fcfg.window_size,
        torch.zeros_like(n_samp),
        1 + torch.div(n_samp - fcfg.window_size, fcfg.window_shift,
                      rounding_mode="floor"),
    ).clamp(1, n_frames)
    head_frames = torch.div(head, fcfg.window_shift, rounding_mode="floor")
    fidx = torch.arange(n_frames, device=mel.device)[None, :]
    frame_ok = (fidx >= head_frames[:, None]) & (fidx < (head_frames + valid)[:, None])
    inf = torch.full_like(mel, float("inf"))
    real_min = torch.where(frame_ok[:, :, None], mel, inf).amin(dim=(1, 2), keepdim=True)
    mel = torch.where(frame_ok[:, :, None], mel, real_min)

    t = cfg.target_length
    if n_frames < t:
        fill = mel.amin(dim=(1, 2), keepdim=True)
        mel = torch.cat([mel, fill.expand(b, t - n_frames, bins)], dim=1)
    elif n_frames > t:
        mel = mel[:, :t]

    augment = train and (cfg.freqm or cfg.timem or cfg.noise)
    if augment and draws is None:
        if generator is None:
            raise ValueError("training augmentation draws random numbers: "
                             "pass a torch.Generator on the waveforms' device")
        draws = frontend_draws(b, cfg, generator, mel.device)
    if train and (cfg.freqm or cfg.timem):
        mel = _spec_masking_device(mel, cfg.freqm, cfg.timem, draws)
    mel = fb.normalize(mel, cfg.norm_mean, cfg.norm_std)
    if train and cfg.noise:
        mel = mel + draws["noise"] * draws["noise_scale"][:, None, None]
        rows = torch.remainder(
            torch.arange(t, device=mel.device)[None, :] - draws["roll"][:, None], t)
        mel = take_rows(mel, rows)
    return mel[:, None]


def make_preprocess(data_cfg, ast_orientation: bool = False):
    """The engines' ``preprocess(x, generator, specaug, train)`` for
    ``--device_frontend`` (``tpat_tpu/cli/finetune.py:228-250``,
    ``cli/run_ast.py:206-240``) from a ``DataConfig``: in training, SpecAug
    (``freqm``/``timem``) where ``specaug`` asks and the noise where the
    config has it; in eval, neither.  ``ast_orientation`` transposes the
    spectrogram to AST's (B, 1, F, T) after the frontend."""
    train_cfg = FrontendConfig(
        num_mel_bins=data_cfg.num_mel_bins,
        target_length=data_cfg.target_length,
        norm_mean=data_cfg.norm_mean,
        norm_std=data_cfg.norm_std,
        freqm=data_cfg.freqm,
        timem=data_cfg.timem,
        noise=data_cfg.use_noise,
    )
    no_specaug = dataclasses.replace(train_cfg, freqm=0, timem=0)
    eval_cfg = dataclasses.replace(no_specaug, noise=False)

    def preprocess(x, generator, specaug: bool, train: bool) -> torch.Tensor:
        cfg = (train_cfg if specaug else no_specaug) if train else eval_cfg
        spec = device_frontend(x, cfg, generator, train=train)
        return spec.transpose(2, 3) if ast_orientation else spec

    return preprocess
