"""WAV decoding without torchaudio or soundfile (copy of
``tpat_tpu/data/wav.py``).

A stdlib-``wave`` + numpy PCM decoder, with the native C++ decoder of
``native/`` used when that library is built (``data/native.py``).  Output
follows ``torchaudio.load``: float32 in [-1, 1], shape (channels,
num_samples).
"""

from __future__ import annotations

import wave
from typing import Tuple

import numpy as np

from tpat_tpu_torch.data import native


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """Decode a PCM WAV file -> (waveform (C, N) float32 in [-1, 1], sr)."""
    if native.available():
        try:
            return native.load_wav(path)
        except IOError:
            pass  # a format the native decoder does not take
    return load_wav_python(path)


def load_wav_python(path: str) -> Tuple[np.ndarray, int]:
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:  # unsigned 8-bit
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 3:  # 24-bit packed
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        val = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        val = np.where(val >= 1 << 23, val - (1 << 24), val)
        data = val.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"unsupported WAV sample width {width} in {path}")
    return data.reshape(-1, ch).T.copy(), sr


def save_wav(path: str, waveform: np.ndarray, sr: int):
    """Write float32 [-1, 1] (C, N) or (N,) audio as 16-bit PCM."""
    w = np.asarray(waveform, dtype=np.float32)
    if w.ndim == 1:
        w = w[None]
    pcm = np.clip(w.T * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as f:
        f.setnchannels(w.shape[0])
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())
