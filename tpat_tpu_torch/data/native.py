"""ctypes binding to the repository's native C++ audio frontend
(``native/libtpat_audio.so``, built by ``make -C native``), a copy of
``tpat_tpu/data/native.py``.

It gives a WAV decoder and a Kaldi fbank that release the GIL.  Nothing
builds the library on first use: where it is absent, or has another ABI
version, or ``TPAT_DISABLE_NATIVE=1`` is set, ``available()`` is False and
the callers take the numpy path, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
import os
import warnings
from typing import Optional, Tuple

import numpy as np

# must match tpat_abi_version() in native/csrc/tpat_audio.cpp
_ABI_VERSION = 2
_LIB_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "native",
    "libtpat_audio.so",
)


@functools.lru_cache(maxsize=1)
def _load() -> Optional[ctypes.CDLL]:
    if os.environ.get("TPAT_DISABLE_NATIVE") == "1":
        return None
    path = os.path.abspath(_LIB_PATH)
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    # ABI guard: a stale .so with a changed signature would take ints where
    # it expects pointers (a segfault inside the loader)
    try:
        ver = int(lib.tpat_abi_version())
    except AttributeError:
        ver = 1
    if ver != _ABI_VERSION:
        warnings.warn(
            f"{path} has native ABI v{ver}, this build needs v{_ABI_VERSION}; "
            "rebuild with `make -C native` (using the numpy frontend)"
        )
        return None
    lib.tpat_load_wav.restype = ctypes.c_int
    lib.tpat_load_wav.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
    ]
    lib.tpat_fbank.restype = ctypes.c_int
    lib.tpat_fbank.argtypes = [
        ctypes.POINTER(ctypes.c_float),  # waveform
        ctypes.c_int64,  # num samples
        ctypes.c_int32,  # sample rate
        ctypes.c_int32,  # num mel bins
        ctypes.c_int32,  # window type (0 hanning, 1 povey)
        ctypes.POINTER(ctypes.c_float),  # out (frames x bins)
        ctypes.POINTER(ctypes.c_int64),  # out frames
    ]
    return lib


def available() -> bool:
    return _load() is not None


def _lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "native/libtpat_audio.so is not loaded (build it with "
            "`make -C native`; TPAT_DISABLE_NATIVE=1 turns it off)"
        )
    return lib


_MAX_SAMPLES = 16000 * 60 * 10  # 10 minutes at 16 kHz


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    lib = _lib()
    buf = np.empty(_MAX_SAMPLES, dtype=np.float32)
    n = ctypes.c_int64(buf.size)
    sr = ctypes.c_int32(0)
    ch = ctypes.c_int32(0)
    rc = lib.tpat_load_wav(
        path.encode(),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(n),
        ctypes.byref(sr),
        ctypes.byref(ch),
        buf.size,
    )
    if rc != 0:
        raise IOError(f"native wav decode failed ({rc}) for {path}")
    # deinterleaved: channel c occupies out[c*n : (c+1)*n)
    data = buf[: n.value * ch.value].copy()
    return data.reshape(ch.value, n.value), sr.value


_WINDOWS = {"hanning": 0, "povey": 1}


def fbank(
    waveform: np.ndarray,
    sample_rate: int,
    num_mel_bins: int = 128,
    window_type: str = "hanning",
) -> np.ndarray:
    lib = _lib()
    wav = np.ascontiguousarray(waveform.reshape(-1), dtype=np.float32)
    max_frames = 1 + len(wav) // (sample_rate // 100)
    out = np.empty((max_frames, num_mel_bins), dtype=np.float32)
    nframes = ctypes.c_int64(0)
    rc = lib.tpat_fbank(
        wav.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(wav),
        sample_rate,
        num_mel_bins,
        _WINDOWS[window_type],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(nframes),
    )
    if rc != 0:
        raise RuntimeError(f"native fbank failed ({rc})")
    return out[: nframes.value].copy()
