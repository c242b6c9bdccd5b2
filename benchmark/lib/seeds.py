"""Seeds and seeded tensors: every input of a run follows from ``--seed``.

``derive`` turns the run's seed (any whole number) and a purpose into a
seed of its own, so that the weights, the data and the program's training
draws never share a stream and the same seed gives the same inputs.
``weights`` makes a parameter set on the device in a few large calls: one
normal draw for every entry that is drawn, split and scaled, plus the
fixed tables.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

STD = 0.02  # every drawn weight, bias and token: N(0, STD^2)


def derive(seed: int, purpose: str) -> int:
    """A 63-bit seed for ``purpose`` from the run's seed."""
    digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, purpose: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, purpose))


def sincos_1d(dim: int, pos: np.ndarray) -> np.ndarray:
    omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", pos.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_2d(dim: int, grid: Tuple[int, int]) -> np.ndarray:
    """(1 + H*W, dim) fixed 2D sin-cos table (MAE's ``get_2d_sincos_pos_
    embed`` with a zero CLS row): w in the first half of the channels."""
    h, w = grid
    gw, gh = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    emb = np.concatenate([sincos_1d(dim // 2, gw), sincos_1d(dim // 2, gh)],
                         axis=1)
    return np.concatenate([np.zeros((1, dim)), emb]).astype(np.float32)


def weights(specs: List[Tuple[str, tuple, str]], seed: int, device
            ) -> Dict[str, torch.Tensor]:
    """{name: f32 tensor on ``device``} for ``specs`` of (name, shape,
    init): 'normal' N(0, STD^2); 'one' 1 + N(0, STD^2) (LayerNorm scales);
    'log10' log 10 + N(0, STD^2) (logit scales); ('sincos', grid) the
    fixed table of a frozen pos embed."""
    drawn = [(n, s) for n, s, init in specs if init in ("normal", "one",
                                                        "log10")]
    total = sum(math.prod(s) for _, s in drawn)
    flat = torch.randn(total, generator=generator(seed, "weights", device),
                       device=device).mul_(STD)
    out, at = {}, 0
    inits = {n: init for n, _, init in specs}
    for name, shape in drawn:
        size = math.prod(shape)
        t = flat[at:at + size].view(shape)
        at += size
        if inits[name] == "one":
            t.add_(1.0)
        elif inits[name] == "log10":
            t.add_(math.log(10.0))
        out[name] = t
    for name, shape, init in specs:
        if isinstance(init, tuple) and init[0] == "sincos":
            table = sincos_2d(shape[-1], init[1])
            out[name] = torch.from_numpy(table).to(device).view(shape)
    return {n: out[n] for n, _, _ in specs}
