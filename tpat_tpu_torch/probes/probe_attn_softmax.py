"""Probe P1: where does the fused attention forward's non-product time go?
(port of ``scripts/probe_attn_softmax.py``)

Ablation variants of the attention forward at the headline widths (ViT-B,
b128 bf16), run by ``csrc/attn_probe.cu`` on the B1 kernel's body and
geometry (64-row query tiles, one head per CTA).  In bf16 that is B1's
Hopper kernel (a producer warp's TMA loads into a ring of two K/V stages,
``wgmma`` products, exp2 on the special-function unit), so each variant
removes one part of the kernel the model runs; 'full' and 'noscore' give
B1's output bits.  In f32 it is B1's exact FMA kernel.

  full        the shipped math with scores: B1's two sweeps (K alone for
              the row max and sum, then the normalised p, its column sums
              and round(p).v)
  noscore     B1 without scores: ONE sweep, the max and sum online, O
              rescaled, O / sum at the end
  exp2        log2(e) folded into the logit scale by the caller (in bf16
              B1's own arithmetic, so 'noscore''s bits)
  noexp       p = logits - rowmax (no transcendental; WRONG math, cost
              bound): two sweeps, the final max first
  nomax       no row max (UNSAFE math, bounds the max's cost): one sweep
  mmonly      p = logits, no softmax at all (the product floor): one sweep

``variant_attention(qkv, variant)`` takes packed qkv (B, N, 3 * 768) and
returns (out (B, N, 768) in qkv's dtype, colsum (B, 12, 1, N) f32): zeros
but for 'full', where it is the column sum of the normalised f32 p over the
query rows 1..N-1.  p is rounded to v's dtype before p.v in every variant.
On a CUDA tensor it launches the kernel (or raises); on a CPU tensor it runs
``variant_attention_plain``.  ``launches`` counts kernel launches.

On the card:

    python -m tpat_tpu_torch.probes.probe_attn_softmax

prints, at N = 257 and 181, the null floor, the shipped kernel
(``ops.qkv_attention.fused_qkv_attention`` with patch_mean scores) and each
variant.  If exp2 wins it could ship (the same softmax values up to
rounding); the wrong-math variants only bound how much there is to win.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from tpat_tpu_torch.ops import _build
from tpat_tpu_torch.ops.qkv_attention import aligned16

B, C, H = 128, 768, 12
D = C // H
LOG2E = 1.4426950408889634
VARIANTS = ("full", "noscore", "exp2", "noexp", "nomax", "mmonly")
WIDTHS = (257, 181)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def check_qkv(qkv: torch.Tensor, variant: str):
    """The probe's variants and shapes: packed qkv (B, N, 3 * 768), f32 or
    bf16."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r} (one of {VARIANTS})")
    if qkv.dim() != 3 or qkv.shape[-1] != 3 * C:
        raise ValueError(f"qkv must be (B, N, {3 * C}), got {tuple(qkv.shape)}")
    if qkv.dtype not in _DTYPES:
        raise TypeError(f"qkv must be float32 or bfloat16, got {qkv.dtype}")


def logit_scale(variant: str) -> float:
    """D^-1/2, times log2(e) for exp2 (``probe_attn_softmax.py:52``)."""
    return D ** -0.5 * LOG2E if variant == "exp2" else D ** -0.5


def variant_attention_plain(
    qkv: torch.Tensor, variant: str
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_variant_kernel`` (``probe_attn_softmax.py:42-84``) in plain
    PyTorch, step by step."""
    check_qkv(qkv, variant)
    b, n, _ = qkv.shape
    q, k, v = (t.reshape(b, n, H, D).transpose(1, 2).float()
               for t in qkv.chunk(3, dim=-1))
    logits = torch.matmul(q, k.transpose(-1, -2)) * logit_scale(variant)
    if variant == "mmonly":
        p = logits
    elif variant == "nomax":
        p = torch.exp(logits)
        p = p * (1.0 / p.sum(dim=-1, keepdim=True))
    else:
        m = logits.amax(dim=-1, keepdim=True)
        if variant == "exp2":
            p = torch.exp2(logits - m)
        elif variant == "noexp":
            p = logits - m
        else:
            p = torch.exp(logits - m)
        if variant != "noexp":
            p = p * (1.0 / p.sum(dim=-1, keepdim=True))
    out = torch.matmul(p.to(qkv.dtype).float(), v).to(qkv.dtype)
    out = out.transpose(1, 2).reshape(b, n, C)
    if variant == "full":
        colsum = (p.sum(dim=2, keepdim=True)
                  - p[:, :, :1].sum(dim=2, keepdim=True))
    else:
        colsum = torch.zeros((b, H, 1, n), dtype=torch.float32,
                             device=qkv.device)
    return out, colsum


@functools.cache
def library() -> ctypes.CDLL:
    """The built ``csrc/attn_probe.cu`` (P1's and P2's kernels), bound."""
    lib = _build.load("attn_probe")
    lib.tpat_attn_probe_variant.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.tpat_attn_probe_grouped.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p]
    )
    for fn in (lib.tpat_attn_probe_variant, lib.tpat_attn_probe_grouped):
        fn.restype = ctypes.c_int
    lib.tpat_attn_probe_smem.argtypes = [ctypes.c_int]
    lib.tpat_attn_probe_smem.restype = ctypes.c_longlong
    lib.tpat_attn_probe_variant_rows.argtypes = []
    lib.tpat_attn_probe_variant_rows.restype = ctypes.c_int
    return lib


def check_device(qkv: torch.Tensor):
    """What the probe kernels take beyond ``check_qkv``: a contiguous tensor on
    a CUDA device, starting on a 16-byte boundary (the bf16 kernels' TMA
    loads)."""
    if qkv.device.type != "cuda":
        raise ValueError(f"no attention probe kernel for device {qkv.device}")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    if not aligned16(qkv):
        raise ValueError("qkv must start on a 16-byte boundary")


def _variant_kernel(qkv: torch.Tensor, variant: str):
    global launches
    check_device(qkv)
    b, n, _ = qkv.shape
    lib = library()
    out = torch.empty((b, n, C), dtype=qkv.dtype, device=qkv.device)
    colsum = None
    if variant == "full":
        n_qtiles = -(-n // lib.tpat_attn_probe_variant_rows())
        colsum = torch.empty((b, H, n_qtiles, n), dtype=torch.float32,
                             device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = lib.tpat_attn_probe_variant(
            qkv.data_ptr(), out.data_ptr(),
            None if colsum is None else colsum.data_ptr(), b, n, H,
            _DTYPES[qkv.dtype], VARIANTS.index(variant), logit_scale(variant),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"attention probe launch failed: CUDA error {err}")
    launches += 1
    if colsum is None:
        return out, torch.zeros((b, H, 1, n), dtype=torch.float32,
                                device=qkv.device)
    return out, colsum.sum(dim=2, keepdim=True)


def variant_attention(
    qkv: torch.Tensor, variant: str
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One variant of the attention forward: the kernel on a CUDA tensor,
    the plain version on a CPU tensor.  See the module docstring."""
    check_qkv(qkv, variant)
    if qkv.device.type == "cpu":
        return variant_attention_plain(qkv, variant)
    return _variant_kernel(qkv, variant)


def main(iters: int = 200) -> dict:
    """The probe's rows on the card: {row name: ms per call}."""
    from tpat_tpu_torch.cli.profile_forward import card_name
    from tpat_tpu_torch.ops.qkv_attention import fused_qkv_attention
    from tpat_tpu_torch.probes._bench import Bench

    if not torch.cuda.is_available():
        raise SystemExit("probe_attn_softmax needs a CUDA card")
    print(f"card: {card_name()}", flush=True)
    bench = Bench(iters=iters, name_width=36)
    times = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for w in WIDTHS:
        qkv = torch.randn(B, w, 3 * C, device="cuda", generator=gen).to(
            torch.bfloat16)
        bench(f"[w={w}] null", lambda q: q[:2, :2, 0], qkv, is_floor=True)
        times[f"[w={w}] shipped kernel (+scores)"] = bench(
            f"[w={w}] shipped kernel (+scores)",
            lambda q: fused_qkv_attention(q, H, "patch_mean", 1), qkv)
        for variant in VARIANTS:
            name = f"[w={w}] variant {variant}"
            times[name] = bench(
                name, functools.partial(variant_attention, variant=variant), qkv)
    return times


if __name__ == "__main__":
    main()
