"""Fused LayerNorm over the last dimension, forward and backward (port of
``tpat_tpu/ops/pallas_layernorm.py``: ``fused_layernorm`` and its custom
VJP).

``fused_layernorm(x, w, b, eps)`` normalises x (..., D) with f32
statistics (mean, then the centred variance) and returns y in x's dtype; w
and b are the f32 (D,) scale and bias.  It is a ``torch.autograd.Function``
that saves (x2, w, mu, rstd), the JAX custom VJP's residuals, x2 being x as
(M, D):

- on a CUDA tensor the forward and the backward launch
  ``csrc/layernorm.cu`` (built with nvcc at first use), or raise: for a width
  outside ``WIDTHS``, a dtype other than f32/bf16, or an input that is not
  contiguous (the wrapper does not copy);
- on a CPU tensor they run the plain versions beside them
  (``layernorm_fwd_plain``, ``layernorm_bwd_plain``).  That is the only case
  the plain versions serve: nothing falls back from the device.

The launch counters count kernel launches (never plain calls): ``launches``
(forward) and ``bwd_launches`` (backward).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from tpat_tpu_torch.ops import _build

launches = 0
bwd_launches = 0

LANES = 128
WIDTHS = (192, 384, 768, 1024, 1280)  # the kernels' instantiations
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def supports(d: int) -> bool:
    """The TPU kernel's criterion, kept for reference: lane-aligned widths.
    The Hopper kernels take ``WIDTHS`` instead."""
    return d % LANES == 0


def layernorm_fwd_plain(
    x2: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_ln_fwd_kernel`` (``pallas_layernorm.py:41-50``) in plain PyTorch:
    (y in x2's dtype, mu (M, 1) f32, rstd (M, 1) f32)."""
    x = x2.float()
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = xc * rstd * w.float() + b.float()
    return y.to(x2.dtype), mu, rstd


def layernorm_bwd_plain(
    x2: torch.Tensor, w: torch.Tensor, mu: torch.Tensor, rstd: torch.Tensor,
    dy: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_ln_bwd_kernel`` and ``_bwd`` (``pallas_layernorm.py:53-67,
    121-156``) in plain PyTorch: (dx in dy's dtype, dw, db as f32 sums over
    rows)."""
    x = x2.float()
    d = dy.float()
    xhat = (x - mu) * rstd
    dyg = d * w.float()
    m1 = dyg.mean(dim=-1, keepdim=True)
    m2 = (dyg * xhat).mean(dim=-1, keepdim=True)
    dx = rstd * (dyg - m1 - xhat * m2)
    return dx.to(dy.dtype), (d * xhat).sum(dim=0), d.sum(dim=0)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("layernorm")
    lib.tpat_layernorm_fwd.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.tpat_layernorm_bwd.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    )
    for fn in (lib.tpat_layernorm_fwd, lib.tpat_layernorm_bwd,
               lib.tpat_layernorm_bwd_rows):
        fn.restype = ctypes.c_int
    lib.tpat_layernorm_bwd_rows.argtypes = []
    return lib


def _check_kernel_args(x2: torch.Tensor, *others: torch.Tensor):
    """What the kernels take: (M, D) with D in ``WIDTHS``, f32 or bf16,
    contiguous, on a CUDA device, and f32 parameters on the same device."""
    m, d = x2.shape
    if d not in WIDTHS:
        raise ValueError(
            f"no layernorm kernel for width {d} (widths {WIDTHS})"
        )
    if x2.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x2.dtype}")
    for t in (x2,) + others:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                "layernorm kernels take contiguous, 16-byte aligned tensors"
            )
    if x2.device.type != "cuda":
        raise ValueError(f"no layernorm kernel for device {x2.device}")
    if any(t.device != x2.device for t in others):
        raise ValueError("all layernorm operands must be on x's device")


def _forward_kernel(x2, w, b, eps):
    """Launch the forward kernel: (y, mu (M, 1), rstd (M, 1))."""
    global launches
    if w.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError("layernorm scale and bias must be float32")
    _check_kernel_args(x2, w, b)
    m, d = x2.shape
    y = torch.empty_like(x2)
    mu = torch.empty((m, 1), dtype=torch.float32, device=x2.device)
    rstd = torch.empty_like(mu)
    with torch.cuda.device(x2.device):
        err = _library().tpat_layernorm_fwd(
            x2.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
            mu.data_ptr(), rstd.data_ptr(), m, d, _DTYPES[x2.dtype], eps,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"layernorm forward launch failed: CUDA error {err}")
    launches += 1
    return y, mu, rstd


def _backward_kernel(x2, w, mu, rstd, dy):
    """Launch the backward kernel and sum its per-CTA partials:
    (dx, dw, db)."""
    global bwd_launches
    if dy.shape != x2.shape or dy.dtype != x2.dtype:
        raise ValueError(
            f"dy must be {tuple(x2.shape)} {x2.dtype}, got "
            f"{tuple(dy.shape)} {dy.dtype}"
        )
    _check_kernel_args(x2, w, mu, rstd, dy)
    m, d = x2.shape
    lib = _library()
    tiles = -(-m // lib.tpat_layernorm_bwd_rows())
    dx = torch.empty_like(dy)
    parts = torch.empty((2, tiles, d), dtype=torch.float32, device=x2.device)
    with torch.cuda.device(x2.device):
        err = lib.tpat_layernorm_bwd(
            x2.data_ptr(), w.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
            dy.data_ptr(), dx.data_ptr(), parts[0].data_ptr(),
            parts[1].data_ptr(), m, d, _DTYPES[x2.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"layernorm backward launch failed: CUDA error {err}")
    bwd_launches += 1
    dw, db = parts.sum(dim=1)
    return dx, dw, db


def layernorm_fwd(x2, w, b, eps):
    """The forward on (M, D): the kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if x2.device.type == "cpu":
        return layernorm_fwd_plain(x2, w, b, eps)
    return _forward_kernel(x2, w, b, eps)


def layernorm_bwd(x2, w, mu, rstd, dy):
    """The backward on (M, D): the kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if x2.device.type == "cpu":
        return layernorm_bwd_plain(x2, w, mu, rstd, dy)
    return _backward_kernel(x2, w, mu, rstd, dy)


class _FusedLayerNorm(torch.autograd.Function):
    """Forward kernel (or plain version on the CPU), saving (x2, w, mu,
    rstd); the backward kernel (or plain version) from them."""

    @staticmethod
    def forward(ctx, x, w, b, eps):
        shape = x.shape
        x2 = x.reshape(-1, shape[-1])
        y, mu, rstd = layernorm_fwd(x2, w, b, eps)
        ctx.save_for_backward(x2, w, mu, rstd)
        ctx.shape = shape
        return y.reshape(shape)

    @staticmethod
    def backward(ctx, dy):
        x2, w, mu, rstd = ctx.saved_tensors
        dx, dw, db = layernorm_bwd(
            x2, w, mu, rstd, dy.reshape(x2.shape).contiguous()
        )
        return dx.reshape(ctx.shape), dw.to(w.dtype), db.to(w.dtype), None


def fused_layernorm(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """LayerNorm over the last axis of x (..., D).  See the module
    docstring."""
    if w.shape != (x.shape[-1],) or b.shape != (x.shape[-1],):
        raise ValueError(
            f"scale and bias must be ({x.shape[-1]},), got "
            f"{tuple(w.shape)} and {tuple(b.shape)}"
        )
    return _FusedLayerNorm.apply(x, w, b, eps)
