"""Polynomial GELU for bf16 compute (port of ``tpat_tpu/ops/fast_gelu.py``).

Phi(x) ~= 0.5 + c * P8(c^2) with c = clip(x, -4, 4): a degree-8 polynomial
in x^2, f32 internals, at most one bf16 ulp from the exact-erf GELU.  The
bf16 MLP uses it under ``gelu_impl='auto'``; float32 keeps the exact erf.

``gelu_poly`` is a ``torch.autograd.Function`` that saves only its input:
eager autograd through the Horner loop would keep about ten f32 copies of
the (B, N, 4C) MLP activation per block.  Its backward is the derivative of
the same polynomial, which is what JAX autodiff of the JAX function takes
(not the derivative of erf):

    d/dx[x (0.5 + c P(c^2))] = (0.5 + c P) + x w(x) (P + 2 c^2 P'(c^2))

with w = 1 inside (-4, 4), 0 outside, and 1/2 at x = +-4, where
``jnp.clip``'s max/min split the cotangent of a tie.

On a bf16 CUDA tensor the forward and the backward each launch one kernel
of ``csrc/gelu_poly.cu`` (built with nvcc at first use), bit-equal to the
eager ops: the JAX function is one pass that XLA fuses, the eager ops are
about twenty f32 passes forward and forty backward.  Every other input
(CPU tensors, f16, f32 under ``gelu_impl='poly'``) takes the eager ops,
``gelu_poly_fwd_plain`` and ``gelu_poly_bwd_plain``.  The counts
``gelu_kernel`` and ``gelu_eager`` (``utils/tracing.py``) add each call's
elements on its path while a profiler records; ``launches`` and
``bwd_launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpat_tpu_torch.ops import _build
from tpat_tpu_torch.utils import tracing

launches = 0
bwd_launches = 0

# The JAX package's least-squares fit, highest degree first (Horner).
_PHI_COEFFS = (
    1.0437082800930469e-10,
    -8.556417154670983e-09,
    3.133383082177645e-07,
    -6.887952730722726e-06,
    0.00010369028263041697,
    -0.0011557097249377051,
    0.009929856442255788,
    -0.06646679714687166,
    0.39894017033119056,
)


# P'(u), highest degree first: coefficient i of P has degree 8 - i.
_DPHI_COEFFS = tuple(
    (len(_PHI_COEFFS) - 1 - i) * a for i, a in enumerate(_PHI_COEFFS[:-1])
)


def _horner(coeffs, u: torch.Tensor) -> torch.Tensor:
    p = torch.full_like(u, coeffs[0])
    for coef in coeffs[1:]:
        p = p * u + coef
    return p


def gelu_poly_fwd_plain(x: torch.Tensor) -> torch.Tensor:
    """The forward as eager f32 ops, in x's dtype."""
    xf = x.float()
    c = xf.clamp(-4.0, 4.0)
    return (xf * (0.5 + c * _horner(_PHI_COEFFS, c * c))).to(x.dtype)


def gelu_poly_bwd_plain(x: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """The backward as eager f32 ops: grad times the polynomial's
    derivative at x, in x's dtype."""
    xf = x.float()
    c = xf.clamp(-4.0, 4.0)
    u = c * c
    p = _horner(_PHI_COEFFS, u)
    a = xf.abs()
    w = torch.where(a < 4.0, 1.0, torch.where(a == 4.0, 0.5, 0.0))
    deriv = (0.5 + c * p) + xf * w * (p + 2.0 * u * _horner(_DPHI_COEFFS, u))
    return (grad.float() * deriv).to(x.dtype)


def takes_kernel(device: torch.device, dtype: torch.dtype) -> bool:
    """Whether a tensor on ``device`` of ``dtype`` takes the kernels."""
    return device.type == "cuda" and dtype == torch.bfloat16


@functools.cache
def kernel_coeffs():
    """(P's, P''s coefficients) as the f32 arrays handed to the kernels."""
    return ((ctypes.c_float * len(_PHI_COEFFS))(*_PHI_COEFFS),
            (ctypes.c_float * len(_DPHI_COEFFS))(*_DPHI_COEFFS))


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("gelu_poly")
    floats = ctypes.POINTER(ctypes.c_float)
    lib.tpat_gelu_poly_fwd.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int64, floats, ctypes.c_void_p])
    lib.tpat_gelu_poly_bwd.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int64, floats, floats,
                                 ctypes.c_void_p])
    lib.tpat_gelu_poly_fwd.restype = ctypes.c_int
    lib.tpat_gelu_poly_bwd.restype = ctypes.c_int
    return lib


def _check_kernel_input(x: torch.Tensor):
    if not takes_kernel(x.device, x.dtype):
        raise TypeError(f"the gelu_poly kernels take bf16 CUDA tensors, got "
                        f"{x.dtype} on {x.device}")


def _operand(t: torch.Tensor) -> torch.Tensor:
    """t as the kernels read it, contiguous and 16-byte aligned: a view that
    is neither is copied (fc1's output, on the models' paths, is both)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _forward_kernel(x: torch.Tensor) -> torch.Tensor:
    global launches
    _check_kernel_input(x)
    x = _operand(x)
    y = torch.empty_like(x)
    phi, _ = kernel_coeffs()
    with torch.cuda.device(x.device):
        err = _library().tpat_gelu_poly_fwd(
            x.data_ptr(), y.data_ptr(), x.numel(), phi,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gelu_poly forward launch failed: CUDA error {err}")
    launches += 1
    return y


def _backward_kernel(x: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    global bwd_launches
    _check_kernel_input(x)
    x, grad = _operand(x), _operand(grad)
    if grad.shape != x.shape or grad.dtype != x.dtype or grad.device != x.device:
        raise ValueError(
            f"grad must be {tuple(x.shape)} {x.dtype} on {x.device}, got "
            f"{tuple(grad.shape)} {grad.dtype} on {grad.device}")
    dx = torch.empty_like(x)
    phi, dphi = kernel_coeffs()
    with torch.cuda.device(x.device):
        err = _library().tpat_gelu_poly_bwd(
            x.data_ptr(), grad.data_ptr(), dx.data_ptr(), x.numel(), phi,
            dphi, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gelu_poly backward launch failed: CUDA error {err}")
    bwd_launches += 1
    return dx


class _GeluPoly(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        if takes_kernel(x.device, x.dtype):
            tracing.count("gelu_kernel", x.numel())
            return _forward_kernel(x)
        tracing.count("gelu_eager", x.numel())
        return gelu_poly_fwd_plain(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        if takes_kernel(x.device, x.dtype):
            tracing.count("gelu_kernel", x.numel())
            return _backward_kernel(x, grad)
        tracing.count("gelu_eager", x.numel())
        return gelu_poly_bwd_plain(x, grad)


def gelu_poly(x: torch.Tensor) -> torch.Tensor:
    """GELU via the degree-8 normal-CDF polynomial (f32 internals)."""
    return _GeluPoly.apply(x)
