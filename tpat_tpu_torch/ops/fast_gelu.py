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
"""

from __future__ import annotations

import torch

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


class _GeluPoly(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        xf = x.float()
        c = xf.clamp(-4.0, 4.0)
        return (xf * (0.5 + c * _horner(_PHI_COEFFS, c * c))).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        xf = x.float()
        c = xf.clamp(-4.0, 4.0)
        u = c * c
        p = _horner(_PHI_COEFFS, u)
        a = xf.abs()
        w = torch.where(a < 4.0, 1.0, torch.where(a == 4.0, 0.5, 0.0))
        deriv = (0.5 + c * p) + xf * w * (p + 2.0 * u * _horner(_DPHI_COEFFS, u))
        return (grad.float() * deriv).to(x.dtype)


def gelu_poly(x: torch.Tensor) -> torch.Tensor:
    """GELU via the degree-8 normal-CDF polynomial (f32 internals)."""
    return _GeluPoly.apply(x)
