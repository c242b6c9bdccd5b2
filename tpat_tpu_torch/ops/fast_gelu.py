"""Polynomial GELU for bf16 compute (port of ``tpat_tpu/ops/fast_gelu.py``).

Phi(x) ~= 0.5 + c * P8(c^2) with c = clip(x, -4, 4): a degree-8 polynomial
in x^2, f32 internals, at most one bf16 ulp from the exact-erf GELU.  The
bf16 MLP uses it under ``gelu_impl='auto'``; float32 keeps the exact erf.
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


def gelu_poly(x: torch.Tensor) -> torch.Tensor:
    """GELU via the degree-8 normal-CDF polynomial (f32 internals)."""
    xf = x.float()
    c = xf.clamp(-4.0, 4.0)
    u = c * c
    p = torch.full_like(u, _PHI_COEFFS[0])
    for coef in _PHI_COEFFS[1:]:
        p = p * u + coef
    return (xf * (0.5 + c * p)).to(x.dtype)
