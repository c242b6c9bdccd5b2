"""The reference's products, in float32 or, for the control, in fp8.

``F32`` runs every product in float32 (the callers turn TF32 off).
``FP8`` is the control of the benchmark's correctness check: the nearest
precision below the configurations' bfloat16.  Every GEMM and both
attention products round their operands to float8 with a per-tensor scale
(the largest magnitude onto the format's largest finite value), e4m3 in the
forward and e5m2 for the incoming gradient in the backward, as fp8
training does, and accumulate in float32.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round_fp8(x: torch.Tensor, dtype, fmax: float) -> torch.Tensor:
    scale = x.detach().abs().amax().float().clamp_min(1e-30) / fmax
    return (x.float() / scale).to(dtype).float() * scale


def e4m3(x):
    return _round_fp8(x, torch.float8_e4m3fn, E4M3_MAX)


def e5m2(x):
    return _round_fp8(x, torch.float8_e5m2, E5M2_MAX)


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = e4m3(a), e4m3(b)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = e5m2(g)
        da = torch.matmul(qg, qb.transpose(-1, -2))
        db = torch.matmul(qa.transpose(-1, -2), qg)
        # broadcast batch dims (a weight shared by every row) sum back
        while db.dim() > qb.dim():
            db = db.sum(0)
        return da, db


class F32:
    name = "f32"

    @staticmethod
    def matmul(a, b):
        return torch.matmul(a, b)

    @classmethod
    def linear(cls, x, w, b=None):
        y = cls.matmul(x, w.t())
        return y if b is None else y + b


class FP8(F32):
    name = "fp8"

    @staticmethod
    def matmul(a, b):
        return _Fp8Matmul.apply(a, b)


PRECISIONS = {"f32": F32, "fp8": FP8}
