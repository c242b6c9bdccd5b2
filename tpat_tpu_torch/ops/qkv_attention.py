"""Fused packed-qkv attention with pruning-score emission (port of
``tpat_tpu/ops/pallas_attention.py::fused_qkv_attention``, non-prefix).

``fused_qkv_attention(qkv, num_heads, mode, num_extra_tokens)`` takes the raw
output of the qkv projection, (B, N, 3C) with sections [q | k | v] and heads
contiguous inside each section, and returns (out (B, N, C), scores
(B, N - extra) f32 or None):

- on a CUDA tensor it launches the Hopper kernel ``csrc/qkv_attention.cu``
  (built with nvcc at first use) or raises;
- on a CPU tensor it runs ``fused_qkv_attention_plain``, the same function in
  plain PyTorch.  That is the only case the plain version serves: nothing
  falls back from the device.

``launches`` counts kernel launches (never plain calls), so a run can show
that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from tpat_tpu_torch.ops import _build
from tpat_tpu_torch.ops.attention import attention_with_scores

launches = 0

HEAD_DIMS = (64, 80)  # the kernel's instantiations
_MODES = {None: 0, "patch_mean": 1, "cls": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def supports(num_heads: int, head_dim: int, n: int) -> bool:
    """Whether the kernel takes this geometry.  The kernel streams keys
    through shared memory, so any N >= 1 fits."""
    return head_dim in HEAD_DIMS and 1 <= num_heads <= 65535 and n >= 1


def reduce_scores(
    colsum: torch.Tensor, mode: Optional[str], n: int, extra: int
) -> Optional[torch.Tensor]:
    """Per-head column sums (B, H, N) -> importance scores (B, N - extra):
    'patch_mean' divides the head sum by H * (N - extra), 'cls' averages the
    CLS rows over heads (``pallas_attention.py:326-346``)."""
    if mode is None:
        return None
    h = colsum.shape[1]
    block = colsum[:, :, extra:]
    if mode == "patch_mean":
        return block.sum(dim=1) / (h * float(n - extra))
    if mode == "cls":
        return block.mean(dim=1)
    raise ValueError(mode)


def _check(qkv: torch.Tensor, num_heads: int, mode, num_extra_tokens: int):
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (B, N, 3C), got {tuple(qkv.shape)}")
    if (qkv.shape[-1] // 3) % num_heads:
        raise ValueError(
            f"C = {qkv.shape[-1] // 3} is not divisible by num_heads "
            f"{num_heads}"
        )
    if mode not in _MODES:
        raise ValueError(f"unknown importance mode: {mode!r}")
    if qkv.dtype not in _DTYPES:
        raise TypeError(f"qkv must be float32 or bfloat16, got {qkv.dtype}")
    if not 0 <= num_extra_tokens < qkv.shape[1]:
        raise ValueError(
            f"num_extra_tokens {num_extra_tokens} out of range for "
            f"N = {qkv.shape[1]}"
        )


def fused_qkv_attention_plain(
    qkv: torch.Tensor,
    num_heads: int,
    mode: Optional[str] = None,
    num_extra_tokens: int = 1,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``fused_qkv_attention`` in plain PyTorch: split heads, run
    ``attention_with_scores``, merge heads."""
    _check(qkv, num_heads, mode, num_extra_tokens)
    b, n, c3 = qkv.shape
    q, k, v = (
        qkv.reshape(b, n, 3, num_heads, -1).permute(2, 0, 3, 1, 4).unbind(0)
    )
    out, scores = attention_with_scores(
        q, k, v,
        num_extra_tokens=num_extra_tokens,
        importance=mode or "patch_mean",
        need_scores=mode is not None,
    )
    return out.transpose(1, 2).reshape(b, n, c3 // 3), scores


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("qkv_attention")
    fn = lib.tpat_qkv_attention_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    lib.tpat_qkv_attention_qtile.argtypes = []
    lib.tpat_qkv_attention_qtile.restype = ctypes.c_int
    return lib


def fused_qkv_attention(
    qkv: torch.Tensor,
    num_heads: int,
    mode: Optional[str] = None,
    num_extra_tokens: int = 1,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Packed-qkv fused attention.  See the module docstring."""
    global launches
    _check(qkv, num_heads, mode, num_extra_tokens)
    if qkv.device.type == "cpu":
        return fused_qkv_attention_plain(qkv, num_heads, mode, num_extra_tokens)
    if qkv.device.type != "cuda":
        raise ValueError(f"no qkv_attention kernel for device {qkv.device}")
    b, n, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    if not supports(num_heads, d, n):
        raise ValueError(
            f"qkv_attention kernel does not take num_heads={num_heads}, "
            f"head_dim={d}, n={n} (head_dim must be one of {HEAD_DIMS})"
        )
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    if qkv.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "the qkv_attention backward kernel is not ported yet; call the "
            "forward under torch.no_grad()"
        )

    out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
    lib = _library()
    colsum = None
    if mode == "patch_mean":
        n_qtiles = -(-n // lib.tpat_qkv_attention_qtile())
        colsum = torch.empty(
            (b, num_heads, n_qtiles, n), dtype=torch.float32, device=qkv.device
        )
    elif mode == "cls":
        colsum = torch.empty(
            (b, num_heads, 1, n), dtype=torch.float32, device=qkv.device
        )
    with torch.cuda.device(qkv.device):
        err = lib.tpat_qkv_attention_fwd(
            qkv.data_ptr(), out.data_ptr(),
            None if colsum is None else colsum.data_ptr(),
            b, n, num_heads, d, _DTYPES[qkv.dtype], _MODES[mode],
            num_extra_tokens, d**-0.5, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"qkv_attention kernel launch failed: CUDA error {err}")
    launches += 1
    if colsum is None:
        return out, None
    return out, reduce_scores(colsum.sum(dim=2), mode, n, num_extra_tokens)
