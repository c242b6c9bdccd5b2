"""Fused packed-qkv attention with pruning-score emission, forward and
backward (port of ``tpat_tpu/ops/pallas_attention.py``:
``fused_qkv_attention``, ``fused_qkv_attention_prefix`` and their custom
VJPs).

``fused_qkv_attention(qkv, num_heads, mode, num_extra_tokens)`` takes the raw
output of the qkv projection, (B, N, 3C) with sections [q | k | v] and heads
contiguous inside each section, and returns (out (B, N, C), scores
(B, N - extra) f32 or None).  ``fused_qkv_attention_prefix`` takes one more
argument, ``kv_valid`` (a host int): keys at or past it are masked and
'patch_mean' averages over the query rows [extra, kv_valid) only -- the
hybrid anneal's attention once its kept set is a uniform prefix.

Both are ``torch.autograd.Function``s that save ``qkv`` (the JAX custom VJPs'
residual) and recompute p in the backward:

- on a CUDA tensor the forward launches ``csrc/qkv_attention.cu`` and the
  backward ``csrc/qkv_attention_bwd.cu`` (both built with nvcc at first use),
  or raise: bf16 at head_dim 32 and 64 runs their wgmma and TMA kernels,
  bf16 at head_dim 80 their mma.sync kernels, f32 their exact FMA kernels,
  and a tensor that is not contiguous or does not start on a 16-byte
  boundary (``aligned16``), or whose row of 3C bf16 values is not a multiple
  of 16 bytes (TMA), is refused;
- where the backward kernels read the forward's row log-sum-exp L (bf16 at
  head_dim 32 and 64, ``reads_lse``), a call recorded for autograd
  (grad enabled and ``qkv.requires_grad``) has the forward kernel write L
  as f32 (B, H, N) and saves the output and L beside qkv; the backward then
  rebuilds p from L and takes delta from the output (no online statistics);
- on a CPU tensor they run the plain PyTorch versions beside them
  (``fused_qkv_attention_plain``, ``fused_qkv_attention_prefix_plain``,
  ``fused_qkv_attention_bwd_plain``).  That is the only case the plain
  versions serve: nothing falls back from the device.

A ``None`` score cotangent (scores unused, as when they only feed top-k) is
the JAX ``has_scores=False`` branch: no score work in the backward.

The launch counters count kernel launches (never plain calls), so a run can
show that its path went through the kernels: ``launches`` (forward),
``prefix_launches`` (prefix forward), ``bwd_rows_launches`` and
``bwd_cols_launches`` (the two backward kernels).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from tpat_tpu_torch.ops import _build
from tpat_tpu_torch.ops.attention import attention_with_scores

launches = 0
prefix_launches = 0
bwd_rows_launches = 0
bwd_cols_launches = 0

HEAD_DIMS = (32, 64, 80)  # the kernels' instantiations
_MODES = {None: 0, "patch_mean": 1, "cls": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def supports(num_heads: int, head_dim: int, n: int) -> bool:
    """Whether the kernels take this geometry.  They stream keys (and
    queries) through shared memory, so any N >= 1 fits."""
    return head_dim in HEAD_DIMS and 1 <= num_heads <= 65535 and n >= 1


def reduce_scores(
    colsum: torch.Tensor,
    mode: Optional[str],
    n: int,
    extra: int,
    kv_valid: Optional[int] = None,
) -> Optional[torch.Tensor]:
    """Per-head column sums (B, H, N) -> importance scores (B, N - extra):
    'patch_mean' divides the head sum by H * (N - extra), or by
    H * (kv_valid - extra) in prefix form; 'cls' averages the CLS rows over
    heads (``pallas_attention.py:326-346``)."""
    if mode is None:
        return None
    h = colsum.shape[1]
    block = colsum[:, :, extra:]
    if mode == "patch_mean":
        valid = n if kv_valid is None else kv_valid
        return block.sum(dim=1) / (h * float(valid - extra))
    if mode == "cls":
        return block.mean(dim=1)
    raise ValueError(mode)


def _check(qkv, num_heads: int, mode, num_extra_tokens: int, kv_valid=None):
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
    n = qkv.shape[1]
    if not 0 <= num_extra_tokens < n:
        raise ValueError(
            f"num_extra_tokens {num_extra_tokens} out of range for N = {n}"
        )
    if kv_valid is not None and not (
        isinstance(kv_valid, int) and num_extra_tokens < kv_valid <= n
    ):
        raise ValueError(
            f"kv_valid must be an int in ({num_extra_tokens}, {n}], got "
            f"{kv_valid!r}"
        )


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, N, C) -> (B, H, N, D)."""
    b, n, c = x.shape
    return x.reshape(b, n, num_heads, c // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, N, D) -> (B, N, C)."""
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def _prefix_mask(b: int, n: int, extra: int, kv_valid: int, device):
    """The (B, P) token mask of a uniform prefix of kv_valid - extra kept
    patch tokens."""
    keep = torch.arange(n - extra, device=device) < kv_valid - extra
    return keep.expand(b, -1)


def fused_qkv_attention_plain(
    qkv: torch.Tensor,
    num_heads: int,
    mode: Optional[str] = None,
    num_extra_tokens: int = 1,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``fused_qkv_attention`` in plain PyTorch: split heads, run
    ``attention_with_scores``, merge heads."""
    _check(qkv, num_heads, mode, num_extra_tokens)
    q, k, v = (_split_heads(t, num_heads) for t in qkv.chunk(3, dim=-1))
    out, scores = attention_with_scores(
        q, k, v,
        num_extra_tokens=num_extra_tokens,
        importance=mode or "patch_mean",
        need_scores=mode is not None,
    )
    return _merge_heads(out), scores


def fused_qkv_attention_prefix_plain(
    qkv: torch.Tensor,
    kv_valid: int,
    num_heads: int,
    mode: Optional[str] = None,
    num_extra_tokens: int = 1,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``fused_qkv_attention_prefix`` in plain PyTorch: the masked
    ``attention_with_scores`` under the prefix token mask, which is what the
    JAX prefix backward differentiates (``pallas_attention.py:718-747``)."""
    _check(qkv, num_heads, mode, num_extra_tokens, kv_valid)
    b, n = qkv.shape[:2]
    q, k, v = (_split_heads(t, num_heads) for t in qkv.chunk(3, dim=-1))
    out, scores = attention_with_scores(
        q, k, v,
        num_extra_tokens=num_extra_tokens,
        importance=mode or "patch_mean",
        token_mask=_prefix_mask(b, n, num_extra_tokens, kv_valid, qkv.device),
        need_scores=mode is not None,
    )
    return _merge_heads(out), scores


def _score_cotangent(d_scores, mode, num_heads, n, extra, kv_valid):
    """The score cotangent as the backward kernel takes it
    (``pallas_attention.py:464-479``): f32, divided by H * (N - extra),
    H * (kv_valid - extra) in prefix form, or H for 'cls', and zero-padded
    over the extras to (B, N).  None when there is no score work."""
    if mode is None or d_scores is None:
        return None
    if mode == "patch_mean":
        denom = float(num_heads * ((n if kv_valid is None else kv_valid) - extra))
    else:
        denom = float(num_heads)
    return F.pad(d_scores.float() / denom, (extra, 0)).contiguous()


def fused_qkv_attention_bwd_plain(
    qkv: torch.Tensor,
    d_out: torch.Tensor,
    d_scores: Optional[torch.Tensor],
    num_heads: int,
    mode: Optional[str],
    num_extra_tokens: int,
    kv_valid: Optional[int] = None,
) -> torch.Tensor:
    """The backward kernel's math in plain PyTorch
    (``pallas_attention.py:381-449``), rounding where it rounds: p in f32
    normalised by a reciprocal multiply; dp = dO.v^T in f32 plus the
    pre-scaled score cotangent on the rows the score reads; dlog =
    p (dp - sum dp p) rounded to qkv's dtype; dq, dk from f32 products of
    working-type operands times the scale, dv = round(p)^T.dO.  Returns the
    packed (B, N, 3C) gradient in qkv's dtype."""
    _check(qkv, num_heads, mode, num_extra_tokens, kv_valid)
    n = qkv.shape[1]
    dt = qkv.dtype
    e = num_extra_tokens
    q, k, v = (_split_heads(t, num_heads).float() for t in qkv.chunk(3, dim=-1))
    scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    if kv_valid is not None:
        masked = torch.arange(n, device=qkv.device) >= kv_valid
        logits = logits.masked_fill(masked, -1e30)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p * (1.0 / p.sum(dim=-1, keepdim=True))
    do = _split_heads(d_out, num_heads).float()
    dp = torch.matmul(do, v.transpose(-1, -2))
    ds = _score_cotangent(d_scores, mode, num_heads, n, e, kv_valid)
    if ds is not None:
        row = torch.arange(n, device=qkv.device)
        if mode == "patch_mean":
            rows = (row >= e) & (row < (n if kv_valid is None else kv_valid))
        else:
            rows = row == 0
        dp = dp + rows.float()[:, None] * ds[:, None, None, :]
    dlog = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))).to(dt).float()
    dq = torch.matmul(dlog, k) * scale
    dk = torch.matmul(dlog.transpose(-1, -2), q) * scale
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), do)
    return torch.cat([_merge_heads(g.to(dt)) for g in (dq, dk, dv)], dim=-1)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("qkv_attention")
    fn = lib.tpat_qkv_attention_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    lib.tpat_qkv_attention_qtile.argtypes = []
    lib.tpat_qkv_attention_qtile.restype = ctypes.c_int
    lib.tpat_qkv_attention_reads_lse.argtypes = [ctypes.c_int] * 2
    lib.tpat_qkv_attention_reads_lse.restype = ctypes.c_int
    return lib


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    lib = _build.load("qkv_attention_bwd")
    for fn in (lib.tpat_qkv_attention_bwd_rows, lib.tpat_qkv_attention_bwd_cols):
        fn.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib


def reads_lse(dtype: torch.dtype, head_dim: int) -> bool:
    """Whether the kernels for (dtype, head_dim) pass the row log-sum-exp
    and the output from the forward to the backward (the wgmma bodies), as
    the forward library states it; a CUDA-side question, since it loads
    that library."""
    return bool(_library().tpat_qkv_attention_reads_lse(_DTYPES[dtype],
                                                        head_dim))


def aligned16(t: torch.Tensor) -> bool:
    """Whether ``t``'s data starts on a 16-byte boundary, as the bf16
    kernels' TMA and cp.async copies and 16-byte loads need."""
    return t.data_ptr() % 16 == 0


def _check_device(qkv: torch.Tensor, num_heads: int):
    if qkv.device.type != "cuda":
        raise ValueError(f"no qkv_attention kernel for device {qkv.device}")
    b, n, c3 = qkv.shape
    d = c3 // 3 // num_heads
    if not supports(num_heads, d, n):
        raise ValueError(
            f"qkv_attention kernels do not take num_heads={num_heads}, "
            f"head_dim={d}, n={n} (head_dim must be one of {HEAD_DIMS})"
        )
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    if not aligned16(qkv):
        raise ValueError("qkv must start on a 16-byte boundary")
    if reads_lse(qkv.dtype, d) and (c3 * qkv.element_size()) % 16:
        raise ValueError(
            f"a qkv row of {c3} bf16 values is not a multiple of 16 bytes, "
            "as the TMA tiles need"
        )


def _forward_kernel(qkv, num_heads, mode, extra, kv_valid, want_lse=False):
    """Launch the forward kernel (plain form when kv_valid is None); returns
    (out, scores, lse).  ``want_lse`` asks the kernel for the f32 (B, H, N)
    row log-sum-exp, which only the bodies that pass it to the backward
    write (``reads_lse``); lse is None otherwise."""
    global launches, prefix_launches
    _check_device(qkv, num_heads)
    b, n, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
    lse = None
    if want_lse and reads_lse(qkv.dtype, d):
        lse = torch.empty((b, num_heads, n), dtype=torch.float32,
                          device=qkv.device)
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
            None if lse is None else lse.data_ptr(),
            b, n, num_heads, d, _DTYPES[qkv.dtype], _MODES[mode], extra,
            n if kv_valid is None else kv_valid, d**-0.5,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"qkv_attention kernel launch failed: CUDA error {err}")
    if kv_valid is None:
        launches += 1
    else:
        prefix_launches += 1
    if colsum is None:
        return out, None, lse
    return (out, reduce_scores(colsum.sum(dim=2), mode, n, extra, kv_valid),
            lse)


def _bwd_launch_args(qkv, d_out, d_scores, num_heads, mode, extra, kv_valid,
                     out=None, lse=None):
    """Check the inputs and allocate the outputs of the backward kernels;
    returns (the C functions' argument tuple, dqkv, the tensors the
    arguments point into).  Where the kernels read the forward's output and
    row log-sum-exp (``reads_lse``) and ``out``/``lse`` are not given, the
    forward kernel runs first to make them."""
    _check_device(qkv, num_heads)
    b, n, c3 = qkv.shape
    d = c3 // 3 // num_heads
    if d_out.shape != (b, n, c3 // 3) or d_out.dtype != qkv.dtype:
        raise ValueError(
            f"d_out must be {(b, n, c3 // 3)} {qkv.dtype}, got "
            f"{tuple(d_out.shape)} {d_out.dtype}"
        )
    if d_out.device != qkv.device:
        raise ValueError("d_out must be on qkv's device")
    d_out = d_out.contiguous()
    if not aligned16(d_out):
        raise ValueError("d_out must start on a 16-byte boundary")
    ds = _score_cotangent(d_scores, mode, num_heads, n, extra, kv_valid)
    if not reads_lse(qkv.dtype, d):
        out = lse = None
    elif out is None or lse is None:
        out, _, lse = _forward_kernel(qkv, num_heads, None, extra, kv_valid,
                                      want_lse=True)
    elif (out.shape != d_out.shape or out.dtype != qkv.dtype
          or lse.shape != (b, num_heads, n) or lse.dtype != torch.float32
          or not (out.is_contiguous() and lse.is_contiguous())
          or not aligned16(out)):
        raise ValueError("out and lse must be the forward's contiguous "
                         f"{tuple(d_out.shape)} output and ({b}, "
                         f"{num_heads}, {n}) f32 row log-sum-exp")
    dqkv = torch.empty_like(qkv)
    stats = torch.empty((b, num_heads, 3, n), dtype=torch.float32,
                        device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
    args = (
        qkv.data_ptr(), d_out.data_ptr(),
        None if ds is None else ds.data_ptr(),
        dqkv.data_ptr(), stats.data_ptr(),
        None if out is None else out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        b, n, num_heads, d, _DTYPES[qkv.dtype],
        _MODES[mode if ds is not None else None], extra,
        n if kv_valid is None else kv_valid, d**-0.5, stream,
    )
    return args, dqkv, (qkv, d_out, ds, stats, out, lse)


def _backward_kernels(qkv, d_out, d_scores, num_heads, mode, extra, kv_valid,
                      out=None, lse=None):
    """Launch the two backward kernels: rows (dq and the softmax
    statistics), then cols (dk and dv)."""
    global bwd_rows_launches, bwd_cols_launches
    args, dqkv, _keep = _bwd_launch_args(
        qkv, d_out, d_scores, num_heads, mode, extra, kv_valid, out, lse
    )
    lib = _bwd_library()
    with torch.cuda.device(qkv.device):
        err = lib.tpat_qkv_attention_bwd_rows(*args)
        if err != 0:
            raise RuntimeError(
                f"qkv_attention_bwd rows kernel launch failed: CUDA error {err}"
            )
        bwd_rows_launches += 1
        err = lib.tpat_qkv_attention_bwd_cols(*args)
        if err != 0:
            raise RuntimeError(
                f"qkv_attention_bwd cols kernel launch failed: CUDA error {err}"
            )
        bwd_cols_launches += 1
    return dqkv


def fused_qkv_attention_bwd(
    qkv: torch.Tensor,
    d_out: torch.Tensor,
    d_scores: Optional[torch.Tensor],
    num_heads: int,
    mode: Optional[str],
    num_extra_tokens: int,
    kv_valid: Optional[int] = None,
    *,
    out: Optional[torch.Tensor] = None,
    lse: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Gradient of both public functions with respect to the packed qkv:
    the backward kernels on a CUDA tensor, the plain version on a CPU
    tensor.  ``out`` and ``lse`` are the forward's output and row
    log-sum-exp, which the kernels that read them (``reads_lse``) otherwise
    make by running the forward kernel first; the plain version ignores
    them."""
    _check(qkv, num_heads, mode, num_extra_tokens, kv_valid)
    if qkv.device.type == "cpu":
        return fused_qkv_attention_bwd_plain(
            qkv, d_out, d_scores, num_heads, mode, num_extra_tokens, kv_valid
        )
    return _backward_kernels(
        qkv, d_out, d_scores, num_heads, mode, num_extra_tokens, kv_valid,
        out, lse
    )


class _FusedQKVAttention(torch.autograd.Function):
    """Forward kernel (or plain version on the CPU), saving qkv and, where
    the backward kernels read them, the output and the row log-sum-exp; the
    backward recomputes p, as the JAX custom VJPs do."""

    @staticmethod
    def forward(ctx, qkv, kv_valid, num_heads, mode, extra, record):
        ctx.set_materialize_grads(False)
        ctx.args = (kv_valid, num_heads, mode, extra)
        if qkv.device.type == "cpu":
            ctx.save_for_backward(qkv)
            if kv_valid is None:
                return fused_qkv_attention_plain(qkv, num_heads, mode, extra)
            return fused_qkv_attention_prefix_plain(
                qkv, kv_valid, num_heads, mode, extra
            )
        out, scores, lse = _forward_kernel(
            qkv, num_heads, mode, extra, kv_valid, want_lse=record
        )
        if lse is None:
            ctx.save_for_backward(qkv)
        else:
            ctx.save_for_backward(qkv, out, lse)
        return out, scores

    @staticmethod
    def backward(ctx, d_out, d_scores):
        qkv, *saved = ctx.saved_tensors
        out, lse = saved if saved else (None, None)
        kv_valid, num_heads, mode, extra = ctx.args
        if d_out is None:
            b, n, c3 = qkv.shape
            d_out = qkv.new_zeros((b, n, c3 // 3))
        d_qkv = fused_qkv_attention_bwd(
            qkv, d_out, d_scores, num_heads, mode, extra, kv_valid,
            out=out, lse=lse,
        )
        return d_qkv, None, None, None, None, None


def _recorded(qkv: torch.Tensor) -> bool:
    """Whether autograd records this call (the forward then writes L)."""
    return torch.is_grad_enabled() and qkv.requires_grad


def fused_qkv_attention(
    qkv: torch.Tensor,
    num_heads: int,
    mode: Optional[str] = None,
    num_extra_tokens: int = 1,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Packed-qkv fused attention.  See the module docstring."""
    _check(qkv, num_heads, mode, num_extra_tokens)
    return _FusedQKVAttention.apply(
        qkv, None, num_heads, mode, num_extra_tokens, _recorded(qkv)
    )


def fused_qkv_attention_prefix(
    qkv: torch.Tensor,
    kv_valid: int,
    num_heads: int,
    mode: Optional[str] = None,
    num_extra_tokens: int = 1,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Packed-qkv fused attention over the valid prefix [0, kv_valid) of
    keys.  See the module docstring."""
    _check(qkv, num_heads, mode, num_extra_tokens, kv_valid)
    return _FusedQKVAttention.apply(
        qkv, kv_valid, num_heads, mode, num_extra_tokens, _recorded(qkv)
    )
