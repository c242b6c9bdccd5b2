"""Fused swin_v2_cr window attention for the MAE decoder, forward and
backward (port of ``tpat_tpu/ops/pallas_window_attention.py``).

Window attention is evaluated as masked attention over the whole token grid:
the (4, 4) window tiling, the alternating shift roll, the shift-region -100
mask and the log-CPB relative-position bias collapse into one additive
per-head template

    template[h, i, j] = bias[h, p_i, p_j] + region_mask[w_i, p_i, p_j]
                        if w_i == w_j else -1e30

(``build_window_template``), and the attention is

    out = softmax(cos(q, k) * scale[h] + template[h]) . v

with cos the cosine of the f32-normalised q and k rows.  Cross-window pairs
get -1e30, so their probabilities are exact zeros.  Two formulations:

- dense (``fused_window_attention``): tokens in the grid's original order,
  an (H, N, N) template;
- banded (``fused_window_attention_banded``): tokens in window-major order
  (``window_order``'s ``perm``, applied by the caller), where window
  attention is block-diagonal over 128-token chunks, so each row needs only
  its own chunk's 128 columns: an (H, N, 128) band (``build_band_template``).

Both take the packed qkv projection (B, N, 3C), sections [q | k | v] with
heads contiguous, the (H,) f32 scales exp(min(logit_scale, log 100)) and
the f32 template, and return (B, N, C).  Both are
``torch.autograd.Function``s that save their inputs and recompute p in the
backward, which returns (d_qkv, d_scale (H,), d_template), the last two
summed over the batch, as the JAX custom VJPs do:

- on a CUDA tensor the forward launches ``csrc/window_attention.cu`` and the
  backward ``csrc/window_attention_bwd.cu`` (built with nvcc at first use),
  or raise.  In bf16 (at a window of up to 256 keys: every banded call and
  a dense grid of up to 256 tokens) both run on the tensor cores, with
  split-bf16 products where the TPU kernel's operands are f32, and skip the
  16 x 16 template blocks that are all -1e30; in f32 (and bf16 at a larger
  dense grid) they keep exact FMA kernels;
- on a CPU tensor they run the plain versions beside them.  That is the
  only case the plain versions serve: nothing falls back from the device.

Launch counters (kernel launches, never plain calls): ``launches`` and
``banded_launches`` (one per forward), ``bwd_launches`` and
``banded_bwd_launches`` (one per backward); each call runs its source's
kernels in turn.

The layout arithmetic ``supports`` / ``supports_banded`` / ``_batch_group``
is the JAX module's TPU VMEM criterion, kept verbatim so that a model's
``'auto'`` picks the same formulation at the same geometry in both
packages.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from tpat_tpu_torch.ops import _build

LANES = 128
BLK = 128  # banded row/column chunk
_EPS = 1e-12  # F.normalize clamp floor
_NEG = -1e30  # cross-window exclusion (exp underflows to exact 0 in f32)

HEAD_DIMS = (32,)  # the kernels' instantiations: the MAE decoder's 512 / 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
banded_launches = 0
bwd_launches = 0
banded_bwd_launches = 0


# ---------------------------------------------------------------------------
# Geometry (numpy; ``pallas_window_attention.py:64-219``)
# ---------------------------------------------------------------------------


def _fixed_bytes(n: int, hpb: int, n_tmpl_blocks: int) -> int:
    """VMEM held regardless of batch group: the (hpb, n, n) f32 template
    slab(s) plus ~6 (n, n) f32 softmax/backward temporaries."""
    return n_tmpl_blocks * hpb * n * n * 4 + 6 * n * n * 4


def _batch_group(
    b: int, n: int, hpb: int, itemsize: int, n_io: int, n_tmpl: int,
    cap: int = 8,
) -> int:
    """Largest divisor of b whose double-buffered (g, n, 128) io blocks fit
    beside the fixed-resident slabs, within a ~13 MB budget."""
    budget = 13 * 1024 * 1024 - _fixed_bytes(n, hpb, n_tmpl)
    for g in range(min(cap, b), 0, -1):
        if b % g != 0:
            continue
        if n_io * g * n * LANES * itemsize * 2 <= budget:
            return g
    return 0


def supports(
    num_heads: int, head_dim: int, tokens: int, itemsize: int = 2
) -> bool:
    """Whether ``'auto'`` takes the dense formulation: the JAX package's
    packed-layout and VMEM criterion (its backward at g = 1 with two
    template slabs), kept as is so both packages pick alike."""
    if LANES % head_dim != 0 or (num_heads * head_dim) % LANES != 0:
        return False
    hpb = LANES // head_dim
    budget = 13 * 1024 * 1024 - _fixed_bytes(tokens, hpb, n_tmpl_blocks=2)
    return budget >= 7 * tokens * LANES * itemsize * 2


def supports_banded(
    num_heads: int,
    head_dim: int,
    tokens: int,
    window_tokens: int,
    itemsize: int = 2,
) -> bool:
    """Feasibility of the window-order block-diagonal formulation: the
    packed-lane layout (as ``supports``), tokens a multiple of the 128-row
    chunk, and whole windows per chunk."""
    if LANES % head_dim != 0 or (num_heads * head_dim) % LANES != 0:
        return False
    return tokens % BLK == 0 and BLK % window_tokens == 0


def _window_coords(
    feat_size: Tuple[int, int],
    window: Tuple[int, int],
    shift: Tuple[int, int],
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-token ``(window id, within-window position)`` of the rolled grid,
    flattened to (N,) in original token order.  ``roll(x, (-st, -sf))`` puts
    token (t, f) at (t - st mod T, f - sf mod F)."""
    t, f = feat_size
    wh, ww = window
    st, sf = shift
    tt, ff = np.meshgrid(np.arange(t), np.arange(f), indexing="ij")
    a = (tt - st) % t
    b = (ff - sf) % f
    win = (a // wh) * (f // ww) + b // ww
    pos = (a % wh) * ww + b % ww
    return win.reshape(t * f), pos.reshape(t * f)


def window_order(
    feat_size: Tuple[int, int],
    window: Tuple[int, int],
    shift: Tuple[int, int],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Static window-major token permutation of the (rolled) grid:
    ``(perm, inv_perm, wo_win, wo_pos)``.  ``perm[i]`` is the original index
    of the token at window-major slot ``i``; ``inv_perm`` undoes it;
    ``wo_win``/``wo_pos`` are the window id and within-window position at
    each slot."""
    n = feat_size[0] * feat_size[1]
    win, pos = _window_coords(feat_size, window, shift)
    perm = np.lexsort((pos, win))
    inv_perm = np.empty(n, np.int64)
    inv_perm[perm] = np.arange(n)
    return perm, inv_perm, win[perm], pos[perm]


def template_parts(
    feat_size: Tuple[int, int],
    window: Tuple[int, int],
    shift: Tuple[int, int],
    region_mask: Optional[np.ndarray],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The static parts of the dense template: the bias gather's row and
    column positions ((N, 1) and (1, N)) and the (N, N) f32 additive part
    (region mask inside a window, -1e30 across windows)."""
    n = feat_size[0] * feat_size[1]
    win, pos = _window_coords(feat_size, window, shift)
    allowed = win[:, None] == win[None, :]
    if region_mask is not None:
        rm = region_mask[win[:, None], pos[:, None], pos[None, :]]
    else:
        rm = np.zeros((n, n), np.float32)
    rm = np.where(allowed, rm, _NEG).astype(np.float32)
    return pos[:, None], pos[None, :], rm


def band_parts(
    feat_size: Tuple[int, int],
    window: Tuple[int, int],
    shift: Tuple[int, int],
    region_mask: Optional[np.ndarray],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The static parts of the band, in window-major order: ``(perm,
    inv_perm, row positions (N, 1), column positions (N, 128), additive
    part (N, 128) f32)``.  Band row i covers columns
    ``(i // 128) * 128 + [0, 128)``."""
    n = feat_size[0] * feat_size[1]
    perm, inv_perm, wo_win, wo_pos = window_order(feat_size, window, shift)
    cols = (np.arange(n)[:, None] // BLK) * BLK + np.arange(BLK)[None, :]
    allowed = wo_win[:, None] == wo_win[cols]
    if region_mask is not None:
        rm = region_mask[wo_win[:, None], wo_pos[:, None], wo_pos[cols]]
    else:
        rm = np.zeros((n, BLK), np.float32)
    rm = np.where(allowed, rm, _NEG).astype(np.float32)
    return perm, inv_perm, wo_pos[:, None], wo_pos[cols], rm


def gather_template(
    bias: torch.Tensor, rows, cols, additive
) -> torch.Tensor:
    """``bias[:, rows, cols] + additive``: the gather is a torch index, so
    autograd carries d(template) back onto the (H, L, L) bias."""
    dev = bias.device
    rows, cols, additive = (torch.as_tensor(a, device=dev)
                            for a in (rows, cols, additive))
    return bias[:, rows, cols] + additive[None]


def build_window_template(
    bias: torch.Tensor,
    feat_size: Tuple[int, int],
    window: Tuple[int, int],
    shift: Tuple[int, int],
    region_mask: Optional[np.ndarray],
) -> torch.Tensor:
    """(H, N, N) additive template in ORIGINAL token order from the (H, L, L)
    meta-MLP bias (L = window tokens)."""
    return gather_template(
        bias, *template_parts(feat_size, window, shift, region_mask)
    )


def build_band_template(
    bias: torch.Tensor,
    feat_size: Tuple[int, int],
    window: Tuple[int, int],
    shift: Tuple[int, int],
    region_mask: Optional[np.ndarray],
) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """(H, N, 128) band in WINDOW-MAJOR order, plus the (perm, inv_perm)
    pair the caller reorders tokens with."""
    perm, inv_perm, rows, cols, rm = band_parts(
        feat_size, window, shift, region_mask
    )
    return gather_template(bias, rows, cols, rm), perm, inv_perm


# ---------------------------------------------------------------------------
# Plain versions (the kernels' arithmetic in PyTorch)
# ---------------------------------------------------------------------------


def _check(qkv, scale, template, banded: bool):
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (B, N, 3C), got {tuple(qkv.shape)}")
    if qkv.dtype not in _DTYPES:
        raise TypeError(f"qkv must be float32 or bfloat16, got {qkv.dtype}")
    b, n, c3 = qkv.shape
    if scale.dim() != 1 or (c3 // 3) % scale.shape[0]:
        raise ValueError(
            f"scale must be (H,) with H dividing C = {c3 // 3}, got "
            f"{tuple(scale.shape)}"
        )
    h = scale.shape[0]
    want = (h, n, BLK if banded else n)
    if tuple(template.shape) != want:
        raise ValueError(
            f"{'band' if banded else 'template'} must be {want}, got "
            f"{tuple(template.shape)}"
        )
    if scale.dtype != torch.float32 or template.dtype != torch.float32:
        raise TypeError("scale and template must be float32")
    if banded and n % BLK:
        raise ValueError(f"the banded form needs N % {BLK} == 0, got N = {n}")


def _split(x: torch.Tensor, h: int, banded: bool) -> torch.Tensor:
    """(B, N, C) -> f32 (B, H, N, D), or (B, H, N/128, 128, D) when
    banded."""
    b, n, c = x.shape
    x = x.reshape(b, n, h, c // h).transpose(1, 2).float()
    return x.reshape(b, h, n // BLK, BLK, c // h) if banded else x


def _heads(qkv: torch.Tensor, h: int, banded: bool):
    return [_split(t, h, banded) for t in qkv.chunk(3, dim=-1)]


def _merge(x: torch.Tensor, dtype) -> torch.Tensor:
    """(B, H, N, D) or (B, H, N/128, 128, D) -> (B, N, C) in ``dtype``."""
    b, h = x.shape[:2]
    d = x.shape[-1]
    return x.reshape(b, h, -1, d).transpose(1, 2).reshape(b, -1, h * d).to(dtype)


def _bcast(scale: torch.Tensor, template: torch.Tensor, banded: bool):
    """The scale and the template shaped to broadcast against the logits."""
    h, n = template.shape[:2]
    if banded:
        return (scale.reshape(1, h, 1, 1, 1),
                template.reshape(1, h, n // BLK, BLK, BLK))
    return scale.reshape(1, h, 1, 1), template[None]


def _normalise(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x * rsqrt(max(sum x^2, 1e-24)), that factor), in f32."""
    f = torch.rsqrt(torch.clamp_min((x * x).sum(-1, keepdim=True), _EPS * _EPS))
    return x * f, f


def _probs(qkv, scale, template, banded):
    h = scale.shape[0]
    q, k, v = _heads(qkv, h, banded)
    qn, qs = _normalise(q)
    kn, ks = _normalise(k)
    cos = torch.matmul(qn, kn.transpose(-1, -2))
    s, t = _bcast(scale, template, banded)
    logits = cos * s + t
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return p, cos, (qn, qs, kn, ks, v), s


def _attention_plain(qkv, scale, template, banded):
    _check(qkv, scale, template, banded)
    p, _, (_, _, _, _, v), _ = _probs(qkv, scale, template, banded)
    p = p.to(qkv.dtype).float()  # rounded to v's type before p.v
    return _merge(torch.matmul(p, v), qkv.dtype)


def _bwd_plain(qkv, scale, template, d_out, banded):
    _check(qkv, scale, template, banded)
    dt = qkv.dtype
    h = scale.shape[0]
    p, cos, (qn, qs, kn, ks, v), s = _probs(qkv, scale, template, banded)
    do = _split(d_out, h, banded)
    dp = torch.matmul(do, v.transpose(-1, -2))
    dlog = p * (dp - (dp * p).sum(dim=-1, keepdim=True))  # stays f32
    dims = (0, 2, 3, 4) if banded else (0, 2, 3)
    d_scale = (dlog * cos).sum(dim=dims)
    d_template = dlog.sum(dim=0).reshape(template.shape)
    dcos = dlog * s
    dqn = torch.matmul(dcos, kn)
    dkn = torch.matmul(dcos.transpose(-1, -2), qn)
    # F.normalize VJP (|x| > eps branch): (g - x^ <x^, g>) / |x|
    dq = (dqn - qn * (dqn * qn).sum(-1, keepdim=True)) * qs
    dk = (dkn - kn * (dkn * kn).sum(-1, keepdim=True)) * ks
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), do)
    d_qkv = torch.cat([_merge(g, dt) for g in (dq, dk, dv)], dim=-1)
    return d_qkv, d_scale, d_template


def fused_window_attention_plain(qkv, scale, template) -> torch.Tensor:
    """The dense forward as the TPU kernel computes it
    (``pallas_window_attention.py:457-488``): q and k raised to f32 and
    normalised, p in f32, rounded to v's type before p.v, which accumulates
    in f32; the output in qkv's dtype."""
    return _attention_plain(qkv, scale, template, banded=False)


def fused_window_attention_banded_plain(qkv, scale, band) -> torch.Tensor:
    """The banded forward: the dense arithmetic on each 128-token chunk of
    the window-major order against its (H, 128, 128) slice of the band."""
    return _attention_plain(qkv, scale, band, banded=True)


def fused_window_attention_bwd_plain(qkv, scale, template, d_out):
    """The dense backward as ``_bwd_kernel`` (``:491-569``) computes it:
    p recomputed in f32; dp = dO.v^T from working-type inputs in f32;
    dlog = p (dp - sum dp p) kept in f32; dq, dk through f32 products and
    the F.normalize VJP; dv = round(p)^T.dO.  Returns (d_qkv in qkv's dtype,
    d_scale (H,) f32, d_template (H, N, N) f32), the last two summed over
    the batch."""
    return _bwd_plain(qkv, scale, template, d_out, banded=False)


def fused_window_attention_banded_bwd_plain(qkv, scale, band, d_out):
    """The banded backward (``_banded_bwd_kernel``, ``:222-303``): the dense
    backward chunk by chunk; d_scale also sums over the chunks, d_band is
    (H, N, 128)."""
    return _bwd_plain(qkv, scale, band, d_out, banded=True)


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("window_attention")
    fn = lib.tpat_window_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.tpat_window_attention_fwd_scratch_bytes.argtypes = [ctypes.c_int] * 4
    lib.tpat_window_attention_fwd_scratch_bytes.restype = ctypes.c_longlong
    return lib


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    lib = _build.load("window_attention_bwd")
    fn = lib.tpat_window_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.tpat_window_attention_bwd_partials.argtypes = [ctypes.c_int] * 4
    lib.tpat_window_attention_bwd_partials.restype = ctypes.c_int
    lib.tpat_window_attention_bwd_scratch_bytes.argtypes = [ctypes.c_int] * 5
    lib.tpat_window_attention_bwd_scratch_bytes.restype = ctypes.c_longlong
    return lib


def _check_device(qkv, scale, template, banded):
    if qkv.device.type != "cuda":
        raise ValueError(f"no window_attention kernel for device {qkv.device}")
    if scale.device != qkv.device or template.device != qkv.device:
        raise ValueError("scale and template must be on qkv's device")
    h = scale.shape[0]
    n = qkv.shape[1]
    d = qkv.shape[-1] // 3 // h
    # the banded kernel needs only whole 128-token chunks, whatever the
    # window
    ok = (supports_banded(h, d, n, BLK) if banded
          else supports(h, d, n, qkv.element_size()))
    if d not in HEAD_DIMS or not ok:
        form = "supports_banded" if banded else "supports"
        raise ValueError(
            f"window_attention kernels do not take num_heads={h}, "
            f"head_dim={d}, n={n}, {qkv.dtype} (head_dim must be one of "
            f"{HEAD_DIMS}, and the layout one that {form} accepts)"
        )
    for name, t in (("qkv", qkv), ("scale", scale), ("template", template)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _forward_kernel(qkv, scale, template, banded):
    """Launch the forward source: in bf16 the live-block map, then the
    tensor-core kernel; else the FMA kernel."""
    global launches, banded_launches
    _check_device(qkv, scale, template, banded)
    b, n, c3 = qkv.shape
    h = scale.shape[0]
    lib = _library()
    dtype = _DTYPES[qkv.dtype]
    out = torch.empty((b, n, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    scratch = torch.empty(
        lib.tpat_window_attention_fwd_scratch_bytes(n, h, dtype, int(banded)),
        dtype=torch.uint8, device=qkv.device)
    err = lib.tpat_window_attention_fwd(
        qkv.data_ptr(), scale.data_ptr(), template.data_ptr(),
        scratch.data_ptr(), out.data_ptr(), b, n, h, c3 // 3 // h, dtype,
        int(banded), _stream(qkv.device),
    )
    if err != 0:
        raise RuntimeError(
            f"window_attention kernel launch failed: CUDA error {err}"
        )
    if banded:
        banded_launches += 1
    else:
        launches += 1
    return out


def _backward_kernels(qkv, scale, template, d_out, banded):
    """Launch the backward source: in bf16 the tensor-core kernels (live
    blocks; dq, dk, dv and per-sample d_template and d_scale partials;
    the template sum), else the FMA kernels (rows, cols, template).  The
    d_scale partials are summed here."""
    global bwd_launches, banded_bwd_launches
    _check_device(qkv, scale, template, banded)
    b, n, c3 = qkv.shape
    h = scale.shape[0]
    if tuple(d_out.shape) != (b, n, c3 // 3) or d_out.dtype != qkv.dtype:
        raise ValueError(
            f"d_out must be {(b, n, c3 // 3)} {qkv.dtype}, got "
            f"{tuple(d_out.shape)} {d_out.dtype}"
        )
    if d_out.device != qkv.device:
        raise ValueError("d_out must be on qkv's device")
    d_out = d_out.contiguous()
    dev = qkv.device
    lib = _bwd_library()
    dtype = _DTYPES[qkv.dtype]
    parts = lib.tpat_window_attention_bwd_partials(b, n, int(banded), dtype)
    d_qkv = torch.empty_like(qkv)
    scratch = torch.empty(
        lib.tpat_window_attention_bwd_scratch_bytes(b, n, h, dtype,
                                                    int(banded)),
        dtype=torch.uint8, device=dev)
    d_template = torch.empty_like(template)
    ds_parts = torch.empty((h, parts), dtype=torch.float32, device=dev)
    err = lib.tpat_window_attention_bwd(
        qkv.data_ptr(), scale.data_ptr(), template.data_ptr(), d_out.data_ptr(),
        d_qkv.data_ptr(), scratch.data_ptr(), d_template.data_ptr(),
        ds_parts.data_ptr(), b, n, h, c3 // 3 // h, dtype, int(banded),
        _stream(dev),
    )
    if err != 0:
        raise RuntimeError(
            f"window_attention_bwd kernel launch failed: CUDA error {err}"
        )
    if banded:
        banded_bwd_launches += 1
    else:
        bwd_launches += 1
    return d_qkv, ds_parts.sum(dim=1), d_template


def window_attention_bwd(qkv, scale, template, d_out, banded: bool):
    """(d_qkv, d_scale, d_template) of either form: the backward kernels on
    a CUDA tensor, the plain version on a CPU tensor."""
    _check(qkv, scale, template, banded)
    if qkv.device.type == "cpu":
        return _bwd_plain(qkv, scale, template, d_out, banded)
    return _backward_kernels(qkv, scale, template, d_out, banded)


class _WindowAttention(torch.autograd.Function):
    """Forward kernel (or plain version on the CPU), saving its inputs; the
    backward recomputes p, as the JAX custom VJPs do."""

    @staticmethod
    def forward(ctx, qkv, scale, template, banded):
        ctx.save_for_backward(qkv, scale, template)
        ctx.banded = banded
        if qkv.device.type == "cpu":
            return _attention_plain(qkv, scale, template, banded)
        return _forward_kernel(qkv, scale, template, banded)

    @staticmethod
    def backward(ctx, d_out):
        qkv, scale, template = ctx.saved_tensors
        d_qkv, d_scale, d_template = window_attention_bwd(
            qkv, scale, template, d_out, ctx.banded
        )
        return d_qkv, d_scale, d_template, None


def fused_window_attention(qkv, scale, template) -> torch.Tensor:
    """Dense-masked fused cosine window attention.  qkv (B, N, 3C) in the
    grid's original order; scale (H,) f32; template (H, N, N) f32 from
    ``build_window_template``.  Returns (B, N, C)."""
    _check(qkv, scale, template, banded=False)
    return _WindowAttention.apply(qkv, scale, template, False)


def fused_window_attention_banded(qkv, scale, band) -> torch.Tensor:
    """Block-diagonal fused cosine window attention.  qkv (B, N, 3C) in
    WINDOW-MAJOR order (``qkv[:, perm]``); band (H, N, 128) f32 from
    ``build_band_template``.  Returns (B, N, C) in window-major order (the
    caller applies ``inv_perm``)."""
    _check(qkv, scale, band, banded=True)
    return _WindowAttention.apply(qkv, scale, band, True)
