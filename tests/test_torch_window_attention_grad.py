"""The algorithm of the bf16 window-attention backward kernels
(tpat_tpu_torch/csrc/window_attention_bwd.cu), which cannot run here, as a
PyTorch model held against ``jax.vjp`` of the JAX package's
``fused_window_attention`` and ``fused_window_attention_banded`` (their
Pallas kernels in interpret mode, as tests/test_window_attention.py runs
them).

The model follows the kernels step by step: per (sample, head, window
unit) the live map of 16 x 16 blocks, q and k normalised in f32 and split
into hi = bf16(x^) and lo = bf16(x^ - hi), cos, dq^ and dk^ as the three
bf16 products hi.hi + hi.lo + lo.hi (f32 sums of exact products), dp and dv
as single bf16 products, the stats sweep (m, l and D_run online over the
live key blocks) and then the gradient sweep (key block by key block, the
query blocks in the rotation the kernel's warps take), the per-sample
d_template and d_scale partials summed in batch order.  Inputs are bf16,
made with numpy from a seed; the tolerance is the chip check's
(``chip_smoke.GRAD_BF16_REL``): each output within 2e-2 of its largest
|entry|."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpat_tpu.models import mae as jmae
from tpat_tpu.ops import pallas_window_attention as jpwa

WINDOW = (4, 4)
HEADS, DIM = 4, 128  # head_dim 32, the kernels' one width
BLK = 16  # rows of a warp's block
CHUNK = 128  # the banded form's unit
GRAD_BF16_REL = 2e-2


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _split(x):
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def _normalise(x):
    f = torch.rsqrt(torch.clamp_min((x * x).sum(-1, keepdim=True), 1e-24))
    return x * f, f


def _live_map(tm):
    """(nb, nb) bool of one unit's (W, W) template: a block with an entry
    above -1e29, or any block of a query block that has a row with none."""
    w = tm.shape[0]
    nb = -(-w // BLK)
    live = torch.zeros(nb * BLK, nb * BLK, dtype=torch.bool)
    live[:w, :w] = tm > -1e29
    blocks = live.reshape(nb, BLK, nb, BLK).any(dim=3).any(dim=1)
    dead_row = torch.zeros(nb * BLK, dtype=torch.bool)
    dead_row[:w] = ~live[:w].any(dim=1)
    return blocks | dead_row.reshape(nb, BLK).any(dim=1)[:, None]


def _blocks(nb):
    return [slice(i * BLK, (i + 1) * BLK) for i in range(nb)]


def _stats(qh, ql, kh, kl, do, v, tm, ok, scale, live):
    """The stats sweep of one unit (rows padded to 16 nb), query block by
    query block over the live key blocks: the row max m, the sum l and
    D_run = sum exp(s - m) dp, online."""
    nb = live.shape[0]
    r = nb * BLK
    blk = _blocks(nb)
    m = torch.full((r,), -math.inf)
    l = torch.zeros(r)
    d_run = torch.zeros(r)
    for qb in range(nb):
        rows = blk[qb]
        for kb in range(nb):
            if not live[qb, kb]:
                continue
            keys = blk[kb]
            s = qh[rows] @ kh[keys].T + qh[rows] @ kl[keys].T + ql[rows] @ kh[keys].T
            dp = do[rows] @ v[keys].T
            lg = torch.where(ok[rows, keys], s * scale + tm[rows, keys], -math.inf)
            m_new = torch.maximum(m[rows], lg.amax(dim=1))
            alpha = torch.where(m_new == -math.inf, 1.0,
                                torch.exp(m[rows] - m_new))
            e = torch.where(lg == -math.inf, 0.0, torch.exp(lg - m_new[:, None]))
            l[rows] = l[rows] * alpha + e.sum(dim=1)
            d_run[rows] = d_run[rows] * alpha + (e * dp).sum(dim=1)
            m[rows] = m_new
    return m, l, d_run


def _unit(q, k, v, do, tm, scale, live):
    """One CTA: (dq, dk, dv) of the unit's W rows (f32, before the final
    rounding), its dlog partial (W, W) and its d_scale partial."""
    w, d = q.shape
    nb = live.shape[0]
    r = nb * BLK

    def pad(x):
        return torch.cat([x, x.new_zeros(r - w, *x.shape[1:])])

    q, k, v, do = (pad(x) for x in (q, k, v, do))
    tm = torch.nn.functional.pad(tm, (0, r - w, 0, r - w))
    ok = torch.zeros(r, r, dtype=torch.bool)
    ok[:w, :w] = True
    qn, qf = _normalise(q)
    kn, kf = _normalise(k)
    qh, ql = _split(qn)
    kh, kl = _split(kn)
    blk = _blocks(nb)

    # a. stats sweep, query block by query block
    m, l, d_run = _stats(qh, ql, kh, kl, do, v, tm, ok, scale, live)
    inv = 1.0 / l
    delta = d_run / l

    # b. gradient sweep: at step t the warp of key block kb takes query
    # block (kb + t) mod nb
    dq = torch.zeros(r, d)
    dk = torch.zeros(r, d)
    dv = torch.zeros(r, d)
    part = torch.zeros(r, r)
    ds = torch.zeros(())
    for t in range(nb):
        for kb in range(nb):
            qb = (kb + t) % nb
            if not live[qb, kb]:
                continue
            rows, keys = blk[qb], blk[kb]
            s = kh[keys] @ qh[rows].T + kh[keys] @ ql[rows].T + kl[keys] @ qh[rows].T
            dp = v[keys] @ do[rows].T
            okt = ok[rows, keys].T
            p = torch.where(okt, torch.exp(s * scale + tm[rows, keys].T
                                           - m[rows]) * inv[rows], 0.0)
            dl = torch.where(okt, p * (dp - delta[rows]), 0.0)
            part[rows, keys] = dl.T
            ds = ds + (dl * s).sum()
            gh, gl = _split(dl * scale)
            dv[keys] += _bf16(p) @ do[rows]
            dk[keys] += gh @ qh[rows] + gh @ ql[rows] + gl @ qh[rows]
            dq[rows] += gh.T @ kh[keys] + gh.T @ kl[keys] + gl.T @ kh[keys]

    def vjp(g, xh, xl, f):  # the F.normalize VJP
        x = xh + xl
        return (g - x * (x * g).sum(-1, keepdim=True)) * f

    return (vjp(dq, qh, ql, qf)[:w], vjp(dk, kh, kl, kf)[:w], dv[:w],
            part[:w, :w], ds)


def kernel_model(qkv, scale, tmpl, d_out, banded, skip=True):
    """(d_qkv bf16, d_scale, d_template) as the kernels compute them; with
    ``skip=False`` every block is treated as live."""
    b, n, c3 = qkv.shape
    h = scale.shape[0]
    d = c3 // 3 // h
    w = CHUNK if banded else n
    units = n // CHUNK if banded else 1
    q, k, v = (t.float().reshape(b, n, h, d) for t in qkv.chunk(3, dim=-1))
    do = d_out.float().reshape(b, n, h, d)
    grads = [torch.zeros(b, n, h, d) for _ in range(3)]
    parts = torch.zeros(b, h, n, w)
    ds_parts = torch.zeros(h, b * units)
    for hh in range(h):
        for u in range(units):
            rows = slice(u * w, (u + 1) * w)
            tm = tmpl[hh, rows]
            live = _live_map(tm)
            if not skip:
                live = torch.ones_like(live)
            for bb in range(b):
                dq, dk, dv, part, ds = _unit(
                    q[bb, rows, hh], k[bb, rows, hh], v[bb, rows, hh],
                    do[bb, rows, hh], tm, scale[hh], live)
                for g, x in zip(grads, (dq, dk, dv)):
                    g[bb, rows, hh] = x
                parts[bb, hh, rows] = part
                ds_parts[hh, bb * units + u] = ds
    d_template = torch.zeros(h, n, w)
    for bb in range(b):  # the template-sum kernel's batch order
        d_template += parts[bb]
    d_qkv = torch.cat([g.reshape(b, n, h * d) for g in grads], dim=-1)
    return d_qkv.to(torch.bfloat16), ds_parts.sum(dim=1), d_template


def _inputs(feat, shift, banded, seed, scale_value=None):
    """bf16 qkv and d_out, f32 scale and template of one decoder block at
    B = 2: the template of a random meta-MLP bias with the shift's region
    mask, gathered by the JAX template functions."""
    rng = np.random.default_rng(seed)
    n = feat[0] * feat[1]
    qkv = rng.normal(size=(2, n, 3 * DIM)).astype(np.float32)
    scale = np.exp(0.5 * rng.normal(size=(HEADS,)) + math.log(10.0)).astype(np.float32)
    if scale_value is not None:
        scale = np.full((HEADS,), scale_value, np.float32)
    bias = rng.normal(size=(HEADS, 16, 16)).astype(np.float32)
    mask = jmae._shift_attn_mask(feat, WINDOW, shift)
    if banded:
        tmpl, perm, _ = jpwa.build_band_template(
            jnp.asarray(bias), feat, WINDOW, shift, mask)
        qkv = qkv[:, perm]
    else:
        tmpl = jpwa.build_window_template(jnp.asarray(bias), feat, WINDOW, shift, mask)
    d_out = rng.normal(size=(2, n, DIM)).astype(np.float32)
    to_bf16 = lambda x: torch.from_numpy(x).bfloat16()  # noqa: E731
    return (to_bf16(qkv), torch.from_numpy(scale),
            torch.from_numpy(np.array(tmpl)), to_bf16(d_out))


def _jax_vjp(qkv, scale, tmpl, d_out, banded):
    fn = jpwa.fused_window_attention_banded if banded else jpwa.fused_window_attention
    _, vjp = jax.vjp(fn, jnp.asarray(qkv.float().numpy(), jnp.bfloat16),
                     jnp.asarray(scale.numpy()), jnp.asarray(tmpl.numpy()))
    return [np.asarray(g, np.float32)
            for g in vjp(jnp.asarray(d_out.float().numpy(), jnp.bfloat16))]


def _check(feat, shift, banded, seed, scale_value=None):
    args = _inputs(feat, shift, banded, seed, scale_value)
    d_qkv, d_scale, d_template = kernel_model(*args, banded)
    assert d_qkv.dtype == torch.bfloat16
    want = _jax_vjp(*args, banded)
    got = [x.float().numpy() for x in (*d_qkv.chunk(3, dim=-1), d_scale, d_template)]
    want = [*np.split(want[0], 3, axis=-1), want[1], want[2]]
    for name, g, w in zip(("d_q", "d_k", "d_v", "d_scale", "d_template"), got, want):
        assert np.isfinite(g).all(), name
        err = np.abs(g - w).max()
        assert err <= GRAD_BF16_REL * np.abs(w).max(), (name, err, np.abs(w).max())


@pytest.mark.parametrize("shift", [(0, 0), (2, 0)])
@pytest.mark.parametrize("feat", [(8, 8), (16, 8)])
def test_dense_kernel_model_matches_jax_vjp(feat, shift):
    """The dense form at N = 64 and 128 (4 and 8 blocks of 16)."""
    _check(feat, shift, banded=False, seed=feat[0] + shift[0])


@pytest.mark.parametrize("shift", [(0, 0), (2, 0)])
@pytest.mark.parametrize("feat", [(16, 8), (32, 8)])
def test_banded_kernel_model_matches_jax_vjp(feat, shift):
    """The banded form at one and two 128-token chunks."""
    _check(feat, shift, banded=True, seed=10 + feat[0] + shift[0])


@pytest.mark.parametrize("banded", [False, True])
def test_kernel_model_at_the_scale_clamp(banded):
    """Every scale at the clamp of 100, where a logit carries the cosine's
    error times 100: the split-bf16 cos keeps it within the limits."""
    _check((16, 8), (2, 0), banded, seed=21, scale_value=100.0)


@pytest.mark.parametrize("banded", [False, True])
def test_skipping_dead_blocks_keeps_the_bits(banded):
    """A 16 x 16 block whose template entries are all -1e30 adds exact
    zeros to every sum: the model with the skip equals the model over every
    block bit for bit, and the skip leaves at most 1 in 4 blocks (the grid's
    windows span two 16-token blocks at most, a chunk's exactly one)."""
    args = _inputs((16, 8), (2, 0), banded, seed=31)
    skip = kernel_model(*args, banded)
    full = kernel_model(*args, banded, skip=False)
    for a, b in zip(skip, full):
        assert torch.equal(a, b)
    tm = args[2][0, :CHUNK]
    live = _live_map(tm)
    assert live.float().mean() <= 0.25
    assert live.diagonal().all()
