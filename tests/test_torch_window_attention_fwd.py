"""The algorithm of the bf16 window-attention forward kernel
(tpat_tpu_torch/csrc/window_attention.cu, the tensor-core kernel), which
cannot run here, as a PyTorch model held against the JAX package's
``fused_window_attention`` and ``fused_window_attention_banded`` (their
Pallas kernels in interpret mode, as tests/test_window_attention.py runs
them).

The model follows the kernel step by step: per (sample, head, window unit)
the live map of 16 x 16 template blocks, q and k normalised in f32 and split
into hi = bf16(x^) and lo = bf16(x^ - hi), cos as the three bf16 products
hi.hi + hi.lo + lo.hi (f32 sums of exact products), then two sweeps over the
live key blocks of each query block: m and l online, and p = exp(s - m) / l
normalised in f32 before it is rounded to bf16, out = round(p) . v.  The
helpers and inputs are the backward model's
(tests/test_torch_window_attention_grad.py); the tolerance is the chip
check's bf16 forward limit: the output within 2e-2 of its largest |entry|."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_window_attention_grad import (
    BLK, CHUNK, _bf16, _blocks, _inputs, _live_map, _normalise, _split, _stats,
)
from tpat_tpu.ops import pallas_window_attention as jpwa

FWD_BF16_REL = 2e-2


def _unit(q, k, v, tm, scale, live):
    """One CTA: the unit's W output rows (f32, before the final rounding)
    and the row statistics m and l (rows padded to 16 nb)."""
    w, d = q.shape
    nb = live.shape[0]
    r = nb * BLK

    def pad(x):
        return torch.cat([x, x.new_zeros(r - w, *x.shape[1:])])

    q, k, v = (pad(x) for x in (q, k, v))
    tm = torch.nn.functional.pad(tm, (0, r - w, 0, r - w))
    ok = torch.zeros(r, r, dtype=torch.bool)
    ok[:w, :w] = True
    qh, ql = _split(_normalise(q)[0])
    kh, kl = _split(_normalise(k)[0])
    blk = _blocks(nb)

    def logits(rows, keys):
        s = qh[rows] @ kh[keys].T + qh[rows] @ kl[keys].T + ql[rows] @ kh[keys].T
        return torch.where(ok[rows, keys], s * scale + tm[rows, keys], -math.inf)

    # a. m and l online, query block by query block
    m = torch.full((r,), -math.inf)
    l = torch.zeros(r)
    for qb in range(nb):
        rows = blk[qb]
        for kb in range(nb):
            if live[qb, kb]:
                lg = logits(rows, blk[kb])
                m_new = torch.maximum(m[rows], lg.amax(dim=1))
                alpha = torch.where(m_new == -math.inf, 1.0,
                                    torch.exp(m[rows] - m_new))
                e = torch.where(lg == -math.inf, 0.0,
                                torch.exp(lg - m_new[:, None]))
                l[rows] = l[rows] * alpha + e.sum(dim=1)
                m[rows] = m_new

    # b. out = round(p) . v, p normalised before it is rounded
    inv = 1.0 / l
    out = torch.zeros(r, d)
    for qb in range(nb):
        rows = blk[qb]
        for kb in range(nb):
            if live[qb, kb]:
                keys = blk[kb]
                p = torch.where(ok[rows, keys], torch.exp(
                    logits(rows, keys) - m[rows, None]) * inv[rows, None], 0.0)
                out[rows] += _bf16(p) @ v[keys]
    return out[:w], m[:w], l[:w]


def kernel_model(qkv, scale, tmpl, banded, skip=True):
    """(out bf16, m, l) as the kernel computes them, m and l (B, H, N); with
    ``skip=False`` every block is treated as live."""
    b, n, c3 = qkv.shape
    h = scale.shape[0]
    d = c3 // 3 // h
    w = CHUNK if banded else n
    q, k, v = (t.float().reshape(b, n, h, d) for t in qkv.chunk(3, dim=-1))
    out = torch.zeros(b, n, h, d)
    m = torch.zeros(b, h, n)
    l = torch.zeros(b, h, n)
    for hh in range(h):
        for u in range(n // w):
            rows = slice(u * w, (u + 1) * w)
            tm = tmpl[hh, rows]
            live = _live_map(tm)
            if not skip:
                live = torch.ones_like(live)
            for bb in range(b):
                o, mu, lu = _unit(q[bb, rows, hh], k[bb, rows, hh],
                                  v[bb, rows, hh], tm, scale[hh], live)
                out[bb, rows, hh] = o
                m[bb, hh, rows] = mu
                l[bb, hh, rows] = lu
    return out.reshape(b, n, h * d).to(torch.bfloat16), m, l


def _jax_forward(qkv, scale, tmpl, banded):
    fn = jpwa.fused_window_attention_banded if banded else jpwa.fused_window_attention
    out = fn(jnp.asarray(qkv.float().numpy(), jnp.bfloat16),
             jnp.asarray(scale.numpy()), jnp.asarray(tmpl.numpy()))
    return np.asarray(out, np.float32)


def _check(args, banded):
    qkv, scale, tmpl, _ = args
    out, _, _ = kernel_model(qkv, scale, tmpl, banded)
    assert out.dtype == torch.bfloat16
    got = out.float().numpy()
    want = _jax_forward(qkv, scale, tmpl, banded)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= FWD_BF16_REL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("shift", [(0, 0), (2, 0)])
@pytest.mark.parametrize("feat", [(8, 8), (16, 8)])
def test_dense_kernel_model_matches_jax(feat, shift):
    """The dense form at N = 64 and 128 (4 and 8 blocks of 16)."""
    _check(_inputs(feat, shift, False, seed=40 + feat[0] + shift[0]), False)


@pytest.mark.parametrize("shift", [(0, 0), (2, 0)])
@pytest.mark.parametrize("feat", [(16, 8), (32, 8)])
def test_banded_kernel_model_matches_jax(feat, shift):
    """The banded form at one and two 128-token chunks."""
    _check(_inputs(feat, shift, True, seed=50 + feat[0] + shift[0]), True)


@pytest.mark.parametrize("banded", [False, True])
def test_kernel_model_at_the_scale_clamp(banded):
    """Every scale at the clamp of 100, where a logit carries the cosine's
    error times 100: the split-bf16 cos keeps the output within the
    limit."""
    _check(_inputs((16, 8), (2, 0), banded, seed=61, scale_value=100.0), banded)


@pytest.mark.parametrize("banded", [False, True])
def test_a_row_with_no_live_entry_is_uniform(banded):
    """A template row that is all -1e30: its query block is kept whole and
    its p is uniform over the window, as in plain (and JAX)."""
    qkv, scale, tmpl, d_out = _inputs((16, 8), (2, 0), banded, seed=71)
    tmpl = tmpl.clone()
    tmpl[:, 5] = -1e30
    assert _live_map(tmpl[0, :CHUNK])[0].all()
    _check((qkv, scale, tmpl, d_out), banded)
    out, _, _ = kernel_model(qkv, scale, tmpl, banded)
    h = scale.shape[0]
    w = CHUNK if banded else qkv.shape[1]
    v = qkv.float().chunk(3, dim=-1)[2].reshape(2, -1, h, 32)[:, :w]
    p = _bf16(torch.full((w,), 1.0 / w))
    want = torch.einsum("k,bkhd->bhd", p, v).reshape(2, -1)
    assert torch.allclose(out[:, 5].float(), want, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("banded", [False, True])
def test_skipping_dead_blocks_keeps_the_bits(banded):
    """A 16 x 16 block whose template entries are all -1e30 has p = 0
    exactly: the model with the skip equals the model over every block bit
    for bit (out, m and l)."""
    qkv, scale, tmpl, _ = _inputs((16, 8), (2, 0), banded, seed=81)
    skip = kernel_model(qkv, scale, tmpl, banded)
    full = kernel_model(qkv, scale, tmpl, banded, skip=False)
    for a, b in zip(skip, full):
        assert torch.equal(a, b)


@pytest.mark.parametrize("banded", [False, True])
def test_forward_stats_equal_the_backward_stats(banded):
    """The forward's stats sweep and the backward's share one code on the
    card (online_block): the forward model's m and l equal the backward
    model's stats sweep bit for bit, so the recomputed backward sees the
    forward's softmax."""
    qkv, scale, tmpl, d_out = _inputs((16, 8), (0, 0), banded, seed=91)
    _, m, l = kernel_model(qkv, scale, tmpl, banded)
    b, n, c3 = qkv.shape
    h = scale.shape[0]
    w = CHUNK if banded else n
    q, k, v = (t.float().reshape(b, n, h, 32) for t in qkv.chunk(3, dim=-1))
    do = d_out.float().reshape(b, n, h, 32)
    for hh in range(h):
        for u in range(n // w):
            rows = slice(u * w, (u + 1) * w)
            tm = tmpl[hh, rows]
            live = _live_map(tm)
            for bb in range(b):
                qh, ql = _split(_normalise(q[bb, rows, hh])[0])
                kh, kl = _split(_normalise(k[bb, rows, hh])[0])
                ok = torch.ones(w, w, dtype=torch.bool)
                mb, lb, _ = _stats(qh, ql, kh, kl, do[bb, rows, hh],
                                   v[bb, rows, hh], tm, ok, scale[hh], live)
                assert torch.equal(m[bb, hh, rows], mb)
                assert torch.equal(l[bb, hh, rows], lb)
