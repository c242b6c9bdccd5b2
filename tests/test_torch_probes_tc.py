"""The algorithm of the bf16 attention-probe kernel
(tpat_tpu_torch/csrc/attn_probe.cu, B1's tensor-core body under P1's six
softmax variants and P2's nine CTA geometries), which cannot run here, as a
PyTorch model held against the Pallas probe ``scripts/probe_attn_softmax.py``
in interpret mode (the fixtures of tests/test_torch_probes.py); its
'noscore' is what ``scripts/probe_attn_grouping.py`` computes at every
geometry.

The model follows the kernel step by step: one CTA per (sample, group of
``heads`` heads, tile of ``rows`` query rows), one warp per 16 rows; keys in
64-key tiles of 16-key chunks, each logit the f32 sum of the four 16-wide
bf16 products in k-step order, times the scale; a first sweep keeping each
row's max and the denominator as four per-lane partials (the max and its
rescaling only where the variant keeps one, none at all for 'mmonly'); a
second sweep turning the logits into p, normalised in f32 and then rounded
to bf16, round(p) . v accumulated in f32; for 'full' the column sums of the
f32 p over query rows 1..N-1 per warp, then over the warps, per 64-row
q-tile, the tiles summed by the wrapper.  The tolerances are the chip
check's: out within 2e-2 of its largest |entry|, colsum rtol 1e-3 / atol
1e-6."""

import functools

import numpy as np
import pytest
import torch

from tests.test_torch_probes import _qkv, interpret, scripts  # noqa: F401
from tpat_tpu_torch.probes import probe_attn_grouping as p2
from tpat_tpu_torch.probes import probe_attn_softmax as p1

import jax.numpy as jnp

BK = 64  # keys per tile
CH = 16  # keys per chunk, and query rows per warp
OUT_REL = 2e-2
WIDTHS = (33, 257)
SWEEP1 = {"full", "noscore", "exp2", "noexp", "nomax"}  # not mmonly
HAS_MAX = {"full", "noscore", "exp2", "noexp"}
NORMALISED = {"full", "noscore", "exp2", "nomax"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The model runs thousands of tiny torch ops; beside the other test
    workers, intra-op threads only contend, so one thread for this module,
    restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _expo(x, variant):
    return torch.exp2(x) if variant == "exp2" else torch.exp(x)


def _logits(qw, kc, scale):
    """(B, W, 16, 16) logits of the warps' rows against one chunk of keys:
    the four k-step products summed in order, from zero, then scaled."""
    s = torch.zeros(qw.shape[:-1] + (CH,))
    for kk in range(0, p1.D, CH):
        s = s + qw[..., kk:kk + CH] @ kc[:, None, :, kk:kk + CH].transpose(-1, -2)
    return s * scale


def _lanes(x, j, e):
    """Columns 8 j + 2 t + e of a chunk, t = 0..3: what lane t of a quad
    holds in its register (j, e)."""
    return x[..., [8 * j + 2 * t + e for t in range(4)]]


def _head(q, k, v, q0, rows, variant):
    """One head of one CTA for every sample: q rows [q0, q0 + rows) (zero
    past N), all keys.  Returns (out (B, rows, D) f32, the tile's column
    sums (B, N) f32, zero unless 'full')."""
    b, n, d = k.shape
    w = rows // CH
    scale = p1.logit_scale(variant)
    qt = torch.zeros(b, rows, d)
    qt[:, :min(rows, n - q0)] = q[:, q0:q0 + rows]
    qw = qt.reshape(b, w, CH, d)
    row = q0 + torch.arange(rows).reshape(w, CH)
    score_row = ((row >= 1) & (row < n)).float()[None, :, :, None]
    chunks = [kb for k0 in range(0, n, BK) for kb in range(k0, min(k0 + BK, n), CH)]

    def chunk(kb):
        kc = torch.zeros(b, CH, d)
        kc[:, :min(CH, n - kb)] = k[:, kb:kb + CH]
        valid = (kb + torch.arange(CH)) < n
        return _logits(qw, kc, scale), valid

    m = torch.full((b, w, CH, 1), -torch.inf if variant in HAS_MAX else 0.0)
    lanes = torch.zeros(b, w, CH, 4)  # the per-lane partial denominators
    if variant in SWEEP1:
        for kb in chunks:
            s, valid = chunk(kb)
            if variant in HAS_MAX:
                m_new = torch.maximum(
                    m, torch.where(valid, s, -torch.inf).amax(-1, keepdim=True))
                if variant in NORMALISED:
                    lanes = lanes * _expo(m - m_new, variant)
                m = m_new
            if variant in NORMALISED:
                for j in range(2):
                    for e in range(2):
                        lanes = lanes + torch.where(
                            _lanes(valid, j, e),
                            _expo(_lanes(s, j, e) - m, variant), 0.0)
    inv = (1.0 / ((lanes[..., :1] + lanes[..., 1:2]) + (lanes[..., 2:3] + lanes[..., 3:]))
           if variant in NORMALISED else torch.ones(b, w, CH, 1))

    out = torch.zeros(b, w, CH, d)
    col = torch.zeros(b, n)
    for kb in chunks:
        s, valid = chunk(kb)
        if variant == "noexp":
            p = s - m
        elif variant == "mmonly":
            p = s
        else:
            p = _expo(s - m, variant) * inv
        p = torch.where(valid, p, 0.0)
        if variant == "full":
            per_warp = (p * score_row).sum(dim=2)  # (B, W, 16)
            tile = per_warp[:, 0]
            for ww in range(1, w):
                tile = tile + per_warp[:, ww]
            kn = min(CH, n - kb)
            col[:, kb:kb + kn] = tile[:, :kn]
        vc = torch.zeros(b, CH, d)
        vc[:, :min(CH, n - kb)] = v[:, kb:kb + CH]
        out = out + _bf16(p) @ vc[:, None]
    return out.reshape(b, rows, d), col


def kernel_model(qkv, variant, rows=64, heads=1):
    """(out (B, N, C) bf16, colsum (B, H, 1, N) f32) as the bf16 kernel
    computes them at query tiles of ``rows`` and ``heads`` heads per CTA."""
    b, n, _ = qkv.shape
    q, k, v = (t.float().reshape(b, n, p1.H, p1.D) for t in qkv.chunk(3, dim=-1))
    out = torch.zeros(b, n, p1.H, p1.D)
    n_qtiles = -(-n // rows)
    partial = torch.zeros(b, p1.H, n_qtiles, n)
    for h0 in range(0, p1.H, heads):
        for qt in range(n_qtiles):
            q0 = qt * rows
            for h in range(h0, h0 + heads):  # one after the other in the CTA
                o, col = _head(q[:, :, h], k[:, :, h], v[:, :, h], q0, rows,
                               variant)
                kept = min(rows, n - q0)
                out[:, q0:q0 + kept, h] = o[:, :kept]
                partial[:, h, qt] = col
    return (out.reshape(b, n, p1.C).to(torch.bfloat16),
            partial.sum(dim=2, keepdim=True))


@functools.cache
def _model(n, variant, rows=64, heads=1):
    """The model at B = 2 on the bf16 input of width n, computed once per
    process and geometry."""
    _, tq = _qkv(2, n, seed=20 + n, dtype=jnp.bfloat16)
    return kernel_model(tq, variant, rows, heads)


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("variant", p1.VARIANTS)
def test_kernel_model_matches_script(scripts, interpret, variant, n):  # noqa: F811
    """Each variant at B = 2, bf16: out within 2e-2 of the script's largest
    |entry|, colsum ('full'; zeros otherwise) within rtol 1e-3 / atol 1e-6.
    'full' gives 'noscore''s out bits, as the kernel gives B1's."""
    jq, _ = _qkv(2, n, seed=20 + n, dtype=jnp.bfloat16)
    want_out, want_col = scripts["probe_attn_softmax"].variant_attention(jq, variant)
    out, col = _model(n, variant)
    assert out.dtype == torch.bfloat16 and out.shape == (2, n, p1.C)
    got = out.float().numpy()
    want = np.asarray(want_out.astype(jnp.float32))
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= OUT_REL * np.abs(want).max(), (err, np.abs(want).max())
    np.testing.assert_allclose(col.numpy(), np.asarray(want_col), rtol=1e-3,
                               atol=1e-6)
    assert (col.abs().sum() > 0) == (variant == "full")
    if variant == "full":
        assert torch.equal(out, _model(n, "noscore")[0])


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("heads", p2.HEADS)
@pytest.mark.parametrize("rows", p2.ROWS)
def test_kernel_model_keeps_its_bits_at_every_geometry(rows, heads, n):
    """P2's geometry changes which warps share a CTA and in what order the
    heads run, never a row's arithmetic: the 'noscore' model at ``rows``
    query rows and ``heads`` heads per CTA equals P1's geometry (64 rows,
    1 head) bit for bit."""
    got = _model(n, "noscore", rows, heads)[0]
    assert torch.equal(got, _model(n, "noscore")[0])
