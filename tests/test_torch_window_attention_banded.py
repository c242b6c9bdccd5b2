"""The algorithm of the bf16 banded window-attention kernels
(tpat_tpu_torch/csrc/window_attention_banded.cu), which cannot run here, as a
PyTorch model held against the JAX package's
``fused_window_attention_banded`` and its ``jax.vjp`` (the Pallas kernels in
interpret mode, as tests/test_window_attention.py runs them).

The model follows the kernels step by step, per (head, 128-token chunk):
- the live map as the warps build it from the band with ballots (lane l
  holds columns 4l .. 4l + 3 of each row): a 16 x 16 block is live when one
  of its entries is above -1e29, and a query block with a row that has no
  such entry is kept whole;
- the batch cut into slices of consecutive samples, each slice's samples
  taken in turns by the CTA's two groups of warps, each group in batch
  order;
- per sample q and k normalised in f32 and split into hi = bf16(x^) and lo
  = bf16(x^ - hi), cos, dq^ and dk^ as the three bf16 products hi.hi +
  hi.lo + lo.hi (f32 sums of exact products), dp and dv single bf16
  products, the row statistics online over the live key blocks (the same
  sweep in both directions), p normalised in f32 and rounded to bf16 before
  p.v and dv;
- backward: dq^ over each query block's live key blocks; dk^ and dv from
  the same (query-major) values transposed when every query block's one
  live block is its own, else from a key-major sweep;
- d_band per group over its samples, the groups' sums added in (slice,
  group) order on the live blocks (0 on the others); d_scale per CTA, the
  CTAs' partials summed.

Inputs are bf16, made with numpy from a seed; the tolerance is the chip
check's (``chip_smoke.BF16_TOL`` and ``GRAD_BF16_REL``): each output within
2e-2 of its largest |entry|."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_window_attention_grad import (
    BLK, CHUNK, DIM, HEADS, WINDOW, _bf16, _blocks, _live_map, _normalise,
    _split, _stats,
)
from tpat_tpu.models import mae as jmae
from tpat_tpu.ops import pallas_window_attention as jpwa

GROUPS = 2  # the CTA's groups of warps, on alternate samples of a slice
REL = 2e-2  # of each output's largest |entry|


def live_ballots(tm: torch.Tensor) -> torch.Tensor:
    """(8, 8) bool of one chunk's (128, 128) band as the warps build it: per
    row a ballot of the 32 lanes (4 columns each), OR-ed over the query
    block's rows; a row whose ballot is empty keeps its block whole."""
    lanes = (tm > -1e29).reshape(CHUNK, 32, 4).any(-1)
    rows = lanes.reshape(CHUNK // BLK, BLK, 32)
    blocks = rows.any(1).reshape(CHUNK // BLK, CHUNK // BLK, 4).any(-1)
    dead_row = ~rows.any(2)
    return blocks | dead_row.any(1)[:, None]


def runs(batch: int, slices: int):
    """(slice, [samples of group 0, of group 1]) in the kernels' order: the
    batch in ``slices`` runs of ceil(B / slices) consecutive samples, group
    g taking samples g, g + 2, ... of its run."""
    per = -(-batch // slices)
    assert (slices - 1) * per < batch, "a slice would be empty"
    for s in range(slices):
        b0 = s * per
        count = min(per, batch - b0)
        yield s, [[b0 + i for i in range(g, count, GROUPS)]
                  for g in range(GROUPS)]


def _heads(qkv, d_out=None):
    """(H, [q, k, v(, dO)] as f32 (B, N, H, 32))."""
    b, n, c3 = qkv.shape
    h = c3 // 3 // 32
    parts = [t.float().reshape(b, n, h, 32) for t in qkv.chunk(3, dim=-1)]
    if d_out is not None:
        parts.append(d_out.float().reshape(b, n, h, 32))
    return h, parts


def _split_rows(q, k):
    qh, ql = _split(_normalise(q)[0])
    kh, kl = _split(_normalise(k)[0])
    return qh, ql, kh, kl


def _cos(qh, ql, kh, kl):
    return qh @ kh.T + qh @ kl.T + ql @ kh.T


def forward_model(qkv, scale, band, slices=1, skip=True):
    """(out bf16, m, l) as the forward kernel computes them, m and l (B, H,
    N); with ``skip=False`` every block is treated as live."""
    b, n, _ = qkv.shape
    h, (q, k, v) = _heads(qkv)
    out = torch.zeros(b, n, h, 32)
    m_all = torch.zeros(b, h, n)
    l_all = torch.zeros(b, h, n)
    blk = _blocks(CHUNK // BLK)
    ok = torch.ones(CHUNK, CHUNK, dtype=torch.bool)
    for hh in range(h):
        for u in range(n // CHUNK):
            rows = slice(u * CHUNK, (u + 1) * CHUNK)
            tm = band[hh, rows]
            live = live_ballots(tm) if skip else torch.ones(8, 8, dtype=torch.bool)
            for _, groups in runs(b, slices):
                for samples in groups:
                    for bb in samples:
                        qh, ql, kh, kl = _split_rows(q[bb, rows, hh], k[bb, rows, hh])
                        vv = v[bb, rows, hh]
                        m, l, _ = _stats(qh, ql, kh, kl, torch.zeros_like(vv),
                                         vv, tm, ok, scale[hh], live)
                        inv = 1.0 / l
                        o = torch.zeros(CHUNK, 32)
                        for qb in range(8):
                            for kb in range(8):
                                if live[qb, kb]:
                                    r, c = blk[qb], blk[kb]
                                    lg = _cos(qh[r], ql[r], kh[c], kl[c]) * scale[hh] + tm[r, c]
                                    p = torch.exp(lg - m[r, None]) * inv[r, None]
                                    o[r] += _bf16(p) @ vv[c]
                        out[bb, rows, hh] = o
                        m_all[bb, hh, rows] = m
                        l_all[bb, hh, rows] = l
    return out.reshape(b, n, h * 32).to(torch.bfloat16), m_all, l_all


def _sample_bwd(q, k, v, do, tm, scale, live, diagonal, slab):
    """One sample of one chunk: (dq, dk, dv) f32 before the final rounding
    and its d_scale share; its dlog added to ``slab`` on the live blocks."""
    qh, ql, kh, kl = _split_rows(q, k)
    qf = _normalise(q)[1]
    kf = _normalise(k)[1]
    ok = torch.ones(CHUNK, CHUNK, dtype=torch.bool)
    m, l, d_run = _stats(qh, ql, kh, kl, do, v, tm, ok, scale, live)
    inv = 1.0 / l
    delta = d_run / l
    blk = _blocks(CHUNK // BLK)
    dq = torch.zeros(CHUNK, 32)
    dk = torch.zeros(CHUNK, 32)
    dv = torch.zeros(CHUNK, 32)
    ds = torch.zeros(())
    for qb in range(8):  # the rows sweep: warp on query block qb
        for kb in range(8):
            if not live[qb, kb]:
                continue
            r, c = blk[qb], blk[kb]
            cs = _cos(qh[r], ql[r], kh[c], kl[c])
            p = torch.exp(cs * scale + tm[r, c] - m[r, None]) * inv[r, None]
            dl = p * (do[r] @ v[c].T - delta[r, None])
            slab[r, c] += dl
            ds = ds + (dl * cs).sum()
            gh, gl = _split(dl * scale)
            dq[r] += gh @ kh[c] + gh @ kl[c] + gl @ kh[c]
            if diagonal:  # (qb, qb) only: the same values, transposed
                dv[c] += _bf16(p).T @ do[r]
                dk[c] += gh.T @ qh[r] + gh.T @ ql[r] + gl.T @ qh[r]
    if not diagonal:  # the keys sweep: warp on key block kb
        for kb in range(8):
            for qb in range(8):
                if not live[qb, kb]:
                    continue
                r, c = blk[qb], blk[kb]
                cst = kh[c] @ qh[r].T + kh[c] @ ql[r].T + kl[c] @ qh[r].T
                pt = torch.exp(cst * scale + tm[r, c].T - m[None, r]) * inv[None, r]
                gh, gl = _split(pt * (v[c] @ do[r].T - delta[None, r]) * scale)
                dv[c] += _bf16(pt) @ do[r]
                dk[c] += gh @ qh[r] + gh @ ql[r] + gl @ qh[r]

    def vjp(g, x, f):  # the F.normalize VJP, x^ = hi + lo
        xh, xl = _split(_normalise(x)[0])
        xn = xh + xl
        return (g - xn * (xn * g).sum(-1, keepdim=True)) * f

    return vjp(dq, q, qf), vjp(dk, k, kf), dv, ds


def backward_model(qkv, scale, band, d_out, slices=1, skip=True,
                   diagonal=None):
    """(d_qkv bf16, d_scale, d_band) as the backward kernel computes them.
    ``diagonal``: the CTA's choice of loop (None: as the kernel, when the
    live map is the identity); ``skip=False`` treats every block as live."""
    b, n, _ = qkv.shape
    h, (q, k, v, do) = _heads(qkv, d_out)
    grads = [torch.zeros(b, n, h, 32) for _ in range(3)]
    d_band = torch.zeros(h, n, CHUNK)
    d_scale = torch.zeros(h)
    for hh in range(h):
        for u in range(n // CHUNK):
            rows = slice(u * CHUNK, (u + 1) * CHUNK)
            tm = band[hh, rows]
            live = live_ballots(tm) if skip else torch.ones(8, 8, dtype=torch.bool)
            diag = (bool(torch.equal(live, torch.eye(8, dtype=torch.bool)))
                    if diagonal is None else diagonal)
            total = torch.zeros(CHUNK, CHUNK)
            for _, groups in runs(b, slices):
                ds_cta = torch.zeros(())
                for samples in groups:  # each group's slab and d_scale share
                    slab = torch.zeros(CHUNK, CHUNK)
                    ds_group = torch.zeros(())
                    for bb in samples:
                        out = _sample_bwd(q[bb, rows, hh], k[bb, rows, hh],
                                          v[bb, rows, hh], do[bb, rows, hh],
                                          tm, scale[hh], live, diag, slab)
                        for g, x in zip(grads, out[:3]):
                            g[bb, rows, hh] = x
                        ds_group = ds_group + out[3]
                    if samples:
                        total = total + slab
                    ds_cta = ds_cta + ds_group
                d_scale[hh] += ds_cta
            full = live.repeat_interleave(BLK, 0).repeat_interleave(BLK, 1)
            d_band[hh, rows] = torch.where(full, total, 0.0)
    d_qkv = torch.cat([g.reshape(b, n, h * 32) for g in grads], dim=-1)
    return d_qkv.to(torch.bfloat16), d_scale, d_band


def _inputs(batch, feat, shift, seed):
    """bf16 qkv (window-major) and d_out, f32 scale and band of one decoder
    block: the band of a random meta-MLP bias with the shift's region mask,
    gathered by the JAX package's ``build_band_template``."""
    rng = np.random.default_rng(seed)
    n = feat[0] * feat[1]
    qkv = rng.normal(size=(batch, n, 3 * DIM)).astype(np.float32)
    scale = np.exp(0.5 * rng.normal(size=(HEADS,)) + math.log(10.0)).astype(np.float32)
    bias = rng.normal(size=(HEADS, 16, 16)).astype(np.float32)
    mask = jmae._shift_attn_mask(feat, WINDOW, shift)
    band, perm, _ = jpwa.build_band_template(jnp.asarray(bias), feat, WINDOW,
                                             shift, mask)
    d_out = rng.normal(size=(batch, n, DIM)).astype(np.float32)
    return (torch.from_numpy(qkv[:, perm]).bfloat16(), torch.from_numpy(scale),
            torch.from_numpy(np.array(band)), torch.from_numpy(d_out).bfloat16())


def _jax(qkv, scale, band, d_out):
    """(out, d_qkv, d_scale, d_band) of the JAX package, f32 numpy."""
    out, vjp = jax.vjp(jpwa.fused_window_attention_banded,
                       jnp.asarray(qkv.float().numpy(), jnp.bfloat16),
                       jnp.asarray(scale.numpy()), jnp.asarray(band.numpy()))
    grads = vjp(jnp.asarray(d_out.float().numpy(), jnp.bfloat16))
    return [np.asarray(x, np.float32) for x in (out, *grads)]


def _within(name, got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    assert np.isfinite(got).all(), name
    err = np.abs(got - want).max()
    assert err <= REL * np.abs(want).max(), (name, err, np.abs(want).max())


def _check(args, slices_list=(1, 2)):
    want = _jax(*args)
    for slices in slices_list:
        out, _, _ = forward_model(*args[:3], slices=slices)
        assert out.dtype == torch.bfloat16
        _within(f"out S={slices}", out, want[0])
        d_qkv, d_scale, d_band = backward_model(*args, slices=slices)
        assert d_qkv.dtype == torch.bfloat16
        for name, g, w in zip(("d_q", "d_k", "d_v"), d_qkv.chunk(3, dim=-1),
                              np.split(want[1], 3, axis=-1)):
            _within(f"{name} S={slices}", g, w)
        _within(f"d_scale S={slices}", d_scale, want[2])
        _within(f"d_band S={slices}", d_band, want[3])


@pytest.mark.parametrize("shift", [(0, 0), (2, 0)])
@pytest.mark.parametrize("feat", [(16, 8), (32, 8)])
def test_banded_model_matches_jax(feat, shift):
    """One and two 128-token chunks at B = 3, one slice (group 0 takes
    samples 0 and 2, group 1 sample 1) and two (slices of 2 and 1): the
    forward, d_qkv, d_scale and d_band within 2e-2 of the largest entry."""
    _check(_inputs(3, feat, shift, seed=100 + feat[0] + shift[0]))


def test_a_row_with_no_live_entry():
    """A band row that is all -1e30: its query block is kept whole (8 live
    blocks, so the kernels take their general loops) and its p is uniform
    over the chunk, as in JAX."""
    args = list(_inputs(2, (16, 8), (2, 0), seed=131))
    args[2] = args[2].clone()
    args[2][:, 5] = -1e30
    live = live_ballots(args[2][0, :CHUNK])
    assert live[0].all() and live.sum() == 15
    _check(args)


def test_live_entries_off_the_diagonal_blocks():
    """Finite band entries in blocks away from each row's own window: more
    than one live block per query block and per key block, the key-major
    sweep of the general backward."""
    args = list(_inputs(2, (32, 8), (0, 0), seed=141))
    args[2] = args[2].clone()
    args[2][:, 3, 100:110] = 0.5
    args[2][:, 200, 0:20] = -0.25
    live = live_ballots(args[2][0, :CHUNK])
    assert live[0, 6] and not torch.equal(live, torch.eye(8, dtype=torch.bool))
    _check(args)


def test_live_ballots_are_the_block_rule():
    """The warps' ballots give the live map of the 16 x 16 block rule
    (``_live_map`` of the dense kernels' model) on the model's bands, one
    with a dead row and one with live entries off the diagonal; the model's
    chunks are the identity (each query block's own window)."""
    _, _, band, _ = _inputs(1, (32, 8), (2, 0), seed=151)
    for u in range(2):
        tm = band[1, u * CHUNK:(u + 1) * CHUNK]
        assert torch.equal(live_ballots(tm), torch.eye(8, dtype=torch.bool))
        for edit in ((5, slice(None), -1e30), (70, slice(30, 40), 0.0)):
            t = tm.clone()
            t[edit[0], edit[1]] = edit[2]
            assert torch.equal(live_ballots(t), _live_map(t))


def test_slices_and_groups_keep_d_qkv_bits():
    """d_qkv and out do not depend on how the batch is cut (each sample's
    own arithmetic), d_band and d_scale only through the order of their
    sums: bit for bit and within 1e-5 of the largest entry across 1, 2 and
    3 slices of B = 5."""
    args = _inputs(5, (16, 8), (2, 0), seed=161)
    outs = [forward_model(*args[:3], slices=s)[0] for s in (1, 2, 3)]
    bwds = [backward_model(*args, slices=s) for s in (1, 2, 3)]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    for g in bwds[1:]:
        assert torch.equal(g[0], bwds[0][0])
        for x, y in zip(g[1:], bwds[0][1:]):
            assert (x - y).abs().max() <= 1e-5 * y.abs().max()


def test_diagonal_loop_matches_the_general_loop():
    """On the model's chunks the kernel takes its diagonal loop (dk^ and dv
    from the rows sweep's values, transposed); the general loop's key-major
    sweep computes the same sums, and skipping the dead blocks adds only
    exact zeros: the three within 1e-6 of the largest entry."""
    args = _inputs(2, (16, 8), (0, 0), seed=171)
    diag = backward_model(*args)
    general = backward_model(*args, diagonal=False)
    every = backward_model(*args, skip=False)
    for other in (general, every):
        for x, y in zip(other, diag):
            assert (x.float() - y.float()).abs().max() <= 1e-6 * y.float().abs().max()


def test_forward_stats_equal_the_backward_stats():
    """The forward's m and l are the backward's stats sweep bit for bit
    (one code, online_block, in both kernels)."""
    qkv, scale, band, d_out = _inputs(2, (16, 8), (2, 0), seed=181)
    _, m, l = forward_model(qkv, scale, band, slices=2)
    h, (q, k, v, do) = _heads(qkv, d_out)
    ok = torch.ones(CHUNK, CHUNK, dtype=torch.bool)
    for hh in range(h):
        tm = band[hh]
        live = live_ballots(tm)
        for bb in range(2):
            qh, ql, kh, kl = _split_rows(q[bb, :, hh], k[bb, :, hh])
            mb, lb, _ = _stats(qh, ql, kh, kl, do[bb, :, hh], v[bb, :, hh],
                               tm, ok, scale[hh], live)
            assert torch.equal(m[bb, hh], mb) and torch.equal(l[bb, hh], lb)
