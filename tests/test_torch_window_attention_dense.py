"""The algorithm of the bf16 dense window-attention kernels
(tpat_tpu_torch/csrc/window_attention_dense.cu), which cannot run here, as a
PyTorch model held against the JAX package's ``fused_window_attention`` and
its ``jax.vjp`` (the Pallas kernels in interpret mode, as
tests/test_window_attention.py runs them).

The model follows the kernels step by step, per head, over the whole grid:
- the live map as the warps build it from the (N, N) template with ballots
  (each warp its query block's 16 rows, 128 columns at a time, lane l
  holding columns 4l .. 4l + 3): a 16 x 16 block is live when one of its
  entries is above -1e29, and a query block with a row that has no such
  entry is kept whole (on the card the CTAs of a head's cluster share the
  scan, each its query blocks: the same bits); the live blocks' compact
  slots in row-major order, the first 32 in shared memory;
- the batch cut into slices of consecutive samples, each slice's samples
  taken by its CTA in batch order (one group of warps, a warp per 16-row
  block);
- per sample q and k normalised in f32 and split into hi = bf16(x^) and lo
  = bf16(x^ - hi), cos, dq^ and dk^ as the three bf16 products hi.hi +
  hi.lo + lo.hi (f32 sums of exact products), dp and dv single bf16
  products, the row statistics online over the live key blocks in
  ascending order (the same sweep in both directions), p normalised in f32
  and rounded to bf16 before p.v and dv;
- backward: dq^ over each query block's live key blocks; dk^ and dv over
  each key block's live query blocks (a key-major sweep, from the rows'
  m, 1 / l and delta);
- d_template per slice over its samples, the slices' sums added in slice
  order on the live blocks (0 on the others); d_scale per CTA, the CTAs'
  partials summed.

Inputs are bf16, made with numpy from a seed; the tolerance is the chip
check's (``chip_smoke.BF16_TOL`` and ``GRAD_BF16_REL``): each output within
2e-2 of its largest |entry|."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_window_attention_banded import _cos, _heads, _split_rows
from tests.test_torch_window_attention_grad import (
    BLK, DIM, HEADS, WINDOW, _bf16, _blocks, _live_map, _normalise, _split,
    _stats,
)
from tpat_tpu.models import mae as jmae
from tpat_tpu.ops import pallas_window_attention as jpwa

SPAN = 128  # the columns of one ballot: 32 lanes x 4
SLOTS = 32  # live template blocks a head keeps in shared memory
REL = 2e-2  # of each output's largest |entry|


def live_ballots(tm: torch.Tensor) -> torch.Tensor:
    """(nb, nb) bool of one head's (N, N) template as the warps build it:
    per row and 128-column span a ballot of the 32 lanes (4 columns each,
    lanes past N holding nothing), OR-ed over the query block's rows; a
    row whose ballots are all empty keeps its query block whole."""
    n = tm.shape[0]
    nb = n // BLK
    live = tm > -1e29
    bits = torch.zeros(nb, nb, dtype=torch.bool)
    for sp in range(0, n, SPAN):
        span = live[:, sp:sp + SPAN]
        lanes = span.reshape(n, -1, 4).any(-1)  # (n, lanes)
        blocks = lanes.reshape(nb, BLK, -1, 4).any(-1).any(1)
        bits[:, sp // BLK:sp // BLK + blocks.shape[1]] = blocks
    rows_live = live.any(1).reshape(nb, BLK).all(1)
    return bits | ~rows_live[:, None]


def slots(live: torch.Tensor) -> torch.Tensor:
    """Each live block's compact slot, row-major (-1 on dead blocks): the
    slot of its d_template sums in a CTA's slab, and of its template
    entries in shared memory when under SLOTS."""
    idx = torch.full(live.shape, -1, dtype=torch.long)
    idx[live] = torch.arange(int(live.sum()))
    return idx


def runs(batch: int, slices: int):
    """(slice, samples) in the kernels' order: the batch in ``slices`` runs
    of ceil(B / slices) consecutive samples, each taken in batch order."""
    per = -(-batch // slices)
    assert (slices - 1) * per < batch, "a slice would be empty"
    for s in range(slices):
        yield s, list(range(s * per, min(batch, (s + 1) * per)))


def _live(tm, skip):
    nb = tm.shape[0] // BLK
    return live_ballots(tm) if skip else torch.ones(nb, nb, dtype=torch.bool)


def forward_model(qkv, scale, tmpl, slices=1, skip=True):
    """(out bf16, m, l) as the forward kernel computes them, m and l (B, H,
    N); with ``skip=False`` every block is treated as live."""
    b, n, _ = qkv.shape
    h, (q, k, v) = _heads(qkv)
    nb = n // BLK
    blk = _blocks(nb)
    ok = torch.ones(n, n, dtype=torch.bool)
    out = torch.zeros(b, n, h, 32)
    m_all = torch.zeros(b, h, n)
    l_all = torch.zeros(b, h, n)
    for hh in range(h):
        tm = tmpl[hh]
        live = _live(tm, skip)
        for _, samples in runs(b, slices):
            for bb in samples:
                qh, ql, kh, kl = _split_rows(q[bb, :, hh], k[bb, :, hh])
                vv = v[bb, :, hh]
                m, l, _ = _stats(qh, ql, kh, kl, torch.zeros_like(vv), vv, tm,
                                 ok, scale[hh], live)
                inv = 1.0 / l
                o = torch.zeros(n, 32)
                for qb in range(nb):
                    for kb in range(nb):  # ascending; the first two kept
                        if live[qb, kb]:
                            r, c = blk[qb], blk[kb]
                            lg = _cos(qh[r], ql[r], kh[c], kl[c]) * scale[hh] + tm[r, c]
                            p = torch.exp(lg - m[r, None]) * inv[r, None]
                            o[r] += _bf16(p) @ vv[c]
                out[bb, :, hh] = o
                m_all[bb, hh] = m
                l_all[bb, hh] = l
    return out.reshape(b, n, h * 32).to(torch.bfloat16), m_all, l_all


def _sample_bwd(q, k, v, do, tm, scale, live, slab):
    """One sample of one head: (dq, dk, dv) f32 before the final rounding
    and its d_scale share; its dlog added to ``slab`` on the live blocks."""
    n = q.shape[0]
    nb = n // BLK
    blk = _blocks(nb)
    qh, ql, kh, kl = _split_rows(q, k)
    qf = _normalise(q)[1]
    kf = _normalise(k)[1]
    ok = torch.ones(n, n, dtype=torch.bool)
    m, l, d_run = _stats(qh, ql, kh, kl, do, v, tm, ok, scale, live)
    inv = 1.0 / l
    delta = d_run / l
    dq = torch.zeros(n, 32)
    dk = torch.zeros(n, 32)
    dv = torch.zeros(n, 32)
    ds = torch.zeros(())
    for qb in range(nb):  # a. warp on query block qb
        for kb in range(nb):
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
    for kb in range(nb):  # b. warp on key block kb
        for qb in range(nb):
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


def backward_model(qkv, scale, tmpl, d_out, slices=1, skip=True):
    """(d_qkv bf16, d_scale, d_template) as the backward kernel computes
    them; ``skip=False`` treats every block as live."""
    b, n, _ = qkv.shape
    h, (q, k, v, do) = _heads(qkv, d_out)
    nb = n // BLK
    grads = [torch.zeros(b, n, h, 32) for _ in range(3)]
    d_tmpl = torch.zeros(h, n, n)
    d_scale = torch.zeros(h)
    for hh in range(h):
        tm = tmpl[hh]
        live = _live(tm, skip)
        total = torch.zeros(n, n)
        for _, samples in runs(b, slices):  # a CTA: its slab, its d_scale
            slab = torch.zeros(n, n)
            ds_cta = torch.zeros(())
            for bb in samples:
                out = _sample_bwd(q[bb, :, hh], k[bb, :, hh], v[bb, :, hh],
                                  do[bb, :, hh], tm, scale[hh], live, slab)
                for g, x in zip(grads, out[:3]):
                    g[bb, :, hh] = x
                ds_cta = ds_cta + out[3]
            total = total + slab  # the last CTA: slice order
            d_scale[hh] += ds_cta
        full = live.repeat_interleave(BLK, 0).repeat_interleave(BLK, 1)
        d_tmpl[hh] = torch.where(full, total, 0.0)
    d_qkv = torch.cat([g.reshape(b, n, h * 32) for g in grads], dim=-1)
    return d_qkv.to(torch.bfloat16), d_scale, d_tmpl


def _inputs(batch, feat, shift, seed, scale_value=None):
    """bf16 qkv (the grid's original order) and d_out, f32 scale and
    template of one decoder block: the template of a random meta-MLP bias
    with the shift's region mask, gathered by the JAX package's
    ``build_window_template``."""
    rng = np.random.default_rng(seed)
    n = feat[0] * feat[1]
    qkv = rng.normal(size=(batch, n, 3 * DIM)).astype(np.float32)
    scale = np.exp(0.5 * rng.normal(size=(HEADS,)) + math.log(10.0)).astype(np.float32)
    if scale_value is not None:
        scale = np.full((HEADS,), scale_value, np.float32)
    bias = rng.normal(size=(HEADS, 16, 16)).astype(np.float32)
    mask = jmae._shift_attn_mask(feat, WINDOW, shift)
    tmpl = jpwa.build_window_template(jnp.asarray(bias), feat, WINDOW, shift,
                                      mask)
    d_out = rng.normal(size=(batch, n, DIM)).astype(np.float32)
    return (torch.from_numpy(qkv).bfloat16(), torch.from_numpy(scale),
            torch.from_numpy(np.array(tmpl)), torch.from_numpy(d_out).bfloat16())


@jax.jit
def _jax_fn(qkv, scale, tmpl, d_out):
    out, vjp = jax.vjp(jpwa.fused_window_attention, qkv, scale, tmpl)
    return (out, *vjp(d_out))


def _jax(qkv, scale, tmpl, d_out):
    """(out, d_qkv, d_scale, d_template) of the JAX package, f32 numpy (one
    compile per shape: the file's cases share two)."""
    got = _jax_fn(jnp.asarray(qkv.float().numpy(), jnp.bfloat16),
                  jnp.asarray(scale.numpy()), jnp.asarray(tmpl.numpy()),
                  jnp.asarray(d_out.float().numpy(), jnp.bfloat16))
    return [np.asarray(x, np.float32) for x in got]


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
        d_qkv, d_scale, d_tmpl = backward_model(*args, slices=slices)
        assert d_qkv.dtype == torch.bfloat16
        for name, g, w in zip(("d_q", "d_k", "d_v"), d_qkv.chunk(3, dim=-1),
                              np.split(want[1], 3, axis=-1)):
            _within(f"{name} S={slices}", g, w)
        _within(f"d_scale S={slices}", d_scale, want[2])
        _within(f"d_template S={slices}", d_tmpl, want[3])


@pytest.mark.parametrize("shift", [(0, 0), (2, 0)])
@pytest.mark.parametrize("feat", [(16, 8), (32, 8)])
def test_dense_model_matches_jax(feat, shift):
    """N = 128 and 256 (the ESC-50 decoder grid) at B = 2, one slice (the
    CTA takes samples 0 and 1) and two: the forward, d_qkv, d_scale and
    d_template within 2e-2 of the largest entry."""
    _check(_inputs(2, feat, shift, seed=200 + feat[0] + shift[0]))


def test_a_row_with_no_live_entry():
    """A template row that is all -1e30: its query block is kept whole (16
    live blocks) and its p is uniform over the grid, as in JAX; the head's
    46 live blocks outrun the 32 slots of shared memory, so 14 are read
    from global memory."""
    args = list(_inputs(2, (32, 8), (2, 0), seed=231))
    args[2] = args[2].clone()
    args[2][:, 5] = -1e30
    live = live_ballots(args[2][0])
    assert live[0].all() and live.sum() == 46
    assert (slots(live) >= SLOTS).sum() == 14
    _check(args, slices_list=(2,))


def test_at_the_scale_clamp():
    """Every scale at the clamp of 100, where a logit carries the cosine's
    error times 100: the split-bf16 cos keeps every output within the
    limit."""
    _check(_inputs(2, (32, 8), (2, 0), seed=241, scale_value=100.0),
           slices_list=(1,))


@pytest.mark.parametrize("shift", [(0, 0), (2, 0)])
def test_live_ballots_are_the_block_rule(shift):
    """The warps' ballots give the live map of the 16 x 16 block rule
    (``_live_map``) on the model's templates, one with a dead row and one
    with live entries off the windows; the model's grids pair their query
    blocks (two live key blocks each, 32 of 256 at N = 256, all in shared
    memory), and N = 64 leaves the upper half of the lanes empty."""
    for feat in ((32, 8), (8, 8)):
        _, _, tmpl, _ = _inputs(1, feat, shift, seed=251)
        for hh in range(2):
            tm = tmpl[hh]
            live = live_ballots(tm)
            assert torch.equal(live, _live_map(tm))
            assert (live.sum(1) == 2).all() and torch.equal(live, live.T)
            assert int(live.sum()) <= SLOTS
            for edit in ((5, slice(None), -1e30), (70 % tm.shape[0],
                                                   slice(30, 40), 0.0)):
                t = tm.clone()
                t[edit[0], edit[1]] = edit[2]
                assert torch.equal(live_ballots(t), _live_map(t))


def test_slices_keep_d_qkv_bits():
    """out and d_qkv do not depend on how the batch is cut (each sample's
    own arithmetic), d_template and d_scale only through the order of their
    sums: bit for bit and within 1e-5 of the largest entry across 1, 2 and
    3 slices of B = 5."""
    args = _inputs(5, (16, 8), (2, 0), seed=261)
    outs = [forward_model(*args[:3], slices=s)[0] for s in (1, 2, 3)]
    bwds = [backward_model(*args, slices=s) for s in (1, 2, 3)]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    for g in bwds[1:]:
        assert torch.equal(g[0], bwds[0][0])
        for x, y in zip(g[1:], bwds[0][1:]):
            assert (x - y).abs().max() <= 1e-5 * y.abs().max()


def test_skipping_dead_blocks_keeps_the_bits():
    """A block whose template entries are all -1e30 has p = 0 exactly and
    adds exact zeros to every sum: the model with the skip equals the model
    over every block bit for bit, forward (out, m, l) and backward."""
    args = _inputs(2, (8, 8), (2, 0), seed=271)
    for a, b in zip(forward_model(*args[:3]),
                    forward_model(*args[:3], skip=False)):
        assert torch.equal(a, b)
    for a, b in zip(backward_model(*args), backward_model(*args, skip=False)):
        assert torch.equal(a, b)

