"""The algorithm of the bf16 fused-attention forward kernel at head_dim 32
and 64 (tpat_tpu_torch/csrc/qkv_attention.cu, the wgmma body), which
cannot run here, as a PyTorch model held against the JAX package's
``fused_qkv_attention`` and ``fused_qkv_attention_prefix`` (their Pallas
kernels in interpret mode, as tests/test_pallas_attention.py runs them).

The model follows the kernel step by step, per (sample, head): the logits
as exact products of bf16 values summed in f32 over D in one fixed order,
scaled after the product by c = D^-1/2 log2 e; the keys walked in 64-key
tiles up to kv_valid (keys past it masked, tiles wholly past it skipped).
Without scores, ONE sweep: the row max m (of s c) grows per tile, l and
the output accumulator are multiplied by 2^(m_old - m_new), p~ = 2^(s c -
m) is added to l in f32 and, rounded to bf16, multiplies v; the
accumulator is divided by l at the end.  With 'patch_mean' or 'cls', two
sweeps: m and l, then the normalised f32 p, its column sums per 64-row
query tile, and round(p).v.  The row log-sum-exp L = (m + log2 l) ln 2,
which the backward reads.  Tolerances are the chip check's: the output
within 2e-2 of its largest |entry|, scores rtol 1e-3."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpat_tpu.ops import pallas_attention as jpa
from tpat_tpu_torch.ops import qkv_attention as qa

TILE = 64  # query rows per CTA and keys per streamed tile
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
OUT_BF16_REL = 2e-2
SCORE_RTOL, SCORE_ATOL = 1e-3, 1e-6


def bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16, held in f32."""
    return x.to(torch.bfloat16).float()


def products(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., R, D) . b (..., C, D)^T as the kernels take it: exact
    products of bf16 values (exact in f32), summed in f32 over D in one
    fixed order, so the transposed product (b, a) gives the same bits, and
    an entry's bits do not depend on the other rows or heads taken with
    it."""
    acc = torch.zeros(a.shape[:-1] + (b.shape[-2],))
    for d in range(a.shape[-1]):
        acc = acc + a[..., :, d, None] * b[..., None, :, d]
    return acc


def key_tiles(n: int, kv: int) -> list:
    """The 64-key tiles the kernels walk: those holding a key below
    kv_valid, the last one cut at N."""
    return [slice(k0, min(k0 + TILE, n)) for k0 in range(0, kv, TILE)]


def times_v(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """round(p) (..., R, K) . v (..., K, D): exact products of bf16 values
    summed in f32 over the keys in one fixed order (``products``)."""
    return products(bf16(p), v.transpose(-1, -2))


def score_rows(n: int, mode, extra: int, kv: int) -> torch.Tensor:
    """The query rows a score reads: [extra, kv_valid) for 'patch_mean',
    row 0 for 'cls'."""
    row = torch.arange(n)
    if mode == "patch_mean":
        return (row >= extra) & (row < kv)
    return row == 0


def heads(qkv: torch.Tensor, h: int):
    """(B, N, 3C) -> q, k, v as (B, H, N, D) f32 holding bf16 values."""
    b, n, c3 = qkv.shape
    return (t.reshape(b, n, h, c3 // 3 // h).transpose(1, 2).float()
            for t in qkv.chunk(3, dim=-1))


def forward_head(q, k, v, mode, extra, kv):
    """One CTA row block after another for every (sample, head) at once,
    query rows q (..., R, D) (the heads' rows from row 0 when they emit
    scores) against all N keys k, v (..., N, D): (out in f32 before its
    rounding, L, the column sums (..., N) of the normalised p over the score
    rows or None)."""
    nq, d = q.shape[-2:]
    n = k.shape[-2]
    c = d ** -0.5 * LOG2E
    s = products(q, k)
    s[..., kv:] = -math.inf
    tiles = key_tiles(n, kv)
    m = torch.full(s.shape[:-1], -math.inf)
    l = torch.zeros(s.shape[:-1])
    o = torch.zeros(s.shape[:-1] + (d,))
    for keys in tiles:
        st = s[..., keys]
        m_new = torch.maximum(m, st.amax(dim=-1) * c)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(st * c - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        if mode is None:
            o = o * alpha[..., None] + times_v(p, v[..., keys, :])
        m = m_new
    lse = (m + torch.log2(l)) * LN2
    if mode is None:
        return o * (1.0 / l)[..., None], lse, None
    inv = 1.0 / l
    rows = score_rows(nq, mode, extra, kv).float()[:, None]
    colsum = torch.zeros(s.shape[:-2] + (n,))
    for keys in tiles:
        p = torch.exp2(s[..., keys] * c - m[..., None]) * inv[..., None]
        # the partial sums of each 64-row query tile, then their sum
        colsum[..., keys] = sum(
            (p[..., r0:r0 + TILE, :] * rows[r0:r0 + TILE]).sum(-2)
            for r0 in range(0, nq, TILE))
        o = o + times_v(p, v[..., keys, :])
    return o, lse, colsum


def forward_model(qkv: torch.Tensor, h: int, mode, extra: int, kv=None):
    """The kernel's forward on bf16 qkv (B, N, 3C): (out bf16 (B, N, C),
    scores or None, L (B, H, N))."""
    b, n, c3 = qkv.shape
    q, k, v = heads(qkv, h)
    out, lse, colsum = forward_head(q, k, v, mode, extra,
                                    n if kv is None else kv)
    out = out.transpose(1, 2).reshape(b, n, c3 // 3).to(torch.bfloat16)
    return out, qa.reduce_scores(colsum, mode, n, extra, kv), lse


def make_qkv(b, n, h, d, seed):
    """Seeded (B, N, 3C) inputs as bf16, the same values for both packages."""
    x = np.random.default_rng(seed).normal(size=(b, n, 3 * h * d))
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


def jax_forward(qkv: torch.Tensor, h: int, mode, extra: int, kv=None):
    x = jnp.asarray(qkv.float().numpy()).astype(jnp.bfloat16)
    if kv is None:
        return jpa.fused_qkv_attention(x, h, mode, extra)
    return jpa.fused_qkv_attention_prefix(x, jnp.asarray(kv), h, mode, extra)


# (H, D, N, mode, extra, kv_valid): D 64 at H 2 and D 32 at H 4 (C = 128, the
# width the JAX packed kernel takes); N 257 and 129 hold one query row and
# one key past the last full tile, 90 and 17 ragged tiles; kv_valid the
# prefix form (a tile holding kv_valid, the tiles past it skipped)
FWD_CASES = [
    (2, 64, 257, None, 1, None),
    (2, 64, 257, "patch_mean", 1, None),
    (2, 64, 129, "cls", 2, None),
    (2, 64, 90, "patch_mean", 1, 50),
    (4, 32, 129, None, 1, None),
    (4, 32, 90, "patch_mean", 1, None),
    (4, 32, 17, "cls", 2, None),
    (4, 32, 129, "cls", 2, 70),
    (4, 32, 17, None, 1, 9),
]


@pytest.mark.parametrize("h,d,n,mode,extra,kv", FWD_CASES)
def test_forward_model_matches_jax(h, d, n, mode, extra, kv):
    """The model's bf16 output within 2e-2 of the largest |out| of the JAX
    kernel's, its scores within rtol 1e-3: the one-sweep rescale rounds p~
    <= 1 before p.v where JAX rounds the normalised p, inside the chip
    check's limits."""
    qkv = make_qkv(1, n, h, d, seed=n + d + extra)
    out, scores, _ = forward_model(qkv, h, mode, extra, kv)
    jout, jscores = jax_forward(qkv, h, mode, extra, kv)
    want = torch.from_numpy(np.array(jout.astype(jnp.float32)))
    err = (out.float() - want).abs().max().item()
    assert err <= OUT_BF16_REL * want.abs().max().item(), err
    if mode is None:
        assert scores is None and jscores is None
        return
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                               rtol=SCORE_RTOL, atol=SCORE_ATOL)


@pytest.mark.parametrize("h,d,n,kv", [(2, 64, 129, None), (4, 32, 90, 37)])
def test_forward_lse_is_the_row_logsumexp(h, d, n, kv):
    """L = (m + log2 l) ln 2 from the online m and l equals the float64
    log-sum-exp of the scaled logits over the valid keys."""
    qkv = make_qkv(1, n, h, d, seed=7)
    _, _, lse = forward_model(qkv, h, None, 1, kv)
    q, k, _ = heads(qkv, h)
    s = torch.einsum("bhnd,bhmd->bhnm", q.double(), k.double()) * d ** -0.5
    s[..., n if kv is None else kv:] = -math.inf
    want = torch.logsumexp(s, dim=-1)
    torch.testing.assert_close(lse.double(), want, rtol=0, atol=2e-5)
