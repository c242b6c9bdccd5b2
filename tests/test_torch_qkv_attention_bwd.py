"""The algorithm of the bf16 fused-attention backward kernels at head_dim 32
and 64 (tpat_tpu_torch/csrc/qkv_attention_bwd.cu, the wgmma bodies),
which cannot run here, as a PyTorch model held against ``jax.vjp`` of the
JAX package's ``fused_qkv_attention`` and ``fused_qkv_attention_prefix``
(their Pallas kernels in interpret mode, forward and backward).

The model takes what the forward saves (tests/test_torch_qkv_attention_fwd.py:
the bf16 output O and the row log-sum-exp L) and follows the two kernels:
  rows: delta = rowsum(dO * O) (bf16 values, f32 sum); with a score
    cotangent, the rows the score reads add sum_k p_k ds_k from one extra
    q.k^T sweep; then ONE sweep: s = q.k^T and dp = dO.v^T (the kernels'
    exact-product sums), p = 2^(s c - L log2 e) with no online statistics,
    dlog = p (dp + ds - delta) rounded to bf16, dq = dlog.k * D^-1/2;
  cols: s^T = k.q^T and dp^T = v.dO^T, the same products with the roles
    swapped, p^T and dlog^T from L and delta, dv = round(p)^T.dO and
    dk = dlog^T.q * D^-1/2.
The chip check's limit holds it: each gradient within 2e-2 of its largest
|entry|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_qkv_attention_fwd import (
    LOG2E, bf16, forward_model, heads, make_qkv, products, score_rows,
)
from tpat_tpu.ops import pallas_attention as jpa
from tpat_tpu_torch.ops import qkv_attention as qa

GRAD_BF16_REL = 2e-2


def backward_head(q, k, v, o, lse, do, ds, rows, kv):
    """One (sample, head) through the rows kernel, then the cols kernel:
    (dq, dk, dv) in f32 before their rounding."""
    n, d = q.shape
    scale = d ** -0.5
    c = scale * LOG2E
    l2 = lse * LOG2E
    valid = torch.arange(n) < kv
    # rows: delta from the saved output, then one sweep over the keys
    delta = (do * o).sum(dim=1)
    s = products(q, k)
    dp = products(do, v)
    p = torch.where(valid[None, :], torch.exp2(s * c - l2[:, None]), 0.0)
    if ds is not None:
        delta = delta + torch.where(rows, (p * ds[None, :]).sum(dim=1), 0.0)
        dp = dp + rows[:, None] * ds[None, :]
    dlog = bf16(p * (dp - delta[:, None]))
    dq = dlog @ k * scale
    # cols: the key tile as the A operand, L and delta per query column
    st = products(k, q)
    dpt = products(v, do)
    pt = torch.where(valid[:, None], torch.exp2(st * c - l2[None, :]), 0.0)
    if ds is not None:
        dpt = dpt + rows[None, :] * ds[:, None]
    dlogt = bf16(pt * (dpt - delta[None, :]))
    dk = dlogt @ q * scale
    dv = bf16(pt) @ do
    return dq, dk, dv


def backward_model(qkv, h, d_out, d_scores, mode, extra, kv=None):
    """The kernels' gradient (B, N, 3C) in bf16, from the forward model's
    saved output and L, and the wrapper's pre-scaled score cotangent."""
    b, n, c3 = qkv.shape
    kv_valid = n if kv is None else kv
    out, _, lse = forward_model(qkv, h, mode, extra, kv)
    q, k, v = heads(qkv, h)
    o = out.float().reshape(b, n, h, -1).transpose(1, 2)
    do = d_out.float().reshape(b, n, h, -1).transpose(1, 2)
    ds = qa._score_cotangent(d_scores, mode, h, n, extra, kv)
    rows = score_rows(n, mode, extra, kv_valid)
    grads = torch.zeros(3, b, h, n, c3 // 3 // h)
    for i in range(b):
        for j in range(h):
            got = backward_head(q[i, j], k[i, j], v[i, j], o[i, j], lse[i, j],
                                do[i, j], None if ds is None else ds[i], rows,
                                kv_valid)
            for part in range(3):
                grads[part, i, j] = got[part]
    return torch.cat([g.transpose(1, 2).reshape(b, n, c3 // 3) for g in grads],
                     dim=-1).to(torch.bfloat16)


def jax_fn(x, h, mode, extra, kv):
    if kv is None:
        return jpa.fused_qkv_attention(x, h, mode, extra)
    return jpa.fused_qkv_attention_prefix(x, jnp.asarray(kv), h, mode, extra)


# (H, D, N, mode, extra, kv_valid, with a score cotangent)
BWD_CASES = [
    (2, 64, 129, None, 1, None, False),
    (2, 64, 90, "patch_mean", 1, 50, True),
    (4, 32, 129, "cls", 2, None, True),
    (4, 32, 90, None, 1, 61, False),
    (2, 64, 17, "cls", 2, None, False),
    (4, 32, 33, "patch_mean", 1, 20, True),
]


@pytest.mark.parametrize("h,d,n,mode,extra,kv,has_ds", BWD_CASES)
def test_backward_model_matches_jax_vjp(h, d, n, mode, extra, kv, has_ds):
    """dq, dk and dv of the model within 2e-2 of the largest |entry| of
    jax.vjp's, in bf16, with and without a score cotangent (and in a score
    mode without one: L from the two-sweep forward): p from the saved L,
    delta from the saved bf16 output."""
    rng = np.random.default_rng(n + extra)
    qkv = make_qkv(1, n, h, d, seed=n + d)
    d_out = torch.from_numpy(
        rng.normal(size=(1, n, h * d)).astype(np.float32)).to(torch.bfloat16)
    d_scores = None
    if has_ds:
        d_scores = torch.from_numpy(
            (n * rng.normal(size=(1, n - extra))).astype(np.float32))
    got = backward_model(qkv, h, d_out, d_scores, mode, extra, kv)

    x = jnp.asarray(qkv.float().numpy()).astype(jnp.bfloat16)
    (_, jscores), vjp = jax.vjp(lambda y: jax_fn(y, h, mode, extra, kv), x)
    jds = None
    if jscores is not None:
        jds = jnp.zeros_like(jscores) if d_scores is None else jnp.asarray(
            d_scores.numpy())
    (want,) = vjp((jnp.asarray(d_out.float().numpy()).astype(jnp.bfloat16),
                   jds))
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    for part, g, w in zip("qkv", got.float().chunk(3, -1), want.chunk(3, -1)):
        err = (g - w).abs().max().item()
        assert err <= GRAD_BF16_REL * w.abs().max().item(), (part, err)
