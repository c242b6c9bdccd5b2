"""The algorithm of the bf16 attention-probe kernel
(tpat_tpu_torch/csrc/attn_probe.cu: B1's wgmma/TMA body under P1's six
softmax variants and P2's nine CTA geometries), which cannot run here, as a
PyTorch model held against the Pallas probe ``scripts/probe_attn_softmax.py``
in interpret mode (the fixtures of tests/test_torch_probes.py); its
'noscore' is what ``scripts/probe_attn_grouping.py`` computes at every
geometry.

The model is B1's (tests/test_torch_qkv_attention_fwd.py): its exact-product
logits (``products``), its 64-key tiles (``key_tiles``), round(p) . v in a
fixed order (``times_v``).  'noscore' and 'exp2' are B1's one sweep without
scores (``forward_head`` with mode None; exp2's scale arrives with log2 e
folded in, the same c at D = 64); 'full' is B1's two sweeps with
'patch_mean' scores at extra 1.  The cost-bound variants change only p:
'nomax' one sweep with p~ = 2^(s c) added to l and O / l at the end,
'mmonly' one sweep with p = s scale, 'noexp' p = s scale - m with the final
row max (the kernel's two sweeps).  The CTA walk: a consumer warpgroup
computes a 64-row query box (rows past N zero) against every key and the
CTA stores its own rows of it; 32-row CTAs take a 64-row box from their
first row and store half, 128-row CTAs two boxes; heads per CTA change
only the order of the heads.  'full' takes the whole heads at once (its
CTA is B1's, whose per-64-row column-sum partials ``forward_head``
models).
The tolerances are the chip check's: out within 2e-2 of its largest
|entry|, colsum rtol 1e-3 / atol 1e-6."""

import functools

import numpy as np
import pytest
import torch

from tests import test_torch_qkv_attention_fwd as b1
from tests.test_torch_probes import _qkv, interpret, scripts  # noqa: F401
from tpat_tpu_torch.ops import qkv_attention as qa
from tpat_tpu_torch.probes import probe_attn_grouping as p2
from tpat_tpu_torch.probes import probe_attn_softmax as p1

import jax.numpy as jnp

OUT_REL = 2e-2
WIDTHS = (33, 257)
BOX = b1.TILE  # query rows of a consumer warpgroup's wgmma


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The model runs thousands of tiny torch ops; beside the other test
    workers, intra-op threads only contend, so one thread for this module,
    restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def head_model(q, k, v, variant):
    """Every (sample, head) at once, query rows q (B, H, R, D) against all
    N keys: (out f32 before its rounding, the column sums (B, H, N) for
    'full', else None)."""
    n = k.shape[-2]
    if variant in ("noscore", "exp2"):
        return b1.forward_head(q, k, v, None, 1, n)[0], None
    if variant == "full":
        o, _, col = b1.forward_head(q, k, v, "patch_mean", 1, n)
        return o, col
    scale = p1.logit_scale(variant)
    s = b1.products(q, k)
    o = torch.zeros(q.shape)
    if variant == "nomax":
        c = scale * b1.LOG2E
        l = torch.zeros(q.shape[:-1])
        for keys in b1.key_tiles(n, n):
            p = torch.exp2(s[..., keys] * c)
            l = l + p.sum(dim=-1)
            o = o + b1.times_v(p, v[..., keys, :])
        return o * (1.0 / l)[..., None], None
    s = s * scale
    if variant == "noexp":
        s = s - s.amax(dim=-1, keepdim=True)  # the first sweep's final max
    for keys in b1.key_tiles(n, n):  # noexp, mmonly: p is s itself
        o = o + b1.times_v(s[..., keys], v[..., keys, :])
    return o, None


def kernel_model(qkv, variant, rows=64, heads=1):
    """(out (B, N, C) bf16, colsum (B, H, 1, N) f32) as the bf16 kernel
    computes them at CTAs of ``rows`` query rows and ``heads`` heads (which
    run one after the other: the model takes every head at once, since a
    head's rows never see another head's)."""
    b, n, _ = qkv.shape
    q, k, v = b1.heads(qkv, p1.H)
    if variant == "full":
        out, colsum = head_model(q, k, v, variant)
        colsum = colsum[:, :, None]
    else:
        out = torch.zeros(q.shape)
        colsum = torch.zeros(b, p1.H, 1, n)
        box = max(rows, BOX)
        for q0 in range(0, n, rows):
            # the warpgroups' 64-row boxes from the CTA's first row
            qb = torch.zeros(b, p1.H, box, p1.D)
            qb[:, :, :min(box, n - q0)] = q[:, :, q0:q0 + box]
            o = torch.cat([head_model(qb[:, :, g:g + BOX], k, v, variant)[0]
                           for g in range(0, box, BOX)], dim=2)
            kept = min(rows, n - q0)  # the CTA's rows, no others
            out[:, :, q0:q0 + kept] = o[:, :, :kept]
    return out.transpose(1, 2).reshape(b, n, p1.C).to(torch.bfloat16), colsum


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
    'exp2' gives 'noscore''s out bits, as the kernel does at D = 64."""
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
    if variant == "exp2":
        assert torch.equal(out, _model(n, "noscore")[0])


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("heads", p2.HEADS)
@pytest.mark.parametrize("rows", p2.ROWS)
def test_kernel_model_keeps_its_bits_at_every_geometry(rows, heads, n):
    """P2's geometry changes which rows share a warpgroup's box, how much of
    it a CTA stores and in what order the heads run, never a row's
    arithmetic: the 'noscore' model at ``rows`` query rows and ``heads``
    heads per CTA equals P1's geometry (64 rows, 1 head) bit for bit."""
    got = _model(n, "noscore", rows, heads)[0]
    assert torch.equal(got, _model(n, "noscore")[0])


@pytest.mark.parametrize("variant,mode", [("noscore", None),
                                          ("full", "patch_mean")])
def test_kernel_model_is_b1s_forward(variant, mode):
    """P1 'noscore' and 'full' are B1's bodies: the model's out equals the
    B1 model's ``forward_model`` (mode None; 'patch_mean' at extra 1) bit
    for bit at B = 2, N = 257, and 'full''s column sums, reduced as B1's
    wrapper reduces them, B1's scores."""
    _, tq = _qkv(2, 257, seed=20 + 257, dtype=jnp.bfloat16)
    out, col = _model(257, variant)
    want, scores, _ = b1.forward_model(tq, p1.H, mode, 1)
    assert torch.equal(out, want)
    if mode is not None:
        assert torch.equal(qa.reduce_scores(col[:, :, 0], mode, 257, 1),
                           scores)
