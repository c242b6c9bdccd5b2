"""The port's kernel probes (tpat_tpu_torch.probes: P1 probe_attn_softmax,
P2 probe_attn_grouping, P3 probe_ln_matmul) against the Pallas probes in
``scripts/``, on the CPU.

The scripts are imported from ``scripts/`` as they are.  They pass no
``interpret=`` flag, so each test runs them with
``jax.experimental.pallas.pallas_call`` replaced by its interpret-mode
partial; the port's wrappers run their plain versions on CPU tensors."""

import functools
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from tpat_tpu_torch.probes import _bench
from tpat_tpu_torch.probes import probe_attn_grouping as p2
from tpat_tpu_torch.probes import probe_attn_softmax as p1
from tpat_tpu_torch.probes import probe_ln_matmul as p3

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "scripts")


@pytest.fixture(scope="module")
def scripts():
    """The three probe scripts as modules, loaded with scripts/ on sys.path
    (they import ``_bench`` from there)."""
    sys.path.insert(0, SCRIPTS)
    try:
        mods = {}
        for name in ("probe_attn_softmax", "probe_attn_grouping",
                     "probe_ln_matmul"):
            spec = importlib.util.spec_from_file_location(
                f"scripts_{name}", os.path.join(SCRIPTS, f"{name}.py"))
            mods[name] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mods[name])
        return mods
    finally:
        sys.path.remove(SCRIPTS)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _qkv(b, n, seed, dtype=jnp.float32):
    """The same packed qkv (B, N, 3 * 768) for both packages."""
    x = np.random.default_rng(seed).normal(size=(b, n, 3 * p1.C)).astype(np.float32)
    j = jnp.asarray(x).astype(dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32)))
    return j, t.to(torch.bfloat16) if dtype == jnp.bfloat16 else t


@pytest.mark.parametrize("variant", p1.VARIANTS)
def test_variant_attention_matches_script_f32(scripts, interpret, variant):
    """Each of the six variants at B=2, N=33, f32: out within atol 1e-5
    (sums over N keys in another order), or within 1e-5 of its largest
    |entry| for noexp and mmonly, whose outputs are not normalised (entries
    up to ~20); colsum within rtol 1e-3 / atol 1e-6 ('full': the kernel's
    unnormalised column sums; zeros otherwise)."""
    jq, tq = _qkv(2, 33, seed=1)
    want_out, want_col = scripts["probe_attn_softmax"].variant_attention(jq, variant)
    got_out, got_col = p1.variant_attention(tq, variant)
    assert got_out.shape == (2, 33, p1.C) and got_col.shape == (2, p1.H, 1, 33)
    want = np.asarray(want_out)
    atol = 1e-5 * (np.abs(want).max() if variant in ("noexp", "mmonly") else 1.0)
    np.testing.assert_allclose(got_out.numpy(), want, rtol=0, atol=atol)
    np.testing.assert_allclose(got_col.numpy(), np.asarray(want_col), rtol=1e-3,
                               atol=1e-6)
    assert (got_col.abs().sum() > 0) == (variant == "full")
    assert p1.launches == 0


@pytest.mark.parametrize("variant", p1.VARIANTS)
def test_variant_attention_matches_script_bf16(scripts, interpret, variant):
    """bf16 at B=2, N=33: out within 2e-2 of its largest |entry| (p rounded
    to bf16 before p.v in both; noexp and mmonly are not normalised), colsum
    within rtol 1e-3 / atol 1e-6 (from the f32 p in both)."""
    jq, tq = _qkv(2, 33, seed=2, dtype=jnp.bfloat16)
    want_out, want_col = scripts["probe_attn_softmax"].variant_attention(jq, variant)
    got_out, got_col = p1.variant_attention(tq, variant)
    assert got_out.dtype == torch.bfloat16
    want = np.asarray(want_out.astype(jnp.float32))
    assert np.abs(got_out.float().numpy() - want).max() <= 2e-2 * np.abs(want).max()
    np.testing.assert_allclose(got_col.numpy(), np.asarray(want_col), rtol=1e-3,
                               atol=1e-6)


@pytest.mark.parametrize("g,lanes", [(1, 128), (2, 128), (1, 256), (2, 256)])
def test_grouped_attention_matches_script(scripts, interpret, g, lanes):
    """The script's batch group and lane width against every Hopper
    geometry (query rows x heads per CTA), B=2, N=33, f32: atol 1e-5; the
    output does not depend on the geometry."""
    jq, tq = _qkv(2, 33, seed=3)
    want = np.asarray(scripts["probe_attn_grouping"].grouped_attention(jq, g, lanes))
    for rows in p2.ROWS:
        for heads in p2.HEADS:
            got = p2.grouped_attention(tq, rows, heads)
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert p2.launches == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_matmul_matches_script(scripts, interpret, dtype):
    """LN(x) rounded to x's dtype, then the product with w, at M=64, K=256,
    N=256 against the script's kernel at bm=32, bn=128: f32 within atol
    1e-5 (a sum over K in another order), bf16 within 2e-2 of the largest
    |entry| (one bf16 ulp of the output)."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    x, g, b, w = p3.inputs(4, 64, 256, 256, torch.float32, "cpu")
    jx, jw = (jnp.asarray(t.numpy()).astype(jdt) for t in (x, w))
    want = np.asarray(scripts["probe_ln_matmul"].ln_matmul(
        jx, jnp.asarray(g.numpy()), jnp.asarray(b.numpy()), jw, bm=32, bn=128
    ).astype(jnp.float32))
    got = p3.ln_matmul(x.to(tdt), g, b, w.to(tdt))
    assert got.dtype == tdt and got.shape == (64, 256)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    else:
        assert np.abs(got.float().numpy() - want).max() <= 2e-2 * np.abs(want).max()
    assert p3.launches == 0


def test_probe_wrappers_refuse_what_the_kernels_do_not_take():
    qkv = torch.zeros(1, 5, 3 * p1.C)
    with pytest.raises(ValueError, match="unknown variant"):
        p1.variant_attention(qkv, "softmax")
    with pytest.raises(ValueError, match="qkv must be"):
        p1.variant_attention(torch.zeros(1, 5, 384), "full")
    with pytest.raises(ValueError, match="device cpu"):
        p1._variant_kernel(qkv, "full")
    with pytest.raises(ValueError, match="no geometry"):
        p2.grouped_attention(qkv, rows=48)
    with pytest.raises(ValueError, match="no geometry"):
        p2.grouped_attention(qkv, heads=3)
    with pytest.raises(ValueError, match="device cpu"):
        p2._grouped_kernel(qkv.to(torch.bfloat16), 64, 1)
    x, g, b, w = p3.inputs(0, 8, 256, 16, torch.float32, "cpu")
    with pytest.raises(ValueError, match="w"):
        p3.ln_matmul(x, g, b, w.T.contiguous())
    with pytest.raises(TypeError, match="share"):
        p3.ln_matmul(x, g, b, w.to(torch.bfloat16))
    with pytest.raises(ValueError, match="device cpu"):
        p3._kernel(x, g, b, w)
    assert p1.launches == p2.launches == p3.launches == 0


def test_probe_constants_match_the_scripts(scripts):
    """The probes keep the scripts' shapes and variants."""
    s1, s2, s3 = (scripts[n] for n in ("probe_attn_softmax",
                                       "probe_attn_grouping", "probe_ln_matmul"))
    assert (p1.B, p1.C, p1.H, p1.D) == (s1.B, s1.C, s1.H, s1.D)
    assert (p2.B, p2.C, p2.H) == (s2.B, s2.C, s2.H)
    assert (p3.M, p3.K, p3.N, p3.EPS) == (s3.M, s3.K, s3.N, s3.EPS)
    assert p1.LOG2E == s1.LOG2E
    assert p1.logit_scale("exp2") == pytest.approx(s1.D ** -0.5 * s1.LOG2E, rel=1e-15)


def test_probe_mains_and_bench_need_a_card():
    """The probes time on the card: without one, each main() exits with a
    message and the harness refuses to time."""
    if torch.cuda.is_available():
        return
    for probe in (p1, p2, p3):
        with pytest.raises(SystemExit, match="CUDA"):
            probe.main(iters=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        _bench.Bench(iters=1)("null", lambda: None)
