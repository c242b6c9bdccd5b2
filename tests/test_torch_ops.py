"""The port's ops (tpat_tpu_torch.ops) against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and fed to both packages.  On a CPU
tensor the port's kernel wrapper runs its plain PyTorch version; the JAX
side runs its Pallas kernel in interpret mode (as test_pallas_attention
does)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpat_tpu.ops import fast_gelu as jgelu
from tpat_tpu.ops import pallas_attention as jpa
from tpat_tpu.ops import pruning as jpruning
from tpat_tpu_torch.ops import pruning
from tpat_tpu_torch.ops import qkv_attention as qa
from tpat_tpu_torch.ops.attention import attention_with_scores
from tpat_tpu_torch.ops.fast_gelu import gelu_poly


def _tied_scores(kind):
    rng = np.random.default_rng(3)
    if kind == "all_equal":
        return np.full((2, 23), 0.25, np.float32)
    if kind == "few_levels":  # many exact ties at a handful of values
        return rng.integers(0, 4, size=(3, 41)).astype(np.float32) / 4
    if kind == "near_tied":  # values one f32 ulp apart, interleaved
        base = np.float32(0.5)
        step = np.spacing(base)
        return (base + step * rng.integers(0, 3, size=(3, 37))).astype(np.float32)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["all_equal", "few_levels", "near_tied"])
def test_topk_select_tie_order_matches_jax(kind):
    """Descending, ties to the lower index: exactly jax.lax.top_k's order."""
    scores = _tied_scores(kind)
    for k in (1, 5, scores.shape[1]):
        got = pruning.topk_select(torch.from_numpy(scores), k).numpy()
        want = np.asarray(jpruning.topk_select(jnp.asarray(scores), k))
        np.testing.assert_array_equal(got, want)
    # and the contract itself: among equal scores, indices ascend
    idx = pruning.topk_select(torch.from_numpy(scores), scores.shape[1]).numpy()
    vals = np.take_along_axis(scores, idx, axis=1)
    assert (np.diff(vals, axis=1) <= 0).all()
    same = np.diff(vals, axis=1) == 0
    assert (np.diff(idx, axis=1)[same] > 0).all()


def test_gather_tokens_and_num_left_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 11, 8)).astype(np.float32)
    idx = rng.permutation(10)[:4][None].repeat(2, 0)
    for e in (1, 2):
        i = idx[:, :4] % (11 - e)
        got = pruning.gather_tokens(torch.from_numpy(x), torch.from_numpy(i), e)
        want = jpruning.gather_tokens(jnp.asarray(x), jnp.asarray(i), e)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    s = rng.normal(size=(2, 10)).astype(np.float32)
    np.testing.assert_array_equal(
        pruning.gather_scores(torch.from_numpy(s), torch.from_numpy(idx)).numpy(),
        np.asarray(jpruning.gather_scores(jnp.asarray(s), jnp.asarray(idx))),
    )
    for rate, p in ((0.7, 256), (0.7, 180), (0.7, 126), (0.5, 64), (1e-3, 5)):
        assert pruning.num_left_tokens(rate, p) == jpruning.num_left_tokens(rate, p)
    assert [pruning.num_left_tokens(0.7, p) for p in (256, 180, 126)] == [180, 126, 89]
    with pytest.raises(ValueError):
        pruning.num_left_tokens(0.0, 10)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_poly_matches_jax(dtype):
    """f32: same f32 ops, rtol 1e-6 (XLA may contract into FMAs); bf16: at
    most one bf16 ulp (2^-8 relative) where those f32 ulps round apart."""
    x = np.random.default_rng(0).normal(scale=3.0, size=(4096,)).astype(np.float32)
    x[:4] = (-9.0, -4.0, 4.0, 9.0)  # the clip points and beyond
    got = gelu_poly(torch.from_numpy(x).to(getattr(torch, dtype)))
    want = jgelu.gelu_poly(jnp.asarray(x, dtype))
    assert str(got.dtype) == f"torch.{dtype}"
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0**-8, atol=1e-6)


# (B, H, N, mode, extra): the small case of test_fused_matches_xla and the
# ViT-B widths (H=12, D=64) at the serving path's first and last width
ATTN_CASES = [
    (2, 2, 17, "patch_mean", 1),
    (2, 2, 17, "cls", 2),
    (2, 2, 17, None, 1),
    (1, 12, 257, "patch_mean", 1),
    (1, 12, 257, None, 1),
    (1, 12, 90, "patch_mean", 1),
    (1, 12, 90, "cls", 2),
]


@pytest.mark.parametrize("b,h,n,mode,extra", ATTN_CASES)
def test_fused_qkv_attention_matches_jax_kernel(b, h, n, mode, extra):
    """Port wrapper on a CPU tensor (plain version) vs the JAX Pallas kernel
    in interpret mode: f32 rtol 1e-5 / atol 1e-6, as test_fused_matches_xla."""
    qkv = np.random.default_rng(n + h).normal(size=(b, n, 3 * h * 64))
    qkv = qkv.astype(np.float32)
    before = qa.launches
    out, scores = qa.fused_qkv_attention(torch.from_numpy(qkv), h, mode, extra)
    jout, jscores = jpa.fused_qkv_attention(jnp.asarray(qkv), h, mode, extra)
    assert qa.launches == before == 0  # CPU tensors never launch the kernel
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)
    if mode is None:
        assert scores is None and jscores is None
    else:
        assert scores.shape == (b, n - extra) and scores.dtype == torch.float32
        np.testing.assert_allclose(
            scores.numpy(), np.asarray(jscores), rtol=1e-5, atol=1e-7
        )


def test_fused_qkv_attention_bf16_rounds_p_like_jax():
    """bf16: p is cast to bf16 before p.v in both; outputs within 2 bf16
    ulps (2^-7 relative), scores (from the f32 p) at rtol 1e-5."""
    qkv = np.random.default_rng(7).normal(size=(2, 33, 3 * 2 * 64)).astype(np.float32)
    t = torch.from_numpy(qkv).to(torch.bfloat16)
    out, scores = qa.fused_qkv_attention(t, 2, "patch_mean", 1)
    jout, jscores = jpa.fused_qkv_attention(
        jnp.asarray(qkv, jnp.bfloat16), 2, "patch_mean", 1
    )
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(jout, np.float32), rtol=2.0**-7, atol=1e-3
    )
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), rtol=1e-5, atol=1e-7)


def test_reduce_scores_matches_jax():
    colsum = np.random.default_rng(1).random((3, 4, 19)).astype(np.float32)
    for mode, extra in (("patch_mean", 1), ("cls", 2), (None, 1)):
        got = qa.reduce_scores(torch.from_numpy(colsum), mode, 19, extra)
        want = jpa._reduce_scores(jnp.asarray(colsum), mode, 19, extra)
        if mode is None:
            assert got is None and want is None
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_plain_matches_attention_with_scores_layout():
    """The packed (B, N, 3C) layout: section s at column s*C, head h at h*D."""
    b, n, h, d = 2, 9, 3, 64
    qkv = torch.from_numpy(
        np.random.default_rng(2).normal(size=(b, n, 3 * h * d)).astype(np.float32)
    )
    q, k, v = (qkv[..., s * h * d:(s + 1) * h * d].reshape(b, n, h, d).transpose(1, 2)
               for s in range(3))
    out, scores = attention_with_scores(
        q, k, v, num_extra_tokens=1, importance="patch_mean"
    )
    pout, pscores = qa.fused_qkv_attention_plain(qkv, h, "patch_mean", 1)
    torch.testing.assert_close(pout, out.transpose(1, 2).reshape(b, n, h * d))
    torch.testing.assert_close(pscores, scores)


def test_wrapper_validates_before_dispatch():
    qkv = torch.zeros(1, 5, 3 * 128)
    with pytest.raises(ValueError, match="num_heads"):
        qa.fused_qkv_attention(qkv, 3, None, 1)
    with pytest.raises(ValueError, match="mode"):
        qa.fused_qkv_attention(qkv, 2, "mean", 1)
    with pytest.raises(TypeError):
        qa.fused_qkv_attention(qkv.double(), 2, None, 1)
    with pytest.raises(ValueError, match="num_extra_tokens"):
        qa.fused_qkv_attention(qkv, 2, "patch_mean", 5)
    with pytest.raises(ValueError, match="importance"):
        attention_with_scores(
            qkv[..., :64].reshape(1, 1, 5, 64), qkv[..., :64].reshape(1, 1, 5, 64),
            qkv[..., :64].reshape(1, 1, 5, 64), num_extra_tokens=1,
            importance="mean", token_mask=torch.ones(1, 4, dtype=torch.bool),
        )
    for kv in (1, 6, 3.0):  # kv_valid must be an int in (extra, N]
        with pytest.raises(ValueError, match="kv_valid"):
            qa.fused_qkv_attention_prefix(qkv, kv, 2, "patch_mean", 1)
    assert qa.supports(12, 64, 257) and qa.supports(16, 80, 513)
    assert not qa.supports(4, 32, 17) and not qa.supports(12, 64, 0)
    assert qa.launches == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_alignment_predicate_refuses_offset_views(dtype):
    """The wrappers refuse a CUDA tensor that does not start on a 16-byte
    boundary (the bf16 kernels' cp.async and ldmatrix move 16 bytes a
    lane); the predicate is held here on CPU views whose offsets move the
    start by less than 16 bytes, and the CPU route does not consult it."""
    base = torch.zeros(4 * 5 * 3 * 128 + 16, dtype=dtype)
    assert qa.aligned16(base)
    step = base.element_size()
    for offset in range(1, 16 // step + 1):
        view = base[offset:offset + 5 * 3 * 128].view(1, 5, 3 * 128)
        assert view.is_contiguous()
        assert qa.aligned16(view) == (offset * step % 16 == 0)
    misaligned = base[1:1 + 5 * 3 * 128].view(1, 5, 3 * 128)
    out, _ = qa.fused_qkv_attention(misaligned, 2, None, 1)
    assert out.shape == (1, 5, 128) and qa.launches == 0
