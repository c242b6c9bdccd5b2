"""The port's window attention (tpat_tpu_torch.ops.window_attention) against
the JAX package's, on the CPU.

Inputs are made with numpy from a seed and fed to both packages.  On CPU
tensors the port's wrappers run their plain forward and backward; the JAX
side runs its Pallas kernels in interpret mode (forward and custom VJP), as
tests/test_window_attention.py does.  f32 throughout: forward atol 1e-5,
the VJP (d_qkv, d_scale, d_template) rtol/atol 1e-4."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpat_tpu.models import mae as jmae
from tpat_tpu.ops import pallas_window_attention as jpwa
from tpat_tpu_torch.ops import window_attention as wa

WINDOW = (4, 4)


def _inputs(b, feat, heads, dim, shift, seed, banded):
    """qkv, scale and template (numpy f32) of one block's attention: a
    random meta-MLP bias gathered by the JAX template functions, with the
    shift's region mask."""
    rng = np.random.default_rng(seed)
    n = feat[0] * feat[1]
    qkv = rng.normal(size=(b, n, 3 * dim)).astype(np.float32)
    scale = np.exp(rng.normal(size=(heads,))).astype(np.float32)
    bias = rng.normal(size=(heads, 16, 16)).astype(np.float32)
    mask = jmae._shift_attn_mask(feat, WINDOW, shift)
    if banded:
        tmpl, perm, _ = jpwa.build_band_template(
            jnp.asarray(bias), feat, WINDOW, shift, mask)
        qkv = qkv[:, perm]
    else:
        tmpl = jpwa.build_window_template(
            jnp.asarray(bias), feat, WINDOW, shift, mask)
    d_out = rng.normal(size=(b, n, dim)).astype(np.float32)
    return qkv, scale, np.array(tmpl), d_out


def _check_against_jax(qkv, scale, tmpl, d_out, banded):
    jfn = jpwa.fused_window_attention_banded if banded else jpwa.fused_window_attention
    pfn = wa.fused_window_attention_banded if banded else wa.fused_window_attention
    jout, vjp = jax.vjp(jfn, jnp.asarray(qkv), jnp.asarray(scale),
                        jnp.asarray(tmpl))
    want = vjp(jnp.asarray(d_out))
    ts = [torch.from_numpy(a).requires_grad_() for a in (qkv, scale, tmpl)]
    out = pfn(*ts)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=0, atol=1e-5)
    got = torch.autograd.grad(out, ts, torch.from_numpy(d_out))
    for name, g, w in zip(("d_qkv", "d_scale", "d_template"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    assert wa.launches == wa.dense_launches == wa.banded_launches == 0
    assert wa.bwd_launches == wa.dense_bwd_launches == 0
    assert wa.banded_bwd_launches == 0


@pytest.mark.parametrize("shift", [(0, 0), (2, 0)])
def test_dense_forward_and_vjp_match_jax(shift):
    """Grid 8x8, dim 128, 4 heads (test_swin_block_* geometry)."""
    _check_against_jax(*_inputs(2, (8, 8), 4, 128, shift, 1, banded=False),
                       banded=False)


def test_dense_multi_laneblock_batch16_matches_jax():
    """dim 256 / 8 heads at batch 16 with shift (2, 2)
    (test_multi_laneblock_multi_group_gradients_match_xla geometry)."""
    _check_against_jax(*_inputs(16, (8, 8), 8, 256, (2, 2), 2, banded=False),
                       banded=False)


@pytest.mark.parametrize("feat", [(16, 8), (64, 8)])
@pytest.mark.parametrize("shift", [(0, 0), (2, 0)])
def test_banded_forward_and_vjp_match_jax(feat, shift):
    """The block-diagonal form at one and four 128-token chunks
    (test_banded_* geometry)."""
    _check_against_jax(*_inputs(2, feat, 4, 128, shift, 3, banded=True),
                       banded=True)


@pytest.mark.parametrize("feat", [(8, 8), (16, 8), (64, 8)])
@pytest.mark.parametrize("shift", [(0, 0), (2, 0), (2, 2)])
def test_template_and_band_equal_jax(feat, shift):
    """The numpy geometry and the bias gather give JAX's template and band
    exactly, and the same window-major permutation."""
    rng = np.random.default_rng(4)
    bias = rng.normal(size=(4, 16, 16)).astype(np.float32)
    mask = jmae._shift_attn_mask(feat, WINDOW, shift)
    got = wa.build_window_template(torch.from_numpy(bias), feat, WINDOW,
                                   shift, mask)
    want = jpwa.build_window_template(jnp.asarray(bias), feat, WINDOW, shift,
                                      mask)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for a, b in zip(wa.window_order(feat, WINDOW, shift),
                    jpwa.window_order(feat, WINDOW, shift)):
        np.testing.assert_array_equal(a, b)
    if feat[0] * feat[1] % wa.BLK:
        return  # the band needs whole 128-token chunks
    band, perm, inv = wa.build_band_template(torch.from_numpy(bias), feat,
                                             WINDOW, shift, mask)
    jband, jperm, jinv = jpwa.build_band_template(jnp.asarray(bias), feat,
                                                  WINDOW, shift, mask)
    np.testing.assert_array_equal(band.numpy(), np.asarray(jband))
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(inv, jinv)


def test_template_gradient_reaches_the_bias():
    """d(template) flows through the gather onto the (H, L, L) bias, as a
    scatter-add of every template entry that reads it."""
    bias = torch.zeros(1, 16, 16, requires_grad=True)
    t = wa.build_window_template(bias, (8, 8), WINDOW, (0, 0), None)
    in_window = (t > -1e29).float()
    (t * in_window).sum().backward()
    # each within-window (p_i, p_j) pair is read once per window: 4 windows
    assert torch.equal(bias.grad, torch.full((1, 16, 16), 4.0))


def test_window_order_roundtrip_and_exclusion():
    perm, inv_perm, wo_win, wo_pos = wa.window_order((8, 8), WINDOW, (2, 2))
    assert (perm[inv_perm] == np.arange(64)).all()
    assert (np.diff(wo_win) >= 0).all()
    assert (wo_pos.reshape(4, 16) == np.arange(16)).all()
    t = wa.build_window_template(torch.zeros(1, 16, 16), (8, 8), WINDOW,
                                 (0, 0), None)[0].numpy()
    assert t[0, 4] <= -1e29 and t[0, 1] == 0.0
    assert ((t > -1e29).sum(axis=1) == 16).all()


def test_supports_matches_jax():
    for h, d, n in ((16, 32, 256), (16, 32, 512), (16, 32, 448), (16, 80, 256),
                    (3, 32, 256), (8, 64, 512), (4, 32, 64)):
        for itemsize in (2, 4):
            assert wa.supports(h, d, n, itemsize) == jpwa.supports(h, d, n, itemsize)
            assert (wa.supports_banded(h, d, n, 16, itemsize)
                    == jpwa.supports_banded(h, d, n, 16, itemsize))
    assert wa._batch_group(1, 448, 4, 4, n_io=7, n_tmpl=2) == 0
    assert wa._batch_group(16, 64, 4, 4, 7, 2) == jpwa._batch_group(16, 64, 4, 4, 7, 2)


def test_wrappers_validate_before_dispatch():
    qkv = torch.zeros(1, 64, 384)
    with pytest.raises(ValueError, match="template must be"):
        wa.fused_window_attention(qkv, torch.ones(4), torch.zeros(4, 64, 32))
    with pytest.raises(ValueError, match="N % 128"):
        wa.fused_window_attention_banded(qkv, torch.ones(4),
                                         torch.zeros(4, 64, 128))
    with pytest.raises(TypeError, match="float32"):
        wa.fused_window_attention(qkv, torch.ones(4, dtype=torch.float64),
                                  torch.zeros(4, 64, 64))
    # a CPU tensor never reaches a kernel, and the kernel path refuses a
    # device other than CUDA
    with pytest.raises(ValueError, match="no window_attention kernel"):
        wa._forward_kernel(qkv, torch.ones(4), torch.zeros(4, 64, 64), False)
