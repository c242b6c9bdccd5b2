"""The port's prefix attention and attention backward
(tpat_tpu_torch.ops.qkv_attention) and the gelu_poly gradient against the
JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages.  On CPU
tensors the port's kernel wrappers run their plain versions (forward and
backward); the JAX side runs its Pallas kernels in interpret mode, forward
and backward (its custom VJPs), as test_pallas_attention does."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpat_tpu.ops import fast_gelu as jgelu
from tpat_tpu.ops import pallas_attention as jpa
from tpat_tpu_torch.ops import qkv_attention as qa
from tpat_tpu_torch.ops.fast_gelu import _DPHI_COEFFS, _PHI_COEFFS, gelu_poly

H, D = 2, 64  # C = 128: the JAX side takes its packed Pallas kernel
MODES = [(None, 1), ("patch_mean", 1), ("cls", 2)]


def _qkv(b, n, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, n, 3 * H * D)).astype(np.float32)


def _kv_values(n, extra):
    return (extra + 1, (extra + 1 + n) // 2, n)


# N = 65 is 1 mod 64: one query row and one key in the kernel's last tile
@pytest.mark.parametrize("n", [9, 17, 33, 65])
@pytest.mark.parametrize("mode,extra", MODES)
def test_prefix_forward_matches_jax_kernel(n, mode, extra):
    """fused_qkv_attention_prefix (CPU plain) vs the JAX prefix kernel at
    kv_valid in {extra+1, middle, N}: f32 out atol 1e-5, scores rtol 1e-3
    (the tolerances of the kernel-vs-plain check on the card)."""
    qkv = _qkv(2, n, n + extra)
    for kv in _kv_values(n, extra):
        out, scores = qa.fused_qkv_attention_prefix(
            torch.from_numpy(qkv), kv, H, mode, extra
        )
        jout, jscores = jpa.fused_qkv_attention_prefix(
            jnp.asarray(qkv), jnp.asarray(kv), H, mode, extra
        )
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=1e-5)
        if mode is None:
            assert scores is None and jscores is None
        else:
            assert scores.shape == (2, n - extra)
            np.testing.assert_allclose(
                scores.numpy(), np.asarray(jscores), rtol=1e-3, atol=1e-7
            )
    assert qa.launches == qa.prefix_launches == 0


def test_prefix_at_full_length_is_the_plain_form():
    qkv = torch.from_numpy(_qkv(2, 17, 5))
    for mode, extra in MODES:
        a = qa.fused_qkv_attention_prefix(qkv, 17, H, mode, extra)
        b = qa.fused_qkv_attention(qkv, H, mode, extra)
        torch.testing.assert_close(a[0], b[0], rtol=1e-6, atol=1e-6)
        if mode is not None:
            torch.testing.assert_close(a[1], b[1], rtol=1e-6, atol=1e-8)


def _jax_fn(kv, mode, extra):
    if kv is None:
        return lambda x: jpa.fused_qkv_attention(x, H, mode, extra)
    return lambda x: jpa.fused_qkv_attention_prefix(x, jnp.asarray(kv), H, mode, extra)


def _port_fn(kv, mode, extra):
    if kv is None:
        return lambda t: qa.fused_qkv_attention(t, H, mode, extra)
    return lambda t: qa.fused_qkv_attention_prefix(t, kv, H, mode, extra)


@pytest.mark.parametrize("prefix", [False, True])
@pytest.mark.parametrize("mode,extra", MODES)
def test_backward_matches_jax_vjp(prefix, mode, extra):
    """fused_qkv_attention_bwd_plain and autograd through the public
    functions vs jax.vjp of the JAX kernels (the Pallas backward), with and
    without a score cotangent: f32 rtol 1e-4 / atol 1e-6."""
    b, n = 2, 17
    kv = 11 if prefix else None
    rng = np.random.default_rng(3 + extra)
    qkv = _qkv(b, n, 11 + extra)
    d_out = rng.normal(size=(b, n, H * D)).astype(np.float32)
    d_scores = (n * rng.normal(size=(b, n - extra))).astype(np.float32)

    (jout, jscores), vjp = jax.vjp(_jax_fn(kv, mode, extra), jnp.asarray(qkv))
    cots = [None] if mode is None else [None, d_scores]
    for ds in cots:
        jds = None if jscores is None else jnp.asarray(
            ds if ds is not None else np.zeros_like(d_scores)
        )
        (want,) = vjp((jnp.asarray(d_out), jds))
        want = np.asarray(want)

        plain = qa.fused_qkv_attention_bwd_plain(
            torch.from_numpy(qkv), torch.from_numpy(d_out),
            None if ds is None else torch.from_numpy(ds), H, mode, extra, kv,
        )
        np.testing.assert_allclose(plain.numpy(), want, rtol=1e-4, atol=1e-6)

        t = torch.from_numpy(qkv).requires_grad_()
        out, scores = _port_fn(kv, mode, extra)(t)
        loss = (out * torch.from_numpy(d_out)).sum()
        if ds is not None:
            loss = loss + (scores * torch.from_numpy(ds)).sum()
        loss.backward()
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-4, atol=1e-6)
    assert qa.bwd_rows_launches == qa.bwd_cols_launches == 0


@pytest.mark.parametrize("kv", [None, 3, 12])
def test_fused_gradients_match_jax(kv):
    """Mirror of test_fused_gradients_match_xla: grad of
    sum(out^2) + sum(scores^2) through the port vs through the JAX kernel
    (rtol 2e-4 / atol 1e-5, that test's tolerances)."""
    n = 9 if kv is None else 16
    qkv = _qkv(2, n, 21)

    def jloss(x):
        out, scores = _jax_fn(kv, "patch_mean", 1)(x)
        return jnp.sum(out ** 2) + jnp.sum(scores * scores)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(qkv)))
    t = torch.from_numpy(qkv).requires_grad_()
    out, scores = _port_fn(kv, "patch_mean", 1)(t)
    ((out ** 2).sum() + (scores * scores).sum()).backward()
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("mode,extra", MODES)
def test_prefix_backward_matches_autograd_of_plain_forward(mode, extra):
    """Mirror of test_prefix_bwd_escape_hatch_matches_kernel: the port's
    prefix backward (the kernel's math) vs torch autograd through the plain
    masked forward (the XLA escape hatch's math), in f32: rtol 2e-4 /
    atol 1e-5."""
    b, n, kept = 2, 16, 9
    kv = extra + kept
    qkv = _qkv(b, n, 31 + extra)

    def loss(out, scores):
        total = (out[:, :kv] ** 2).sum()
        if scores is not None:
            total = total + (scores[:, :kept] ** 2).sum()
        return total

    t = torch.from_numpy(qkv).requires_grad_()
    loss(*qa.fused_qkv_attention_prefix(t, kv, H, mode, extra)).backward()
    r = torch.from_numpy(qkv).requires_grad_()
    loss(*qa.fused_qkv_attention_prefix_plain(r, kv, H, mode, extra)).backward()
    np.testing.assert_allclose(t.grad.numpy(), r.grad.numpy(), rtol=2e-4, atol=1e-5)


def test_none_score_cotangent_is_zero_score_cotangent():
    """Unused scores give a None cotangent: the backward then does no score
    work, and equals a zero score cotangent."""
    qkv = torch.from_numpy(_qkv(2, 17, 41))
    d_out = torch.randn(2, 17, H * D, generator=torch.Generator().manual_seed(0))
    for kv in (None, 9):
        a = qa.fused_qkv_attention_bwd(qkv, d_out, None, H, "patch_mean", 1, kv)
        b = qa.fused_qkv_attention_bwd(
            qkv, d_out, torch.zeros(2, 16), H, "patch_mean", 1, kv
        )
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    t = qkv.clone().requires_grad_()
    out, scores = qa.fused_qkv_attention(t, H, "patch_mean", 1)
    out.sum().backward()  # scores unused
    want = qa.fused_qkv_attention_bwd(qkv, torch.ones_like(out), None, H,
                                      "patch_mean", 1)
    torch.testing.assert_close(t.grad, want, rtol=0, atol=0)


def test_bf16_backward_rounds_like_jax():
    """bf16: dlog and p are rounded to bf16 before the dq/dk/dv products in
    both packages; gradients within 2^-6 of the largest |gradient| (a few
    bf16 ulps of an f32 sum whose order differs)."""
    n = 17
    qkv = _qkv(2, n, 51)
    d_out = np.random.default_rng(52).normal(size=(2, n, H * D)).astype(np.float32)
    (_, _), vjp = jax.vjp(
        _jax_fn(9, None, 1), jnp.asarray(qkv, jnp.bfloat16)
    )
    (want,) = vjp((jnp.asarray(d_out, jnp.bfloat16), None))
    want = np.asarray(want, np.float32)
    got = qa.fused_qkv_attention_bwd_plain(
        torch.from_numpy(qkv).bfloat16(), torch.from_numpy(d_out).bfloat16(),
        None, H, None, 1, 9,
    )
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() <= 2.0**-6 * np.abs(want).max()


def _gelu_inputs():
    x = np.random.default_rng(0).normal(scale=3.0, size=(8192,)).astype(np.float32)
    x[:8] = (-9.0, -4.0, 4.0, 9.0, 3.9999, -4.0001, 0.0, 1e-3)
    return x


def test_gelu_poly_grad_matches_jax():
    """The autograd Function's derivative vs jax.grad of the JAX gelu_poly,
    at the clip points x = +-4 (where jnp.clip splits the cotangent of a
    tie) and beyond.  atol 1e-4: near |x| = 4 the polynomial's terms reach
    ~0.45 and cancel, so either package's f32 evaluation is ~4e-5 from the
    exact derivative (next test)."""
    x = _gelu_inputs()
    want = np.asarray(jax.grad(lambda v: jgelu.gelu_poly(v).sum())(jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_()
    gelu_poly(t).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(t.grad.numpy()[:4], want[:4], rtol=1e-5, atol=2e-5)


def test_gelu_poly_grad_is_the_polynomial_derivative():
    """Against the derivative of the same polynomial in float64 (not the
    derivative of erf): atol 5e-5, the f32 cancellation bound above."""
    x = _gelu_inputs()
    xd = x.astype(np.float64)
    c = np.clip(xd, -4, 4)
    u = c * c
    p = np.polyval(_PHI_COEFFS, u)
    dp = np.polyval(_DPHI_COEFFS, u)
    w = np.where(np.abs(xd) < 4, 1.0, np.where(np.abs(xd) == 4, 0.5, 0.0))
    want = (0.5 + c * p) + xd * w * (p + 2 * u * dp)
    t = torch.from_numpy(x).requires_grad_()
    gelu_poly(t).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-5, atol=5e-5)


def test_gelu_poly_bf16_grad_matches_jax():
    """bf16 in, bf16 cotangent: both round the f32 derivative product to
    bf16 once; within one bf16 ulp (2^-8 relative)."""
    x = _gelu_inputs()
    want = jax.grad(lambda v: jgelu.gelu_poly(v).astype(jnp.float32).sum())(
        jnp.asarray(x, jnp.bfloat16)
    )
    t = torch.from_numpy(x).bfloat16().requires_grad_()
    gelu_poly(t).float().sum().backward()
    assert t.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(
        t.grad.float().numpy(), np.asarray(want, np.float32),
        rtol=2.0**-8, atol=1e-4,
    )


def test_gelu_poly_saves_only_its_input():
    """The Function keeps one tensor for the backward, its bf16 input, not
    the f32 Horner intermediates."""
    x = torch.randn(4, 8, dtype=torch.bfloat16, requires_grad=True)
    y = gelu_poly(x)
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 1 and saved[0].dtype == torch.bfloat16
    assert saved[0].data_ptr() == x.data_ptr()


# The algebra of the bf16 backward kernels (csrc/qkv_attention_bwd.cu), which
# cannot run here: the rows kernel's two sweeps over 64-key tiles (m, l and
# the unnormalised D_run online, then dlog and dq) and the cols kernel's
# dk and dv over 64-key tiles that walk every query tile, in f32.
TILE = 64


def _emulated_kernel_backward(qkv, d_out, ds, mode, extra, kv):
    b, n, c3 = qkv.shape
    q, k, v = (qa._split_heads(t, H) for t in qkv.chunk(3, dim=-1))
    do = qa._split_heads(d_out, H)
    scale = D ** -0.5
    kv = n if kv is None else kv
    rows = torch.arange(n)
    srow = ((rows >= extra) & (rows < kv)).float() if ds is not None else None

    def logits_and_dp(qi, kj, doi, vj, qrows, keys):
        s = qi @ kj.transpose(-1, -2) * scale
        dp = doi @ vj.transpose(-1, -2)
        if ds is not None:
            dp = dp + srow[qrows][:, None] * ds[:, None, None, keys]
        return s, dp

    # rows kernel, sweep 1: m, l and D_run online over the valid key tiles
    m = torch.full((b, H, n), -torch.inf)
    l = torch.zeros(b, H, n)
    d_run = torch.zeros(b, H, n)
    for k0 in range(0, kv, TILE):
        keys = torch.arange(k0, min(k0 + TILE, kv))
        s, dp = logits_and_dp(q, k[:, :, keys], do, v[:, :, keys], rows, keys)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        e = torch.exp(s - m_new[..., None])
        l = l * alpha + e.sum(-1)
        d_run = d_run * alpha + (e * dp).sum(-1)
        m = m_new
    inv = 1.0 / l
    delta = d_run / l
    # sweep 2: dlog and dq
    dq = torch.zeros_like(q)
    for k0 in range(0, kv, TILE):
        keys = torch.arange(k0, min(k0 + TILE, kv))
        s, dp = logits_and_dp(q, k[:, :, keys], do, v[:, :, keys], rows, keys)
        p = torch.exp(s - m[..., None]) * inv[..., None]
        dq += (p * (dp - delta[..., None])) @ k[:, :, keys]
    # cols kernel: each valid key tile walks every query tile
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for k0 in range(0, kv, TILE):
        keys = torch.arange(k0, min(k0 + TILE, n))
        valid = (keys < kv).float()[:, None]
        for q0 in range(0, n, TILE):
            qs = torch.arange(q0, min(q0 + TILE, n))
            st, dpt = logits_and_dp(q[:, :, qs], k[:, :, keys], do[:, :, qs],
                                    v[:, :, keys], qs, keys)
            p = torch.exp(st - m[:, :, qs, None]) * inv[:, :, qs, None]
            p = p.transpose(-1, -2) * valid  # (keys, queries)
            dlog = p * (dpt.transpose(-1, -2) - delta[:, :, None, qs])
            dv[:, :, keys] += p @ do[:, :, qs]
            dk[:, :, keys] += dlog @ q[:, :, qs]
    return torch.cat([qa._merge_heads(g) for g in (dq * scale, dk * scale, dv)],
                     dim=-1)


@pytest.mark.parametrize("n", [90, 129, 257, 258])
@pytest.mark.parametrize("prefix", [False, True])
@pytest.mark.parametrize("mode", [None, "patch_mean"])
def test_two_sweep_backward_algebra_matches_jax_vjp(n, prefix, mode):
    """The tiled online recurrence of the bf16 backward kernels, emulated in
    f32, vs jax.vjp of the JAX kernels (fused_qkv_attention, or the prefix
    form at a middle kv_valid), with a score cotangent for patch_mean:
    within 1e-5 of the largest |gradient|."""
    extra = 1
    kv = (extra + 1 + n) // 2 if prefix else None
    rng = np.random.default_rng(n + 7 * prefix)
    qkv = _qkv(1, n, n)
    d_out = rng.normal(size=(1, n, H * D)).astype(np.float32)
    d_scores = (n * rng.normal(size=(1, n - extra))).astype(np.float32)
    (_, jscores), vjp = jax.vjp(_jax_fn(kv, mode, extra), jnp.asarray(qkv))
    (want,) = vjp((jnp.asarray(d_out),
                   None if jscores is None else jnp.asarray(d_scores)))
    want = np.asarray(want)
    ds = None if mode is None else torch.from_numpy(d_scores)
    got = _emulated_kernel_backward(
        torch.from_numpy(qkv), torch.from_numpy(d_out),
        qa._score_cotangent(ds, mode, H, n, extra, kv), mode, extra, kv,
    ).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
