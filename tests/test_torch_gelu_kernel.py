"""The polynomial GELU's kernels (``tpat_tpu_torch/csrc/gelu_poly.cu``, B-G).

On the CPU: a numpy model of the kernels' arithmetic (the same f32
operations in the same order, each rounded once, the NaN-keeping clamp, the
tie weights, the coefficients rounded to f32) is bit-equal to the eager
``_GeluPoly`` forward and backward, on every bf16 value and on an f32 grid;
the wrapper hands the kernels ``np.float32`` of the coefficients; CPU, f16
and f32 inputs take the eager ops, and importing and running the module
needs no nvcc; the ``gelu_eager`` count.

On a card (``-m card``; these skip without one): the kernels against the
eager ops bit for bit at the cells' fc1 shapes, odd sizes, views off 16
bytes, a non-contiguous gradient and inside ``torch.utils.checkpoint``.
Run there without the JAX conftest:
``python -m pytest tests/test_torch_gelu_kernel.py --noconftest -m card``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.utils.checkpoint as cp

from tpat_tpu_torch.ops import fast_gelu as fg
from tpat_tpu_torch.utils import tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = np.float32


# -- the kernels' arithmetic in numpy ----------------------------------------


def _clamp(x):
    # NaN stays NaN, as in torch.clamp and the kernels' clamp4
    return np.where(np.isnan(x), x, np.minimum(np.maximum(x, F32(-4)), F32(4)))


def _horner(coeffs, u):
    k = np.float32(coeffs)
    p = np.full_like(u, k[0])
    for c in k[1:]:
        p = p * u + c  # two f32 operations, each rounded
    return p


def model_fwd(x):
    """The forward kernel's f32 result on f32 x."""
    with np.errstate(all="ignore"):
        c = _clamp(x)
        p = _horner(fg._PHI_COEFFS, c * c)
        return x * (F32(0.5) + c * p)


def model_bwd(x, g):
    """The backward kernel's f32 result on f32 x and cotangent g."""
    with np.errstate(all="ignore"):
        c = _clamp(x)
        u = c * c
        p = _horner(fg._PHI_COEFFS, u)
        dp = _horner(fg._DPHI_COEFFS, u)
        a = np.abs(x)
        w = np.where(a < 4, F32(1), np.where(a == 4, F32(0.5), F32(0)))
        deriv = (F32(0.5) + c * p) + (x * w) * (p + (F32(2) * u) * dp)
        return g * deriv


def bf16_to_f32(bits):
    return (bits.astype(np.uint32) << 16).view(np.float32)


def f32_to_bf16(x):
    """Round to nearest even, as ``__float2bfloat16_rn``; NaN as torch's
    CPU cast writes it (the card's cvt writes another payload)."""
    b = x.view(np.uint32)
    rounded = ((b + np.uint32(0x7FFF) + ((b >> 16) & 1)) >> 16).astype(np.uint16)
    return np.where(np.isnan(x), np.uint16(0x7FC0), rounded)


def as_bf16(bits):
    return torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)


def bits_of(t):
    return t.detach().view(torch.int16).numpy().view(np.uint16)


def assert_same(got, want):
    """The same bits, NaN where NaN; got and want are bit arrays, uint16 of
    bf16 or uint32 of f32."""
    as_f32 = bf16_to_f32 if got.dtype == np.uint16 else (lambda b: b.view(F32))
    nan = np.isnan(as_f32(got))
    np.testing.assert_array_equal(nan, np.isnan(as_f32(want)))
    bad = np.flatnonzero((got != want) & ~nan)
    assert bad.size == 0, f"{bad.size} elements differ, first at {bad[:5]}"


def eager(x, g):
    """``gelu_poly`` and its gradient through the autograd Function."""
    xr = x.detach().requires_grad_()
    y = fg.gelu_poly(xr)
    (dx,) = torch.autograd.grad(y, xr, g)
    return y, dx


EVERY_BF16 = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)


def _cotangent(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "ones":
        return np.full(n, 0x3F80, np.uint16)
    if kind == "normal":
        return f32_to_bf16(rng.standard_normal(n).astype(F32))
    return rng.integers(0, 1 << 16, n, dtype=np.uint32).astype(np.uint16)


def test_every_bf16_value_is_in_the_grid():
    """The bf16 grid holds +-4 and their neighbours, +-inf, NaN, subnormals
    and |x| > 4."""
    x = bf16_to_f32(EVERY_BF16)
    four = np.flatnonzero(np.abs(x) == 4)
    assert four.size == 2
    for i in four:
        assert np.abs(x[i - 1]) != 4 and np.abs(x[i + 1]) != 4
    assert np.isposinf(x).any() and np.isneginf(x).any() and np.isnan(x).any()
    tiny = np.finfo(np.float32).tiny
    assert ((x != 0) & (np.abs(x) < tiny)).sum() > 200
    assert (np.abs(x) > 4).sum() > 30000


def test_model_forward_is_bit_equal_to_eager_on_every_bf16_value():
    x = as_bf16(EVERY_BF16)
    got = f32_to_bf16(model_fwd(bf16_to_f32(EVERY_BF16)))
    assert_same(got, bits_of(fg.gelu_poly(x)))


@pytest.mark.parametrize("kind", ["ones", "normal", "any_bits"])
def test_model_backward_is_bit_equal_to_eager_on_every_bf16_value(kind):
    g = _cotangent(kind, EVERY_BF16.size, 25)
    _, dx = eager(as_bf16(EVERY_BF16), as_bf16(g))
    got = f32_to_bf16(model_bwd(bf16_to_f32(EVERY_BF16), bf16_to_f32(g)))
    assert_same(got, bits_of(dx))


def _f32_grid():
    four = F32(4)
    special = [four, -four, np.nextafter(four, F32(0)), np.nextafter(-four, F32(0)),
               np.nextafter(four, F32(np.inf)), np.nextafter(-four, F32(-np.inf)),
               F32(np.inf), F32(-np.inf), F32(np.nan), F32(0), F32(-0.0),
               F32(1e-45), F32(-1e-45), F32(1.1754942e-38), F32(-1.1754942e-38),
               F32(5), F32(-5), F32(1e30), F32(-1e30), F32(3.4e38), F32(-3.4e38)]
    rng = np.random.default_rng(7)
    return np.concatenate([
        np.array(special, F32),
        (rng.standard_normal(20000) * 3).astype(F32),
        rng.uniform(-6, 6, 20000).astype(F32),
        rng.integers(0, 1 << 32, 20000, dtype=np.uint64).astype(np.uint32).view(F32),
    ])


def test_model_is_bit_equal_to_eager_on_an_f32_grid():
    """In f32 no output rounding hides an ulp of the arithmetic."""
    x = _f32_grid()
    g = np.random.default_rng(8).standard_normal(x.size).astype(F32)
    y, dx = eager(torch.from_numpy(x), torch.from_numpy(g))
    assert_same(model_fwd(x).view(np.uint32), y.detach().numpy().view(np.uint32))
    assert_same(model_bwd(x, g).view(np.uint32), dx.numpy().view(np.uint32))


def test_kernel_coefficients_are_f32_of_the_fit():
    phi, dphi = fg.kernel_coeffs()
    np.testing.assert_array_equal(np.array(phi[:], F32), np.float32(fg._PHI_COEFFS))
    np.testing.assert_array_equal(np.array(dphi[:], F32), np.float32(fg._DPHI_COEFFS))
    assert len(phi) == 9 and len(dphi) == 8


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_cpu_inputs_take_the_eager_ops(dtype, monkeypatch):
    def refuse():
        raise AssertionError("the kernels' library was loaded")

    monkeypatch.setattr(fg, "_library", refuse)
    before = (fg.launches, fg.bwd_launches)
    x = torch.randn(3, 5, 8).to(dtype)
    g = torch.randn(3, 5, 8).to(dtype)
    y, dx = eager(x, g)
    assert torch.equal(y, fg.gelu_poly_fwd_plain(x))
    assert torch.equal(dx, fg.gelu_poly_bwd_plain(x, g))
    assert y.dtype == dx.dtype == dtype
    assert (fg.launches, fg.bwd_launches) == before


def test_only_bf16_cuda_takes_the_kernels():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert fg.takes_kernel(cuda, torch.bfloat16)
    for dt in (torch.float16, torch.float32):
        assert not fg.takes_kernel(cuda, dt)
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        assert not fg.takes_kernel(cpu, dt)


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.randn(4, 8).bfloat16()
    with pytest.raises(TypeError, match="bf16 CUDA"):
        fg._forward_kernel(x)
    with pytest.raises(TypeError, match="bf16 CUDA"):
        fg._backward_kernel(x, x)


def test_kernel_operands_are_contiguous_and_16_byte_aligned():
    """The wrapper copies a view the kernels' 16-byte loads cannot read
    (off 16 bytes, or not contiguous) and hands an aligned one on as is."""
    base = torch.randn(64).bfloat16()
    assert base.data_ptr() % 16 == 0
    aligned, off = base[8:40], base[1:33]
    assert fg._operand(aligned) is aligned
    strided = torch.randn(8, 5).bfloat16().t()
    for t in (off, strided):
        got = fg._operand(t)
        assert got.is_contiguous() and got.data_ptr() % 16 == 0
        assert torch.equal(got, t)


def test_import_and_cpu_calls_need_no_nvcc(tmp_path):
    code = (
        "import torch\n"
        "import tpat_tpu_torch.ops.fast_gelu as fg\n"
        "x = torch.randn(4, 9, dtype=torch.bfloat16, requires_grad=True)\n"
        "fg.gelu_poly(x).float().sum().backward()\n"
        "assert fg._library.cache_info().currsize == 0\n"
        "print('ok')\n")
    env = {**os.environ, "PATH": str(tmp_path), "CUDA_HOME": str(tmp_path),
           "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_profiler_counts_gelu_eager_on_the_cpu():
    x = torch.randn(2, 7, 16, dtype=torch.bfloat16, requires_grad=True)
    tracing.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.span("gelu.forward"):
            y = fg.gelu_poly(x)
        with tracing.span("gelu.backward"):
            y.float().sum().backward()
    assert tracing.records("gelu.forward")[-1].counts == {"gelu_eager": x.numel()}
    assert tracing.records("gelu.backward")[-1].counts == {"gelu_eager": x.numel()}
    tracing.clear()


def test_no_count_without_a_profiler():
    tracing.clear()
    with tracing.span("gelu.forward"):
        fg.gelu_poly(torch.randn(4, dtype=torch.bfloat16))
    assert tracing.records("gelu.forward") == []


# -- on the card --------------------------------------------------------------

FC1_SHAPES = [(128, 257, 3072), (128, 90, 3072), (32, 257, 3072),
              (256, 96, 3072), (256, 512, 2048)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.Generator(device="cuda").manual_seed(25)


def _randn(gen, *shape):
    return torch.randn(*shape, device="cuda", generator=gen).bfloat16()


def _same_on_card(got, want):
    assert got.shape == want.shape
    diff = got.view(torch.int16) != want.view(torch.int16)
    assert not diff.any(), f"{int(diff.sum())} of {got.numel()} elements differ"


def _kernel_vs_eager(x, g):
    before = (fg.launches, fg.bwd_launches)
    y, dx = eager(x, g)
    assert (fg.launches - before[0], fg.bwd_launches - before[1]) == (1, 1)
    _same_on_card(y, fg.gelu_poly_fwd_plain(x))
    _same_on_card(dx, fg.gelu_poly_bwd_plain(x, g))


@pytest.mark.card
@pytest.mark.parametrize("shape", FC1_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_card_bit_equal_at_fc1_shapes(card, shape):
    _kernel_vs_eager(_randn(card, *shape) * 2, _randn(card, *shape))


@pytest.mark.card
def test_card_bit_equal_on_every_bf16_value(card):
    x = torch.from_numpy(EVERY_BF16.view(np.int16).copy()).cuda().view(torch.bfloat16)
    _kernel_vs_eager(x, _randn(card, x.numel()))


@pytest.mark.card
@pytest.mark.parametrize("n", [1, 7, 8 * 1001 + 3])
def test_card_odd_sizes(card, n):
    _kernel_vs_eager(_randn(card, n) * 3, _randn(card, n))


@pytest.mark.card
def test_card_views_off_16_bytes(card):
    n = 8 * 1001 + 3
    x = (_randn(card, n + 8) * 3)[1:n + 1]
    g = _randn(card, n + 8)[3:n + 3]
    assert x.is_contiguous() and x.data_ptr() % 16 and g.data_ptr() % 16
    _kernel_vs_eager(x, g)


@pytest.mark.card
def test_card_non_contiguous_gradient(card):
    x = _randn(card, 257, 3072)
    g = _randn(card, 3072, 257).t()
    assert not g.is_contiguous()
    _kernel_vs_eager(x, g)
    _same_on_card(fg._backward_kernel(x, g), fg.gelu_poly_bwd_plain(x, g))
    _kernel_vs_eager(_randn(card, 3072, 257).t(), g)


@pytest.mark.card
def test_card_inside_checkpoint(card):
    h = _randn(card, 4, 257, 768)
    w1, w2 = _randn(card, 768, 3072) / 28, _randn(card, 3072, 768) / 55
    dy = _randn(card, 4, 257, 768)

    def mlp(h, w1, w2):
        return fg.gelu_poly(h @ w1) @ w2

    grads, launches = [], []
    for checkpointed in (False, True):
        leaves = [t.detach().requires_grad_() for t in (h, w1, w2)]
        before = (fg.launches, fg.bwd_launches)
        out = (cp.checkpoint(mlp, *leaves, use_reentrant=False)
               if checkpointed else mlp(*leaves))
        grads.append(torch.autograd.grad(out, leaves, dy))
        launches.append((fg.launches - before[0], fg.bwd_launches - before[1]))
    for a, b in zip(*grads):
        _same_on_card(b, a)
    assert launches == [(1, 1), (2, 1)]
