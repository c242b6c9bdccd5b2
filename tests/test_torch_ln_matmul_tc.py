"""The algorithm of the bf16 LayerNorm-matmul kernel
(tpat_tpu_torch/csrc/ln_matmul.cu, probe P3, on csrc/hopper_tma_wgmma.cuh),
which cannot run here, as a PyTorch model held against the Pallas probe
``scripts/probe_ln_matmul.py::ln_matmul`` in interpret mode (the fixtures
of tests/test_torch_probes.py).

The model follows the kernel: per-row statistics in two passes (the mean,
then the centred variance, f32); x and w seen as the tensor maps deliver
them, zero past K; y formed per 64-wide slice of K as ((x - mu) * rstd) *
g + b with g and b zero past K, rounded to bf16; the product over k16 steps
with f32 accumulation and one rounding at the end.  The tests also hold the
address arithmetic the kernel uses for its shared-memory stages (the
128-byte swizzle of the TMA boxes, the ldmatrix lane addresses and the
wgmma B descriptor) and the wrapper's rule for the shapes the kernel
takes."""

import numpy as np
import pytest
import torch

from tests.test_torch_probes import interpret, scripts  # noqa: F401
from tpat_tpu_torch.probes import probe_ln_matmul as p3

import jax.numpy as jnp

BM, BN, BK = 128, 256, 64  # the kernel's tile and stage depth
OUT_REL = 2e-2  # of the largest |entry|: one bf16 ulp of the output
X_STAGE, W_BOX = BM * BK * 2, BK * 64 * 2  # bytes: x slice, one w box
LBO, SBO = W_BOX, 8 * 128  # the w descriptor's offsets


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small products and many slices; beside the other test workers,
    intra-op threads only contend, so one thread for this module, restored
    after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed, m, k, n):
    """x ~ N(0, 1) and w ~ N(0, 0.02^2) in bf16, g ~ 1 + N(0, 0.1^2) and
    b ~ N(0, 0.1^2) in f32, from numpy."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    g = torch.from_numpy((1.0 + 0.1 * rng.normal(size=k)).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.normal(size=k)).astype(np.float32))
    w = torch.from_numpy((0.02 * rng.normal(size=(k, n))).astype(np.float32))
    return x.to(torch.bfloat16), g, b, w.to(torch.bfloat16)


def _pad_k(t, kp, dim):
    """t zero-padded along ``dim`` to kp entries (the tensor maps' fill
    past K, and g and b read as 0 there)."""
    pad = [0, 0] * (t.dim() - 1 - dim) + [0, kp - t.shape[dim]]
    return torch.nn.functional.pad(t, pad)


def kernel_model(x, g, b, w, eps=p3.EPS):
    """The bf16 kernel's arithmetic: returns (out bf16 (M, N), y bf16
    (M, K padded to the slices))."""
    m, k = x.shape
    kp = -(-k // BK) * BK
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    xp, gp, bp, wp = (_pad_k(x, kp, 1), _pad_k(g, kp, 0), _pad_k(b, kp, 0),
                      _pad_k(w, kp, 0))
    acc = torch.zeros(m, w.shape[1])
    ys = []
    for s in range(0, kp, BK):
        y = ((xp[:, s:s + BK].float() - mu) * rstd * gp[s:s + BK]
             + bp[s:s + BK]).to(torch.bfloat16)
        ys.append(y)
        for kk in range(0, BK, 16):
            acc = acc + y[:, kk:kk + 16].float() @ wp[s + kk:s + kk + 16].float()
    return acc.to(torch.bfloat16), torch.cat(ys, dim=1)


@pytest.mark.parametrize("m", [100, 300])
@pytest.mark.parametrize("k", [256, 768])
def test_model_matches_script(scripts, interpret, m, k):
    """The model against the script's kernel at bm=128, bn=256 (M ragged
    against 128), N = 256: within 2e-2 of the largest |entry|."""
    x, g, b, w = _inputs(m + k, m, k, 256)
    jx, jw = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (x, w))
    want = np.asarray(scripts["probe_ln_matmul"].ln_matmul(
        jx, jnp.asarray(g.numpy()), jnp.asarray(b.numpy()), jw, bm=BM, bn=BN
    ).astype(jnp.float32))
    got, _ = kernel_model(x, g, b, w)
    assert got.shape == (m, 256) and got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() <= OUT_REL * np.abs(want).max()


@pytest.mark.parametrize("k", [200, 768])
def test_model_y_is_the_plain_layernorm(k):
    """The model's y, slice by slice, gives ``p3.ln``'s bits on the CPU."""
    x, g, b, w = _inputs(k, 300, k, 64)
    _, y = kernel_model(x, g, b, w)
    assert torch.equal(y[:, :k], p3.ln(x, g, b))


def test_y_past_k_is_zero():
    """K = 200 padded to 256: y past K is exactly 0, not b, so nothing
    leaks into the product, which agrees with the plain version."""
    x, g, b, w = _inputs(7, 130, 200, 256)
    out, y = kernel_model(x, g, b, w)
    assert y.shape == (130, 256)
    assert torch.equal(y[:, 200:].float(), torch.zeros(130, 56))
    want = p3.ln_matmul_plain(x, g, b, w).float()
    assert (out.float() - want).abs().max() <= OUT_REL * want.abs().max()


def swizzle128(row, chunk):
    """``hopper::swizzle128``: byte offset of 16-byte chunk ``chunk`` of
    row ``row`` in a tile of 128-byte rows written by TMA with the 128-byte
    swizzle."""
    return row * 128 + ((chunk ^ (row & 7)) << 4)


def _w_offset(j, row, chunk):
    """Where the w stage's box j (columns 64 j ..) puts row ``row``'s
    chunk."""
    return X_STAGE + j * W_BOX + swizzle128(row, chunk)


def test_stage_swizzle_is_a_bijection():
    """The x slice (128 rows x 8 chunks) and the w slice (four boxes of 64
    rows x 8 chunks) each fill their part of the stage once, every 16-byte
    chunk on a 16-byte boundary."""
    xs = [swizzle128(r, c) for r in range(BM) for c in range(8)]
    assert sorted(xs) == list(range(0, X_STAGE, 16))
    ws = [_w_offset(j, r, c) for j in range(BN // 64) for r in range(BK)
          for c in range(8)]
    assert sorted(ws) == list(range(X_STAGE, X_STAGE + 4 * W_BOX, 16))
    assert all(o % 16 == 0 for o in xs + ws)


def test_ldmatrix_addresses_give_the_a_fragments():
    """The kernel's ldmatrix.x4 lane addresses into the swizzled x slice
    give each consumer warp the A fragments of its 16 rows at every k16
    step: a0 = (g, 2t..), a1 = (g+8, 2t..), a2 = (g, 8+2t..), a3 = (g+8,
    8+2t..)."""
    x = torch.arange(BM * BK, dtype=torch.int64).reshape(BM, BK)
    stage = {}  # byte offset of a 16-byte chunk -> its eight values
    for r in range(BM):
        for c in range(8):
            stage[swizzle128(r, c)] = x[r, 8 * c:8 * c + 8]
    for warp in range(8):
        tile_row = (warp >> 2) * 64 + (warp & 3) * 16
        for kk in range(4):
            rows = [stage[swizzle128(tile_row + (lane & 7) + 8 * ((lane >> 3) & 1),
                                     2 * kk + (lane >> 4))] for lane in range(32)]
            for lane in range(32):
                gq, t = lane >> 2, lane & 3
                for i, (dr, dc) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
                    # matrix i's row gq, lanes' pair t: from the lane that
                    # addressed it
                    got = rows[8 * i + gq][2 * t:2 * t + 2]
                    c = kk * 16 + dc + 2 * t
                    assert torch.equal(got, x[tile_row + gq + dr, c:c + 2])


def test_descriptor_reads_w_where_tma_put_it():
    """The canonical MN-major layout of the 128-byte swizzle, ((8 values, 8
    chunks, N / 64 blocks), (8 rows, K / 8 groups)) with the blocks LBO and
    the groups SBO apart, read from the k16 step's start (kk x 16 rows of
    128 bytes), finds w[16 kk + k, n] where the four TMA boxes put it."""
    for kk in range(4):
        start = X_STAGE + kk * 16 * 128
        for k in range(16):
            for n in range(BN):
                atom = start + (n // 64) * LBO + (k // 8) * SBO
                row_in_atom, chunk = k % 8, (n % 64) // 8
                got = atom + swizzle128(row_in_atom, chunk) + 2 * (n % 8)
                want = _w_offset(n // 64, 16 * kk + k, (n % 64) // 8) + 2 * (n % 8)
                assert got == want


@pytest.mark.parametrize("m,k,n,ok", [
    (p3.M, p3.K, p3.N, True), (300, 256, 264, True), (100, 200, 256, True),
    (100, 768, 260, False), (100, 764, 256, False), (100, 770, 256, False),
    (100, 768, 2, False)])
def test_tc_supports(m, k, n, ok):
    """TMA needs 16-byte row strides: the bf16 kernel takes K and N that
    are multiples of 8 and refuses the rest."""
    assert p3._tc_supports(m, k, n) is ok
