"""Probe P3: is LayerNorm -> matmul worth a fused kernel? (port of
``scripts/probe_ln_matmul.py``)

At the qkv projection's shapes of the ViT-B serving headline (M = 128 * 257
rows, K = 768, N = 2304, bf16), on the card:

  A  x @ W                    (the product alone, cuBLAS)
  B  LN(x) @ W                (plain LN, then cuBLAS)
  C  ln_matmul(x, g, b, W)    (the fused kernel, csrc/ln_matmul.cu)
  D  LN(x)                    (plain LN alone)

Rows A, B and D are the probe's yardsticks and stay library calls, as the
JAX script leaves them to XLA.  ``ln_matmul(x, g, b, w)`` computes LN(x)
per row with f32 statistics, rounds it to x's dtype, multiplies by w with
f32 accumulation and writes x's dtype; the product is computed in the
kernel's own body: in bf16 on tensor cores (wgmma, with x and w staged by
TMA), in f32 on FMA tiles.  On a CUDA tensor it launches the kernel (or
raises, on a shape or alignment the kernel does not take); on a CPU tensor
it runs ``ln_matmul_plain``.  ``launches`` counts kernel launches.

    python -m tpat_tpu_torch.probes.probe_ln_matmul
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpat_tpu_torch.ops import _build
from tpat_tpu_torch.ops.layernorm import layernorm_fwd_plain

M, K, N = 128 * 257, 768, 2304
EPS = 1e-6
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def ln(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """LN(x) with f32 statistics, in x's dtype (``probe_ln_matmul.py:33-38``)."""
    return layernorm_fwd_plain(x, g, b, EPS)[0]


def _check(x, g, b, w):
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(
            f"x must be (M, K) and w (K, N), got {tuple(x.shape)} and "
            f"{tuple(w.shape)}"
        )
    if g.shape != (x.shape[1],) or b.shape != (x.shape[1],):
        raise ValueError(f"g and b must be ({x.shape[1]},)")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(
            f"x and w must share float32 or bfloat16, got {x.dtype}, {w.dtype}")


def _tc_supports(m: int, k: int, n: int) -> bool:
    """The bf16 tensor-core kernel's shapes: TMA needs 16-byte row strides,
    so K and N are multiples of 8 bf16 values."""
    return m >= 1 and k >= 8 and n >= 8 and k % 8 == 0 and n % 8 == 0


def ln_matmul_plain(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """``_ln_mm_kernel`` (``probe_ln_matmul.py:41-50``) in plain PyTorch:
    LN rounded to x's dtype, then an f32 product, out in x's dtype."""
    _check(x, g, b, w)
    return torch.matmul(ln(x, g, b).float(), w.float()).to(x.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("ln_matmul")
    lib.tpat_ln_matmul.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.tpat_ln_matmul.restype = ctypes.c_int
    lib.tpat_ln_matmul_smem.argtypes = [ctypes.c_int]
    lib.tpat_ln_matmul_smem.restype = ctypes.c_longlong
    return lib


def _kernel(x, g, b, w):
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"no ln_matmul kernel for device {x.device}")
    if any(t.device != x.device or not t.is_contiguous() for t in (x, g, b, w)):
        raise ValueError("ln_matmul takes contiguous operands on one device")
    if g.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError("g and b must be float32")
    m, k = x.shape
    n = w.shape[1]
    lib = _library()
    dtype = _DTYPES[x.dtype]
    if x.dtype == torch.bfloat16:
        if not _tc_supports(m, k, n):
            raise ValueError(
                f"the bf16 kernel takes K and N that are multiples of 8, got "
                f"K = {k}, N = {n}")
        if x.data_ptr() % 16 or w.data_ptr() % 16:
            raise ValueError("the bf16 kernel takes x and w on 16-byte "
                             "boundaries")
    else:
        need = lib.tpat_ln_matmul_smem(k)
        have = torch.cuda.get_device_properties(
            x.device).shared_memory_per_block_optin
        if need > have:
            raise ValueError(
                f"K = {k} needs {need} bytes of shared memory per CTA, the "
                f"card has {have}")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.tpat_ln_matmul(
            x.data_ptr(), g.data_ptr(), b.data_ptr(), w.data_ptr(),
            out.data_ptr(), m, k, n, dtype, EPS,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ln_matmul launch failed: CUDA error {err}")
    launches += 1
    return out


def ln_matmul(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """LN(x) @ w in one kernel on a CUDA tensor, the plain version on a CPU
    tensor.  See the module docstring."""
    _check(x, g, b, w)
    if x.device.type == "cpu":
        return ln_matmul_plain(x, g, b, w)
    return _kernel(x, g, b, w)


def inputs(seed: int = 0, m: int = M, k: int = K, n: int = N,
           dtype=torch.bfloat16, device="cuda"):
    """The probe's operands, drawn on ``device``: x ~ N(0, 1), g ~ 1 +
    N(0, 0.1^2), b ~ N(0, 0.1^2) (f32), w ~ N(0, 0.02^2)."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, device=device, generator=gen)

    return (draw(m, k).to(dtype), draw(k) * 0.1 + 1.0, draw(k) * 0.1,
            (draw(k, n) * 0.02).to(dtype))


def main(iters: int = 200) -> dict:
    """The probe's rows on the card: {row name: ms per call}."""
    from tpat_tpu_torch.cli.profile_forward import card_name
    from tpat_tpu_torch.probes._bench import Bench

    if not torch.cuda.is_available():
        raise SystemExit("probe_ln_matmul needs a CUDA card")
    print(f"card: {card_name()}", flush=True)
    x, g, b, w = inputs()
    ref = ln_matmul_plain(x, g, b, w).float()
    got = ln_matmul(x, g, b, w).float()
    err = (ref - got).abs().max().item() / max(ref.abs().max().item(), 1e-6)
    print(f"fused vs plain rel err: {err:.2e}", flush=True)

    bench = Bench(iters=iters, name_width=28)
    bench("null (floor)", lambda x: x[:2, :2], x, is_floor=True)
    times = {
        "A x@W": bench("A x@W", torch.matmul, x, w),
        "D LN(x)": bench("D LN(x)", ln, x, g, b),
        "B LN(x)@W (plain LN, cuBLAS)": bench(
            "B LN(x)@W (plain LN, cuBLAS)",
            lambda x, g, b, w: torch.matmul(ln(x, g, b), w), x, g, b, w),
        "C ln_matmul kernel": bench("C ln_matmul kernel", ln_matmul, x, g, b, w),
    }
    a, b_, c = (times["A x@W"], times["B LN(x)@W (plain LN, cuBLAS)"],
                times["C ln_matmul kernel"])
    print(f"LN overhead beside the product: {b_ - a:.3f} ms; fused vs plain "
          f"LN + cuBLAS: {b_ - c:+.3f} ms", flush=True)
    return times


if __name__ == "__main__":
    main()
