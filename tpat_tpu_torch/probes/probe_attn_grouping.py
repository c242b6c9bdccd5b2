"""Probe P2: the attention forward's program geometry (port of
``scripts/probe_attn_grouping.py``).

The TPU probe swept the batch group g of a program and its lane width (128
or 256 lanes: 2 or 4 heads per program), skipping what did not fit in VMEM.
On Hopper a CTA's geometry is its query-tile height and the heads it runs
one after the other, so this probe sweeps those: ``ROWS`` (32, 64 or 128
query rows per CTA) by ``HEADS`` (1, 2 or 4 heads per CTA), skipping a
height whose CTA does not fit in the card's shared memory.

``grouped_attention(qkv, rows, heads)`` is softmax attention without scores
(P1's 'noscore' body in ``csrc/attn_probe.cu``, bf16) from packed qkv
(B, N, 3 * 768) to out (B, N, 768); the output does not depend on the
geometry.  On a CUDA tensor it launches the kernel (or raises); on a CPU
tensor it runs ``grouped_attention_plain``.  ``launches`` counts kernel
launches.

On the card:

    python -m tpat_tpu_torch.probes.probe_attn_grouping

prints, at N = 257 and 181, the null floor, the shipped kernel (with
patch_mean scores) and every geometry.
"""

from __future__ import annotations

import torch

from tpat_tpu_torch.probes import probe_attn_softmax as p1

B, C, H = p1.B, p1.C, p1.H
ROWS = (32, 64, 128)
HEADS = (1, 2, 4)

launches = 0


def _check(qkv: torch.Tensor, rows: int, heads: int):
    p1.check_qkv(qkv, "noscore")
    if rows not in ROWS or heads not in HEADS:
        raise ValueError(
            f"no geometry rows={rows}, heads={heads} (rows in {ROWS}, heads "
            f"in {HEADS})"
        )


def grouped_attention_plain(qkv: torch.Tensor) -> torch.Tensor:
    """``_kernel`` (``probe_attn_grouping.py:32-53``) in plain PyTorch:
    P1's plain 'noscore' output."""
    return p1.variant_attention_plain(qkv, "noscore")[0]


def fits(rows: int) -> bool:
    """Whether a CTA with ``rows`` query rows fits in the current card's
    shared memory (the TPU probe's VMEM skip, ``:95-99``)."""
    need = p1.library().tpat_attn_probe_smem(rows)
    return 0 < need <= torch.cuda.get_device_properties(
        torch.cuda.current_device()).shared_memory_per_block_optin


def _grouped_kernel(qkv: torch.Tensor, rows: int, heads: int) -> torch.Tensor:
    global launches
    p1.check_device(qkv)
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"the grouped kernels take bfloat16, got {qkv.dtype}")
    b, n, _ = qkv.shape
    out = torch.empty((b, n, C), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = p1.library().tpat_attn_probe_grouped(
            qkv.data_ptr(), out.data_ptr(), b, n, H, rows, heads,
            p1.logit_scale("noscore"), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"grouped attention launch failed: CUDA error {err}")
    launches += 1
    return out


def grouped_attention(qkv: torch.Tensor, rows: int = 64,
                      heads: int = 1) -> torch.Tensor:
    """Softmax attention without scores at one CTA geometry: the kernel on
    a CUDA tensor, the plain version on a CPU tensor."""
    _check(qkv, rows, heads)
    if qkv.device.type == "cpu":
        return grouped_attention_plain(qkv)
    return _grouped_kernel(qkv, rows, heads)


def main(iters: int = 200) -> dict:
    """The probe's rows on the card: {row name: ms per call}."""
    from tpat_tpu_torch.cli.profile_forward import card_name
    from tpat_tpu_torch.ops.qkv_attention import fused_qkv_attention
    from tpat_tpu_torch.probes._bench import Bench

    if not torch.cuda.is_available():
        raise SystemExit("probe_attn_grouping needs a CUDA card")
    print(f"card: {card_name()}", flush=True)
    bench = Bench(iters=iters, name_width=40)
    times = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for w in p1.WIDTHS:
        qkv = torch.randn(B, w, 3 * C, device="cuda", generator=gen).to(
            torch.bfloat16)
        bench(f"[w={w}] null", lambda q: q[:2, :2, 0], qkv, is_floor=True)
        times[f"[w={w}] shipped (+scores, 64 rows, 1 head)"] = bench(
            f"[w={w}] shipped (+scores, 64 rows, 1 head)",
            lambda q: fused_qkv_attention(q, H, "patch_mean", 1), qkv)
        for r in ROWS:
            if not fits(r):
                print(f"[w={w}] {r} rows: skipped (shared memory)", flush=True)
                continue
            for hh in HEADS:
                name = f"[w={w}] noscore {r:3d} rows, {hh} heads/CTA"
                times[name] = bench(
                    name, lambda q, r=r, hh=hh: grouped_attention(q, r, hh), qkv)
    return times


if __name__ == "__main__":
    main()
