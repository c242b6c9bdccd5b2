#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tpat_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, on a machine with an H100 and the CUDA
toolkit:

    python3 chip_smoke.py

Phases; each raises on failure, and the script then exits non-zero without
printing a result:

1. device: requires CUDA, prints the card's name and power limit (nvidia-smi)
   and turns TF32 off for matmuls and convolutions, so the f32 checks compare
   full-f32 arithmetic;
2. build: nvcc builds ``tpat_tpu_torch/csrc/qkv_attention.cu`` for sm_90a
   (in parallel with phase 6's build);
3. kernel vs plain: ``fused_qkv_attention`` against
   ``fused_qkv_attention_plain`` on the card over H=12/D=64 at
   N in {257, 181, 127, 90, 258, 129} (plus H=16/D=80), modes
   patch_mean/cls/none, f32 and bf16 at B=2, and bf16 at the serving path's
   widths and modes at buckets 1/8/32; then, at B=128 and the path's widths,
   compared again and timed with CUDA events; the sha256 of the kernel
   outputs is logged (so two builds can be held to the same bits);
4. serving path at full width: the ViT-B/16 ESC-50 keep-0.7 bf16 model, from
   seeded random weights, saved as a ``.pth``, exported by the port's CLI with
   buckets 1,8,32,128 and served by ``load_forward`` for requests of 1, 5,
   32, 128 and 200 clips; the kernel must run 12 times per bucket forward;
5. model level: the same weights with attention_impl 'fused' vs 'xla', in f32
   (pruning indices exactly equal) and in bf16 at keep 1.0;
6. build: ``tpat_tpu_torch/csrc/qkv_attention_bwd.cu``, with its ptxas report;
7. kernel vs plain for the prefix forward (``fused_qkv_attention_prefix``)
   and the backward (``fused_qkv_attention_bwd``): a grid at B=2, f32 and
   bf16, H=12/D=64 and H=16/D=80, N in {257, 232, 189, 133, 90, 129, 258},
   modes none / patch_mean / cls, kv_valid in {extra+1, middle, N}, the
   backward with and without a score cotangent, prefix and not;
8. training path at full width: ``TrainModule.train_epoch`` on ft_esc50's
   ViT-B/16 ESC-50 keep-0.7 bf16 configuration at batch 128 from seeded
   weights, over five epochs of two steps (dense with 2D masking, anneal at
   rates 1.0, hybrid at bucket 1.0, hybrid at bucket 0.8, static), with the
   launches of every step counted and asserted, the geometry of every
   launch recorded, and the ms per step of each epoch through the kernels
   and through plain attention; then one hybrid step at bucket 0.9 (not
   counted) to record its launches too;
9. kernel vs plain at every launch geometry recorded in phase 8 (B=128
   bf16: B1 at N = 111 and the static widths, B2 at each hybrid bucket's
   (N, kv_valid), B3 at all of them), compared and timed with CUDA events in
   turns: B3 through ``fused_qkv_attention_bwd`` (both kernels and the
   wrapper's allocations) against the plain backward, and each of its two
   kernels alone;
10. one train step in f32, attention_impl 'fused' vs 'xla' from the same
    weights and batch, in each step variant of ``cli/profile_train.py``
    (dense with 2D masking, dense, hybrid at buckets 0.8 and 0.9, static):
    losses, every parameter gradient and the tokens kept at each drop
    block;
11. build: ``tpat_tpu_torch/csrc/window_attention.cu`` and
    ``window_attention_bwd.cu`` (both on ``window_attention_tc.cuh``; one
    nvcc per source of the port, all seven started together), with their
    ptxas reports;
12. window kernels vs plain at B=2: the dense form (``fused_window_attention``)
    at N in {64, 256} and the banded form at N in {128, 512}, shifts (0,0)
    and (2,0), H=16/D=32 and H=4/D=32, f32 and bf16, plus one case per form
    and dtype at the scale clamp of 100 (f32 atol scaled with the scale) and
    one bf16 case per form whose template has a row with no live entry
    (uniform p, its query block kept whole by the tensor-core kernels); the
    forward and the backward's d_qkv, d_scale and d_template / d_band, and
    the sha256 of the kernel outputs;
13. pretrain path at full width: ``engine/pretrain.py``'s train step on
    ``mae_vit_base_dec512d8b`` (bf16, b32, mask ratio 0.8, seeded weights),
    a few steps on one fixed batch at the AudioSet grid (target length
    1024: the banded kernel) and the ESC-50 grid (512: the dense kernel),
    with the launches of every step counted and asserted, every launch's
    geometry recorded, the loss finite and falling, the frozen pos embeds
    unchanged; then the ms per step through the kernels and through the
    partitioned plain path (``window_attention_impl='xla'``), in turns;
14. every kernel of the pretrain path vs plain at each recorded B=32
    geometry (the window kernels, B1 and B3 at N = 103 and 52), compared and
    timed with CUDA events in turns, beside the library call; the window
    forward also by its kernels' device time (``torch.profiler``);
15. one f32 pretrain step at each grid, the window kernels vs 'xla', from
    the same weights, batch and step generator (the same masks and
    dropout): the loss and every parameter gradient;
16. the LayerNorm kernels (``csrc/layernorm.cu``, built with the others in
    phase 2) vs plain at M in {1, 7, 515, 4112}, every width of
    ``ops.layernorm.WIDTHS``, f32 and bf16: forward y, mu, rstd and backward
    dx, dw, db;
17. ``use_fused_layernorm=True`` at full width: phase 4's artifact served
    with the flag (24 LayerNorm launches per bucket forward asserted, each
    launch's (M, D) recorded) and the ms per b128 forward with the flag and
    without, in turns; phase 8's five epochs with the flag (24 forward and
    24 backward launches per step asserted and recorded, none without the
    flag) and the ms per step with and without, in turns; one f32 train
    step with the flag vs without in each step variant (loss, gradients,
    kept tokens);
18. the LayerNorm kernels vs plain at every geometry recorded in phase 17
    (each serving bucket's and each training step's); those of the b128
    forward and the B=128 steps timed in turns beside the bound and
    ``F.layer_norm``, and the device time of each of the three from
    ``torch.profiler``;
19. the probes: P1's six variants (``probes/probe_attn_softmax.py``) vs
    plain at B=2 (N 33 and 257, f32 and bf16) and B=128 (N 257 and 181),
    P2's nine geometries (``probes/probe_attn_grouping.py``) at the same
    shapes in bf16, and P3
    (``probes/probe_ln_matmul.py``) vs plain at (M, K, N) = (100, 768, 256)
    in f32 and bf16 and, in bf16, (4111, 768, 2304), (32896, 768, 2304) and
    (300, 256, 264), each bf16 case launched three more times for the same
    bits; P3 in bf16 with w = I (K = N = 768, M = 4112), whose output is
    the kernel's rounded LayerNorm, against ``p3.ln`` (the share of entries
    that differ logged); the bf16 P3 kernel's SASS holds HGMMA and UTMALDG
    (where the toolkit has cuobjdump); each probe timed at its shapes; in
    bf16 the nine geometries held to P1 'noscore''s bits, and
    P1 'full' and 'noscore' to B1's out bits at B=128; then each probe's
    ``main()`` with a few iterations (the probes' own path, whose launches
    are counted);
20. the kernels line, with the entries ``layernorm_fwd``,
    ``layernorm_bwd``, ``attn_probe_variants``, ``attn_probe_grouped`` and
    ``ln_matmul`` beside those of phases 1-15; the ``qkv_attention_*``,
    ``window_attention_*``, ``attn_probe_*`` and ``ln_matmul`` entries
    also give the design of their bf16 build and the registers and spill
    bytes of its kernels (per head_dim, per probe variant or geometry, per
    dtype for P3; the FMA kernels beside the window forward and P1) from
    the ptxas report, and the backward and window entries the SDPA backend
    of their library call; ``ln_matmul`` also its SASS check and its w = I
    comparison.

Beside each kernel's time the script computes its bound, the least time the
H100 could take for the same work on these inputs (the larger of the bytes
the call must move at 3.35 TB/s and the FLOPs its data needs at 989 TFLOP/s
bf16, or 67 TFLOP/s for LayerNorm's f32 arithmetic), and times the one
PyTorch call that computes the same function, where there is one
(``library_ms``; a yardstick that the port never calls).  A backward's
library call is SDPA's autograd backward, and the window forward's SDPA
itself, under each backend that takes its inputs, the median of several
timed loops, the fastest reported with its backend's name.

The line before the last is a JSON object with each kernel's launches (from
the serving, training and pretrain paths, and the probes' mains), error,
times and bound; the last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch
import torch.nn.functional as F

SEED = 0
# tolerances, kernel vs plain on the same inputs
F32_ATOL = 1e-5  # f32 out: same math, other summation order
BF16_TOL = 2e-2  # bf16 out atol and rtol: p is rounded to bf16 before p.v
SCORE_RTOL, SCORE_ATOL = 1e-3, 1e-6  # scores come from the f32 p in both
# model level: logits of 'fused' vs 'xla' through 12 blocks
F32_LOGIT_RTOL, F32_LOGIT_ATOL = 1e-3, 2e-4
BF16_LOGIT_REL = 5e-2  # of the largest |logit|: bf16 rounding of p flips ulps
# gradients, kernel vs plain, as a share of the largest |gradient| of the
# tensor: each entry is a sum over N products whose sizes reach that largest
# entry, taken in another order (FMA chains in the kernel, cuBLAS in plain),
# so the error scales with it; an entrywise rtol would fail on entries near 0
GRAD_F32_REL = 1e-4
GRAD_BF16_REL = 2e-2  # dlog and p are rounded to bf16 at the same points
# one train step in f32, 'fused' vs 'xla', through 12 blocks
STEP_LOSS_RTOL = 1e-4

# ViT-B/16 ESC-50, keep 0.7 at blocks (3, 6, 9): attention calls per forward
PATH_CALLS = (
    (257, None, 3), (257, "patch_mean", 1),
    (181, None, 2), (181, "patch_mean", 1),
    (127, None, 2), (127, "patch_mean", 1),
    (90, None, 2),
)
REQUESTS = (1, 5, 32, 128, 200)
BUCKETS = (1, 8, 32, 128)
STEP_BATCH_F32 = 32  # phase 10

# window attention, kernel vs plain (phases 12, 14): the forward as above;
# the backward's d_qkv, d_scale and d_template each within GRAD_*_REL of the
# tensor's largest |entry| (sums over N or over the batch, taken in another
# order)
PRETRAIN_GRIDS = ((1024, "AudioSet"), (512, "ESC-50"))  # target lengths
PRETRAIN_BATCH = 32  # scripts/bench_mae_step.py's batch
PRETRAIN_STEPS = 4  # counted steps per grid (phase 13)
PRETRAIN_TIMED = 3  # steps per timed turn (phase 13)
# the H100 SXM's published peaks (NVIDIA data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
SCALE_CLAMP = 100.0  # exp(min(logit_scale, log 100)): the largest scale

# LayerNorm (phases 16-18): y, mu and rstd within F32_ATOL or BF16_TOL; dx,
# dw and db within GRAD_*_REL of the tensor's largest |entry| (dw and db are
# sums over M rows taken in another order)
LN_EPS = 1e-6  # the configs' layer_norm_eps
LN_ROWS = (1, 7, 515, 4112)
LN_STEP_LAUNCHES = (24, 24)  # forward, backward: norm1 and norm2 x 12 blocks
# probes (phase 19): the unnormalised outputs (noexp, mmonly) within this
# share of their largest |entry| in f32 (sums of N products of size ~1)
UNNORM_F32_REL = 1e-5
# P3 vs plain at (M, K, N, dtype): the probe's shape, a ragged M, an N that
# is not a multiple of the kernel's 256 columns, a K of four slices
P3_CASES = ((100, 768, 256, torch.float32), (100, 768, 256, torch.bfloat16),
            (4111, 768, 2304, torch.bfloat16),
            (128 * 257, 768, 2304, torch.bfloat16),
            (300, 256, 264, torch.bfloat16))
P3_IDENTITY = (4112, 768, 4)  # M, K = N, inputs (seeds): w = I
PROBE_ITERS = 5  # timed calls per row and repeat of each probe's main()


def log(msg):
    print(msg, flush=True)


def check_device() -> str:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script runs only on an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; TF32 off for "
        "matmul and cuDNN (f32 checks compare full f32)")
    return smi


def build_kernels():
    """Phases 2, 6, 11 and 16: one nvcc per source, all started together."""
    from tpat_tpu_torch.ops import _build

    names = ("qkv_attention", "qkv_attention_bwd", "window_attention",
             "window_attention_bwd", "layernorm", "attn_probe", "ln_matmul")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        libs = list(pool.map(_build.build, names))
    log(f"build: {', '.join(lib.name for lib in libs)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for lib in libs:
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log(f"  ptxas {lib.name.split('.')[0]}: {line.strip()}")


def ptxas_report(name: str) -> dict:
    """{kernel's mangled name: (registers, spill bytes)} from the ptxas
    report (``-Xptxas -v``) kept beside the built ``csrc/<name>.cu``; spill
    bytes are its spill stores plus spill loads."""
    from tpat_tpu_torch.ops import _build

    report, entry, spill = {}, None, 0
    for line in _build.build(name).with_suffix(".log").read_text().splitlines():
        if "Compiling entry function '" in line:
            entry = line.split("'")[1]
        elif "bytes spill stores" in line:
            words = line.replace(",", "").split()
            spill = (int(words[words.index("stores") - 3])
                     + int(words[words.index("loads") - 3]))
        elif "Used" in line and "registers" in line and entry is not None:
            words = line.replace(",", "").split()
            report[entry] = (int(words[words.index("registers") - 1]), spill)
            entry, spill = None, 0
    return report


def build_fields(name: str, design: str, kernels: dict) -> dict:
    """The kernels line's fields for a bf16 build in ``csrc/<name>.cu``: its
    design and, per label of ``kernels`` (label: the substrings that pick
    one kernel's mangled name), the registers and spill bytes ptxas
    reports."""
    regs, spill = {}, {}
    report = ptxas_report(name)
    for label, parts in kernels.items():
        found = [v for e, v in report.items() if all(p in e for p in parts)]
        if len(found) != 1:
            raise AssertionError(f"no single ptxas report of {parts} in "
                                 f"csrc/{name}.cu")
        regs[label], spill[label] = found[0]
    return {"design": design, "registers": regs, "spill_bytes": spill}


def bf16_build(name: str, kernel: str) -> dict:
    """``build_fields`` of a qkv_attention kernel (its unmangled name), per
    head_dim."""
    return build_fields(
        name, "mma.sync m16n8k16 bf16 (ldmatrix), cp.async double-buffered "
              "tiles; f32 keeps FMA tiles",
        {str(d): (kernel, f"ILi{d}E") for d in (64, 80)})


def probe_builds() -> tuple:
    """``build_fields`` of ``csrc/attn_probe.cu``: (P1's, per variant in
    bf16 and f32; P2's, per geometry)."""
    from tpat_tpu_torch.probes import probe_attn_grouping as p2
    from tpat_tpu_torch.probes import probe_attn_softmax as p1

    design = ("bf16: B1's kernel, a warp per 16 query rows, mma.sync "
              "m16n8k16 (ldmatrix), cp.async double-buffered 64-key tiles, "
              "the softmax on the accumulator fragments, two sweeps over the "
              "keys (one for mmonly), the next head's first tiles copied "
              "during the last tile of the one before; f32 keeps B1's FMA "
              "tiles")
    kernel = "attn_probe_bf16_kernelILi{}ELi{}ELi{}E"
    variants = {v: (kernel.format(64, 1, i),) for i, v in enumerate(p1.VARIANTS)}
    variants.update({f"f32 {v}": (f"attn_probe_f32_kernelILi{i}E",)
                     for i, v in enumerate(p1.VARIANTS)})
    noscore = p1.VARIANTS.index("noscore")
    geometries = {f"{r} rows, {h} heads": (kernel.format(r, h, noscore),)
                  for r in p2.ROWS for h in p2.HEADS}
    return (build_fields("attn_probe", design, variants),
            build_fields("attn_probe", design, geometries))


LN_MATMUL_DESIGN = (
    "bf16: persistent CTAs (one per SM), 128 x 256 output tiles, a row "
    "block's column tiles back to back; a producer warpgroup's thread "
    "issues TMA loads (128-byte swizzle) into a ring of three 48 KB stages "
    "under full/empty mbarriers: per row block x alone twice (the mean, "
    "then the centred variance, from ldmatrix fragments), then x and w per "
    "64-deep slice; two consumer warpgroups (setmaxnreg 232, the producers "
    "40) normalise their ldmatrix fragments of x into bf16 A registers and "
    "issue wgmma m64n256k16 (A from registers, w N-major by descriptor), "
    "waiting per slice; the accumulator leaves through a swizzled shared "
    "buffer and a TMA store. f32 keeps the FMA tiles")
WINDOW_FWD_BUILD = (
    "window_attention",
    "bf16: a live-block kernel, then one CTA per (window unit, head, sample), "
    "a warp per 16 query rows, q, k and v staged once (cp.async), "
    "mma.sync m16n8k16 (ldmatrix); cos as split-bf16 hi.hi + hi.lo + lo.hi; "
    "two sweeps over the live 16 x 16 blocks only (m and l online, the "
    "backward's stats code; then p normalised in f32, rounded to bf16, "
    "round(p).v as one bf16 product). f32 keeps the FMA kernel (4 x 4 "
    "register micro-tiles over f32 tiles)",
    {"32": ("window_attention_fwd_bf16_kernel", "ILi32E"),
     "live": ("window_attention_live_kernel",),
     "fma f32": ("window_attention_fwd_kernelIfLi32E",)})
WINDOW_BWD_BUILD = (
    "window_attention_bwd",
    "bf16: one CTA per (window unit, head, sample), a warp per 16 rows, "
    "mma.sync m16n8k16 (ldmatrix, movmatrix); cos, dq^ and dk^ as "
    "split-bf16 hi.hi + hi.lo + lo.hi, dp and dv single bf16 products; "
    "logits and dp twice per sample (stats sweep, gradient sweep); 16 x 16 "
    "blocks whose template entries are all -1e30 skipped; per-sample "
    "d_template and d_scale partials summed in batch order (a live-block "
    "kernel before, a template-sum kernel after). f32 keeps the FMA rows, "
    "cols and template kernels",
    {"32": ("window_attention_bwd_bf16_kernel", "ILi32E"),
     "live": ("window_attention_live_kernel",),
     "template sum": ("window_attention_bwd_tmpl_sum_kernel",)})
WINDOW_FWD_NOTE = (
    "ms by CUDA events around each call's wrapper, which at tens of "
    "microseconds a call includes the host's launch rate; device_ms is the "
    "summed duration of the call's two kernels (live map and main), "
    "torch.profiler")
# the window backward entries' bound counts the function's work, not the
# kernel's instructions
WINDOW_BWD_NOTE = (
    "bound_ms is the function's work (each input read once, each output "
    "written once, 10 D FLOPs per live pair), not the kernel's "
    "instructions: it computes cos and dp twice per sample and cos, dq^ "
    "and dk^ as three bf16 products each")


def _close(got, want, atol, rtol) -> float:
    err = (got.float() - want.float()).abs()
    bound = atol + rtol * want.float().abs()
    if not torch.isfinite(got.float()).all() or (err > bound).any():
        raise AssertionError(
            f"kernel disagrees with plain: max abs err {err.max().item():.3g}"
            f" (atol {atol}, rtol {rtol})"
        )
    return err.max().item()


def _rel_close(got, want, rel, what) -> float:
    """max |got - want| <= rel * max |want|, for a tensor whose entries are
    sums over many terms whose sizes reach its largest entry (gradients,
    LayerNorm's dw and db, unnormalised outputs): the error scales with that
    entry, and an entrywise rtol would fail on entries near 0.  Returns the
    max abs err."""
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if not torch.isfinite(got.float()).all() or not err <= rel * scale:
        raise AssertionError(f"{what}: kernel vs plain max abs err {err:.3g} "
                             f"> {rel} x max|plain| {scale:.3g}")
    return err


def _fold(digest, *tensors):
    """Fold kernel outputs' bytes into ``digest``: phases 3 and 12 log it, so
    that two builds of the same kernels can be held to the same bits."""
    if digest is not None:
        for t in tensors:
            if t is not None:
                digest.update(t.contiguous().cpu().view(torch.uint8).numpy()
                              .tobytes())


def _fwd_pair(qa, kv):
    """(kernel, plain) forward functions of (qkv, h, mode, extra): the
    plain form when kv is None, else the prefix form at kv_valid = kv."""
    if kv is None:
        return qa.fused_qkv_attention, qa.fused_qkv_attention_plain
    return (lambda qkv, *a: qa.fused_qkv_attention_prefix(qkv, kv, *a),
            lambda qkv, *a: qa.fused_qkv_attention_prefix_plain(qkv, kv, *a))


def _compare(qa, qkv, h, mode, extra, kv=None, digest=None):
    """Kernel vs plain on one input; returns (out err, score err)."""
    kern, plain = _fwd_pair(qa, kv)
    with torch.no_grad():
        out, s = kern(qkv, h, mode, extra)
        pout, ps = plain(qkv, h, mode, extra)
    torch.cuda.synchronize()
    _fold(digest, out, s)
    if qkv.dtype == torch.float32:
        e = _close(out, pout, F32_ATOL, 0.0)
    else:
        e = _close(out, pout, BF16_TOL, BF16_TOL)
    if mode is None:
        assert s is None and ps is None
        return e, 0.0
    assert s.shape == (qkv.shape[0], qkv.shape[1] - extra)
    return e, _close(s, ps, SCORE_ATOL, SCORE_RTOL)


def kernel_vs_plain() -> float:
    """The grid at B=2 (H=12/D=64 at path and odd widths, H=16/D=80), then
    bf16 at the serving path's widths, modes and buckets 1/8/32 (bucket 128
    is compared where it is timed)."""
    from tpat_tpu_torch.ops import qkv_attention as qa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    digest = hashlib.sha256()
    worst = {torch.float32: [0.0, 0.0], torch.bfloat16: [0.0, 0.0]}
    count = {torch.float32: 0, torch.bfloat16: 0}
    cases = [
        (2, h, d, n, mode, extra, dt)
        for h, d, ns in ((12, 64, (257, 181, 127, 90, 258, 129, 103, 52)),
                         (16, 80, (257, 90)))
        for n in ns
        for mode, extra in (("patch_mean", 1), ("cls", 2), (None, 1))
        for dt in (torch.float32, torch.bfloat16)
    ]
    cases += [
        (b, 12, 64, n, mode, 1, torch.bfloat16)
        for b in BUCKETS[:-1]
        for n, mode, _ in PATH_CALLS
    ]
    for b, h, d, n, mode, extra, dt in cases:
        qkv = torch.randn(b, n, 3 * h * d, device="cuda", generator=gen).to(dt)
        eo, es = _compare(qa, qkv, h, mode, extra, digest=digest)
        worst[dt] = [max(worst[dt][0], eo), max(worst[dt][1], es)]
        count[dt] += 1
    for dt, (eo, es) in worst.items():
        log(f"kernel vs plain, {count[dt]} cases, {dt}: worst out abs err "
            f"{eo:.3g}, worst score abs err {es:.3g}")
    log(f"kernel vs plain: the kernel outputs' sha256 {digest.hexdigest()}")
    return max(max(v) for v in worst.values())


def _time_ms(fn, iters=20) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _turns(a, b) -> tuple:
    """Mean ms of a and of b, timed in turns b, a, a, b."""
    b1, a1, a2, b2 = _time_ms(b), _time_ms(a), _time_ms(a), _time_ms(b)
    return (a1 + a2) / 2, (b1 + b2) / 2


def bound_of(parts: dict) -> tuple:
    """(ms, by) of a sum of calls from {by: ms}: the total, labelled by what
    bounds most of it."""
    return sum(parts.values()), max(parts, key=parts.get)


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    """(ms, 'bytes' or 'operations'): the least time the H100 could take to
    move ``nbytes`` (each input read once, each output written once) and do
    ``flops`` on ``dtype`` inputs, the larger of the two at the published
    peaks."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def qkv_work(b, n, c3, h, itemsize, mode=None, extra=1, kv=None,
             bwd=False) -> tuple:
    """(bytes, FLOPs) a B1/B2 forward or B3 backward needs: q's N rows and
    k, v's first kv_valid rows (keys past it need neither reading nor
    work), the output, the scores (f32) where a mode asks for them; the
    backward reads dO too and writes the packed gradient.  FLOPs: 4 N kv D
    per (sample, head) forward, 10 N kv D backward (q.k^T, dO.v^T, dq, dk,
    dv)."""
    c = c3 // 3
    kv = n if kv is None else kv
    read = n * c + 2 * kv * c
    if bwd:
        return (itemsize * b * (read + n * c + n * c3),
                10 * b * h * n * kv * (c // h))
    scores = 4 * b * (n - extra) if mode is not None else 0
    return itemsize * b * (read + n * c) + scores, 4 * b * h * n * kv * (c // h)


def window_work(qkv, template, banded: bool, bwd: bool) -> tuple:
    """(bytes, FLOPs) a window-attention forward or backward needs on these
    inputs: qkv, the template (f32) and the (H,) scales read, the output
    written; the backward reads dO too and writes d_qkv, d_template and
    d_scale.  FLOPs count only the pairs whose template entry is not the
    -1e30 exclusion (the other probabilities are exact zeros): 4 D per
    pair forward, 10 D backward."""
    b, n, c3 = qkv.shape
    h = template.shape[0]
    c = c3 // 3
    pairs = int((template > -1e29).sum().item())
    io = qkv.element_size() * b * n
    tmpl = template.numel() * 4 + 4 * h
    if bwd:
        return io * (c3 + c + c3) + 2 * tmpl, 10 * b * pairs * (c // h)
    return io * (c3 + c) + tmpl, 4 * b * pairs * (c // h)


def _sdpa_inputs(kind, qkv, h, kv_valid, scale, template, banded):
    """(q, k, v, mask, softmax scale) of the library call for a kernel's
    inputs: kind 'qkv' for B1-B3 (keys at or past kv_valid masked), 'window'
    for B5/B6 as SDPA over (q^ * scale[h], k^, v) with the template (the
    band, chunk by chunk) as an additive mask and no further scaling."""
    b, n, c3 = qkv.shape
    d = c3 // 3 // h
    q, k, v = (t.reshape(b, n, h, d).transpose(1, 2) for t in qkv.chunk(3, -1))
    if kind == "qkv":
        mask, sm_scale = None, d ** -0.5
        if kv_valid is not None:
            mask = (torch.arange(n, device=qkv.device) < kv_valid)[None, None, None]
    else:
        q = F.normalize(q.float(), dim=-1) * scale[:, None, None]
        k = F.normalize(k.float(), dim=-1)
        q, k = q.to(v.dtype), k.to(v.dtype)
        mask, sm_scale = template.to(v.dtype)[None], 1.0
        if banded:
            q, k, v = (t.reshape(b, -1, 128, d) for t in (q, k, v))
            mask = mask.reshape(1, -1, 128, 128)
    return (*(t.contiguous() for t in (q, k, v)), mask, sm_scale)


SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH")
LIBRARY_LOOPS = 5  # timed loops per backend of a backward's yardstick


def library_ms(kind, qkv, h, *, kv_valid=None, scale=None, template=None,
               banded=False, d_out=None, iters=20) -> tuple:
    """The yardstick: (ms per call, SDPA backend) of the one PyTorch call
    that computes a kernel's function on the same inputs
    (``_sdpa_inputs``), ``F.scaled_dot_product_attention``, by CUDA events
    around ``iters`` calls after a warm-up; the inputs are prepared outside
    the timed calls.  A 'qkv' forward takes PyTorch's own dispatch (backend
    None).  A 'window' forward, and with ``d_out`` the autograd backward
    alone: the backend choice with a mask is not pinned and spread
    2.5-3.6x between runs, so each backend that takes these inputs is timed
    under ``sdpa_kernel``, as the median of LIBRARY_LOOPS loops, and the
    fastest is reported.  The port never calls it."""
    import statistics
    import warnings

    from torch.nn.attention import SDPBackend, sdpa_kernel

    b, n, c3 = qkv.shape
    q, k, v, mask, sm_scale = _sdpa_inputs(kind, qkv, h, kv_valid, scale,
                                           template, banded)

    def timed(call) -> float:
        for _ in range(3):
            call()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            call()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def forward():
        with torch.no_grad():
            F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                           scale=sm_scale)

    if d_out is None and kind == "qkv":
        return timed(forward), None
    if d_out is not None:
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    best, seen = None, []
    for name in SDPA_BACKENDS:
        try:
            with sdpa_kernel(getattr(SDPBackend, name)), \
                    warnings.catch_warnings():
                warnings.simplefilter("ignore")
                call = forward
                if d_out is not None:
                    out = F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask, scale=sm_scale)
                    g = d_out.reshape(b, n, h, -1).transpose(1, 2).reshape(
                        out.shape)

                    def call():
                        torch.autograd.grad(out, (q, k, v), g,
                                            retain_graph=True)
                loops = [timed(call) for _ in range(LIBRARY_LOOPS)]
        except RuntimeError:  # the backend does not take these inputs
            continue
        ms = statistics.median(loops)
        seen.append(f"{name.lower()} {ms:.4f} ({min(loops):.4f}-"
                    f"{max(loops):.4f})")
        if best is None or ms < best[0]:
            best = (ms, name.lower())
    what = "forward" if d_out is None else "backward"
    if best is None:
        raise AssertionError(f"no SDPA backend takes the {kind} {what}")
    log(f"  library {what}, {kind} B={b} N={n}: median (range) of "
        f"{LIBRARY_LOOPS} loops, ms: " + ", ".join(seen))
    return best


def time_kernel():
    """Kernel vs plain at B=128 bf16 for each attention call of the serving
    path, then both timed on that input in turns (plain, kernel, kernel,
    plain); returns the per-forward sums and the worst error."""
    from tpat_tpu_torch.ops import qkv_attention as qa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    total_k = total_p = worst = 0.0
    total_b = {}
    no_score = [0.0, 0.0]  # the calls without scores: kernel, library
    digest = hashlib.sha256()
    with torch.no_grad():
        for n, mode, calls in PATH_CALLS:
            qkv = torch.randn(128, n, 3 * 768, device="cuda",
                              generator=gen).to(torch.bfloat16)
            eo, es = _compare(qa, qkv, 12, mode, 1, digest=digest)
            worst = max(worst, eo, es)
            kern = lambda: qa.fused_qkv_attention(qkv, 12, mode, 1)  # noqa: E731
            plain = lambda: qa.fused_qkv_attention_plain(qkv, 12, mode, 1)  # noqa: E731
            k, p = _turns(kern, plain)
            bms, by = bound_ms(*qkv_work(128, n, 3 * 768, 12, 2, mode),
                               torch.bfloat16)
            lib = "none (scores)"
            if mode is None:
                lib_ms, _ = library_ms("qkv", qkv, 12)
                no_score[0] += calls * k
                no_score[1] += calls * lib_ms
                lib = f"{lib_ms:.4f} ms"
            log(f"time B=128 N={n} mode={mode}: kernel {k:.4f} ms, plain "
                f"{p:.4f} ms, library {lib}, bound {bms:.4f} ms ({by}) "
                f"(x{calls} per forward); out abs err {eo:.3g}, score abs "
                f"err {es:.3g}")
            total_k += calls * k
            total_p += calls * p
            total_b[by] = total_b.get(by, 0.0) + calls * bms
    log(f"time per b128 forward, all 12 attention calls: kernel "
        f"{total_k:.4f} ms, plain {total_p:.4f} ms, bound "
        f"{sum(total_b.values()):.4f} ms; the 9 calls without scores: kernel "
        f"{no_score[0]:.4f} ms, library {no_score[1]:.4f} ms; the kernel "
        f"outputs' sha256 {digest.hexdigest()}")
    return total_k, total_p, worst, total_b


def sharpened_state_dict(model, seed):
    """Every tensor N(0, 0.05^2) except the qkv weights, N(0, 1): sharp
    attention keeps the importance scores decisively separated, so top-k
    indices are well conditioned (as tests/test_model_parity.py does)."""
    g = torch.Generator().manual_seed(seed)
    return {
        k: torch.randn(v.shape, generator=g) * (1.0 if "qkv" in k else 0.05)
        for k, v in model.state_dict().items()
    }


def serving_path(tmp):
    from tpat_tpu_torch.cli import export_serving
    from tpat_tpu_torch.config import audiomae_vit_base
    from tpat_tpu_torch.models.vit import AudioViT
    from tpat_tpu_torch.ops import qkv_attention as qa
    from tpat_tpu_torch.utils.serving import load_forward

    cfg = audiomae_vit_base(
        target_length=512, num_classes=50, base_keep_rate=0.7,
        drop_loc=(3, 6, 9), drop_path_rate=0.0, compute_dtype="bfloat16",
    )
    model = AudioViT(cfg, generator=torch.Generator().manual_seed(SEED))
    sd = sharpened_state_dict(model, SEED)
    pth = os.path.join(tmp, "vit_b_esc50.pth")
    torch.save({"model": sd, "epoch": 0}, pth)
    out_dir = os.path.join(tmp, "artifact")
    export_serving.main(export_serving.get_parser().parse_args([
        "--model", "audiomae_vit_base", "--dataset", "esc50",
        "--nb_classes", "50", "--base_keep_rate", "0.7",
        "--drop_loc", "(3, 6, 9)", "--compute_dtype", "bfloat16",
        "--finetuned_model_path", pth,
        "--batch_size", ",".join(map(str, BUCKETS)), "--out_dir", out_dir,
    ]))
    fn, meta = load_forward(out_dir, device="cuda")
    assert meta["batch_sizes"] == list(BUCKETS), meta

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    requests = {n: torch.randn(n, 1, 512, 128, device="cuda", generator=gen)
                for n in REQUESTS}
    torch.cuda.synchronize()

    qa.launches = 0  # the main path starts here
    per_request = {}
    for n, x in requests.items():
        before = qa.launches
        y = fn(x)
        torch.cuda.synchronize()
        per_request[n] = qa.launches - before
        forwards = math.ceil(n / BUCKETS[-1])
        if per_request[n] != 12 * forwards:
            raise AssertionError(
                f"request of {n}: {per_request[n]} kernel launches, expected "
                f"{12 * forwards} ({forwards} bucket forwards x 12 blocks)")
        if y.shape != (n, 50) or not torch.isfinite(y).all():
            raise AssertionError(f"request of {n}: bad logits {tuple(y.shape)}")
    launches = qa.launches  # the main path ends here
    log(f"serving: requests {list(REQUESTS)} answered, launches per request "
        f"{per_request}, total {launches}")

    x = requests[128]
    clips = {}
    plain_cfg = dataclasses.replace(cfg, attention_impl="xla")
    plain_fn, _ = load_forward(out_dir, cfg=plain_cfg, device="cuda")
    for name, f in (("kernel", fn), ("plain", plain_fn),
                    ("plain", plain_fn), ("kernel", fn)):
        ms = _time_ms(lambda: f(x), iters=10)
        clips.setdefault(name, []).append(128 / (ms / 1000))
    kernel_cps = sum(clips["kernel"]) / 2
    plain_cps = sum(clips["plain"]) / 2
    log(f"serving b128 bf16: {kernel_cps:.1f} clips/s through the kernel, "
        f"{plain_cps:.1f} clips/s through plain attention")
    return cfg, sd, launches, out_dir


def model_level(cfg, sd):
    from tpat_tpu_torch.models.vit import AudioViT

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    x = torch.randn(8, 1, 512, 128, device="cuda", generator=gen)

    def run(dtype, impl, keep_rates=None):
        c = dataclasses.replace(cfg, compute_dtype=dtype, attention_impl=impl)
        m = AudioViT(c, device="cuda")
        m.load_state_dict(sd, strict=True)
        m.eval()
        with torch.no_grad():
            return m(x, keep_rates, extract_features=True)

    # the serving model's feature walk: 256 patches -> 180 -> 126 -> 89
    _, feats = run("bfloat16", "fused")
    widths = [feats[f"block-{i}.topk_idx"].shape[1] for i in (3, 6, 9)]
    if widths != [180, 126, 89]:
        raise AssertionError(f"topk widths {widths}, expected [180, 126, 89]")

    lf, ff = run("float32", "fused")
    lx, fx = run("float32", "xla")
    for i in (3, 6, 9):
        k = f"block-{i}.topk_idx"
        if not torch.equal(ff[k], fx[k]):
            raise AssertionError(f"f32 {k} differs between fused and xla")
    torch.testing.assert_close(lf, lx, rtol=F32_LOGIT_RTOL, atol=F32_LOGIT_ATOL)
    log(f"model f32 fused vs xla: topk_idx equal at blocks 3/6/9, logits max "
        f"abs diff {(lf - lx).abs().max().item():.3g}")

    dense = (1.0,) * cfg.depth
    lf, _ = run("bfloat16", "fused", dense)
    lx, _ = run("bfloat16", "xla", dense)
    diff = (lf - lx).abs().max().item()
    scale = lx.abs().max().item()
    if not diff <= BF16_LOGIT_REL * scale:
        raise AssertionError(
            f"bf16 keep 1.0 fused vs xla: max abs diff {diff:.3g} > "
            f"{BF16_LOGIT_REL} x max|logit| {scale:.3g}")
    log(f"model bf16 keep 1.0 fused vs xla: logits max abs diff {diff:.3g} "
        f"(max |logit| {scale:.3g})")

    lf, ff = run("bfloat16", "fused")
    lx, fx = run("bfloat16", "xla")
    if lf.shape != lx.shape or not (torch.isfinite(lf).all()
                                    and torch.isfinite(lx).all()):
        raise AssertionError("bf16 keep 0.7: bad logits")
    a, b = ff["block-3.topk_idx"], fx["block-3.topk_idx"]
    kept = torch.zeros(a.shape[0], cfg.num_patches, device=a.device)
    ones = torch.ones(a.shape, device=a.device)
    kept.scatter_add_(1, a, ones).scatter_add_(1, b, ones)
    overlap = (kept == 2).sum().item() / a.numel()
    log(f"model bf16 keep 0.7: shapes equal and finite; block-3 kept-set "
        f"overlap {overlap:.4f} (near-ties may flip in bf16)")


def _rel_to_max(got, want, rel, what) -> float:
    """``_rel_close`` for each of dq, dk and dv."""
    return max(_rel_close(g, w, rel, f"{what} d{part}")
               for g, w, part in zip(got.chunk(3, -1), want.chunk(3, -1), "qkv"))


def _compare_bwd(qa, qkv, d_out, d_scores, h, mode, extra, kv) -> float:
    g = qa.fused_qkv_attention_bwd(qkv, d_out, d_scores, h, mode, extra, kv)
    pg = qa.fused_qkv_attention_bwd_plain(qkv, d_out, d_scores, h, mode,
                                          extra, kv)
    torch.cuda.synchronize()
    rel = GRAD_F32_REL if qkv.dtype == torch.float32 else GRAD_BF16_REL
    return _rel_to_max(g, pg, rel, f"bwd n={qkv.shape[1]} kv={kv} mode={mode}")


def prefix_and_bwd_vs_plain():
    """Phase 7, the grid at B=2: the prefix forward at kv_valid in
    {extra+1, middle, N}; the backward with and without a score cotangent,
    prefix (middle kv_valid) and not."""
    from tpat_tpu_torch.ops import qkv_attention as qa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    f32, bf16 = torch.float32, torch.bfloat16
    fwd = {f32: [0.0, 0.0], bf16: [0.0, 0.0]}
    bwd = {f32: 0.0, bf16: 0.0}
    n_fwd = n_bwd = 0
    for h, d in ((12, 64), (16, 80)):
        for n in (257, 232, 189, 133, 90, 129, 258, 103, 52):
            for mode, extra in ((None, 1), ("patch_mean", 1), ("cls", 2)):
                mid = (extra + 1 + n) // 2
                for dt in (f32, bf16):
                    qkv = torch.randn(2, n, 3 * h * d, device="cuda",
                                      generator=gen).to(dt)
                    for kv in (extra + 1, mid, n):
                        eo, es = _compare(qa, qkv, h, mode, extra, kv)
                        fwd[dt] = [max(fwd[dt][0], eo), max(fwd[dt][1], es)]
                        n_fwd += 1
                    d_out = torch.randn(2, n, h * d, device="cuda",
                                        generator=gen).to(dt)
                    cots = [None]
                    if mode is not None:
                        cots.append(n * torch.randn(2, n - extra, device="cuda",
                                                    generator=gen))
                    for kv in (None, mid):
                        for ds in cots:
                            err = _compare_bwd(qa, qkv, d_out, ds, h, mode,
                                               extra, kv)
                            bwd[dt] = max(bwd[dt], err)
                            n_bwd += 1
    for dt in (f32, bf16):
        log(f"prefix fwd vs plain, {dt}: worst out abs err {fwd[dt][0]:.3g}, "
            f"worst score abs err {fwd[dt][1]:.3g}; bwd vs plain, {dt}: worst "
            f"abs err {bwd[dt]:.3g}")
    log(f"kernel vs plain at B=2: {n_fwd} prefix forwards, {n_bwd} backwards")
    return (max(max(v) for v in fwd.values()), max(bwd.values()))


def _counts(qa):
    return (qa.launches, qa.prefix_launches, qa.bwd_rows_launches,
            qa.bwd_cols_launches)


@contextlib.contextmanager
def _recording(qa, calls):
    """Route the kernel launchers through a recorder: each launch appends
    its geometry, (kind, B, N, 3C, dtype, H, mode, extra, kv_valid, whether a
    score cotangent came), to ``calls``.  The launchers still count."""
    fwd, bwd = qa._forward_kernel, qa._backward_kernels

    def forward(qkv, num_heads, mode, extra, kv_valid):
        calls.append(("fwd", *qkv.shape, qkv.dtype, num_heads, mode, extra,
                      kv_valid, False))
        return fwd(qkv, num_heads, mode, extra, kv_valid)

    def backward(qkv, d_out, d_scores, num_heads, mode, extra, kv_valid):
        calls.append(("bwd", *qkv.shape, qkv.dtype, num_heads, mode, extra,
                      kv_valid, d_scores is not None))
        return bwd(qkv, d_out, d_scores, num_heads, mode, extra, kv_valid)

    qa._forward_kernel, qa._backward_kernels = forward, backward
    try:
        yield
    finally:
        qa._forward_kernel, qa._backward_kernels = fwd, bwd


def _timed(batches, steps, counts, calls):
    """Yield the batches, recording each step's ms, launch counts (the
    change of ``counts()``) and recorded launches."""
    for x, y in batches:
        torch.cuda.synchronize()
        c0, i0, t0 = counts(), len(calls), time.perf_counter()
        yield x, y
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        steps.append((ms, tuple(a - b for a, b in zip(counts(), c0)),
                      tuple(calls[i0:])))


def _train_configs(dtype, drop_path_rate):
    """ft_esc50's configuration (``cli/profile_train.py``) at ``dtype`` and
    ``drop_path_rate``, its schedule cut to five epochs: dense, three of
    anneal, static."""
    from tpat_tpu_torch.cli import profile_train

    cfg, tc = profile_train.train_configs()
    cfg = dataclasses.replace(cfg, compute_dtype=dtype,
                              drop_path_rate=drop_path_rate)
    tc = dataclasses.replace(tc, epochs=5, warmup_epochs=1,
                             shrink_start_epoch=1, shrink_epochs=3)
    return cfg, tc


# per-step launches (forward, prefix forward, bwd rows, bwd cols) by epoch
STEP_LAUNCHES = {0: (12, 0, 12, 12), 1: (12, 0, 12, 12), 2: (4, 8, 12, 12),
                 3: (4, 8, 12, 12), 4: (12, 0, 12, 12)}
EPOCH_LABELS = ("dense, 2D masking", "anneal, rates 1.0 (dense step)",
                "anneal, hybrid at bucket 1.0", "anneal, hybrid at bucket 0.8",
                "static")
BUCKET_09 = "hybrid at bucket 0.9 (one step, not counted)"


def _run_epochs(cfg, tc, sd, batches, counts, calls, what):
    """Phase 8's five epochs of ``TrainModule.train_epoch`` (two steps each)
    from the weights ``sd``: each step's (ms, launch counts, recorded
    launches) and each epoch's loss.  Raises unless the phases are dense,
    anneal x3, static, the losses finite and the frozen pos_embed
    unchanged."""
    from tpat_tpu_torch.engine.train import TrainModule

    mod = TrainModule(cfg, tc, "ce", iters_per_epoch=2, device="cuda")
    state = mod.load(sd, seed=SEED)
    steps, phases, losses = [], [], []
    for epoch in range(5):
        state, stats = mod.train_epoch(
            state, _timed(batches, steps, counts, calls), epoch)
        phases.append(stats["phase"])
        losses.append(stats["loss"])
    if not torch.equal(state.model.pos_embed, sd["pos_embed"].to("cuda")):
        raise AssertionError(f"{what}: the frozen pos_embed moved")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{what}: losses {losses}")
    if phases != ["dense", "anneal", "anneal", "anneal", "static"]:
        raise AssertionError(f"{what}: phases {phases}")
    del state, mod
    torch.cuda.empty_cache()
    return steps, losses


def training_path(sd):
    """Phase 8: train_epoch at full width through the kernels (the counted
    main path, every launch recorded), then in turns through plain attention
    and the kernels (plain, kernel, kernel, plain) for the ms per step;
    then one recorded hybrid step at bucket 0.9.  Returns the main
    path's launch counts and {walk: one step's recorded launches}."""
    from tpat_tpu_torch.cli import profile_train
    from tpat_tpu_torch.engine import schedules
    from tpat_tpu_torch.engine.train import TrainModule
    from tpat_tpu_torch.ops import qkv_attention as qa

    cfg, tc = _train_configs("bfloat16", 0.1)
    sched = {}
    for epoch in (2, 3):
        rates = schedules.scheduled_keep_rates(
            epoch * 2, epoch, shrink_start_epoch=1, total_epochs=4,
            iters_per_epoch=2, base_keep_rate=0.7)
        sched[epoch] = (rates[3], schedules.bucket_keep_rates(
            rates, base_keep_rate=0.7, n_buckets=4)[3])
    if not (abs(sched[2][0] - 0.925) < 1e-9 and sched[2][1] == 1.0
            and abs(sched[3][0] - 0.775) < 1e-9 and abs(sched[3][1] - 0.8) < 1e-9):
        raise AssertionError(f"schedule at epochs 2, 3: {sched}")
    batches = profile_train.synthetic_batches(
        cfg, profile_train.TRAIN_BATCH, 2, SEED + 4)

    def run(impl, count):
        calls = []
        with _recording(qa, calls):
            if count:
                qa.launches = qa.prefix_launches = 0  # the main path starts here
                qa.bwd_rows_launches = qa.bwd_cols_launches = 0
            steps, losses = _run_epochs(
                dataclasses.replace(cfg, attention_impl=impl), tc, sd, batches,
                lambda: _counts(qa), calls, impl)
            counts = _counts(qa)  # the main path ends here
        return steps, losses, counts

    k_steps, losses, counts = run("fused", True)
    walks = {}
    for i, (_, got, calls) in enumerate(k_steps):
        want = STEP_LAUNCHES[i // 2]
        if got != want:
            raise AssertionError(
                f"step {i} (epoch {i // 2}): launches (fwd, prefix fwd, bwd "
                f"rows, bwd cols) {got}, expected {want}")
        walk = walks.setdefault(EPOCH_LABELS[i // 2], calls)
        if walk != calls:
            raise AssertionError(f"the two steps of epoch {i // 2} launched "
                                 "at different geometries")
    log(f"training: phases dense, anneal x3, static; losses per epoch "
        f"{[round(v, 4) for v in losses]}; launches per step as expected; "
        f"totals (fwd, prefix fwd, bwd rows, bwd cols) {counts}")
    # timed after the counted run, which warms the process up
    x1, _, _ = run("xla", False)
    k1, _, _ = run("fused", False)
    k2, _, _ = run("fused", False)
    x2, _, _ = run("xla", False)
    for epoch, label in enumerate(EPOCH_LABELS):
        # the second step of each epoch in each run: the first one runs the
        # epoch's widths for the first time (allocator growth, cuBLAS
        # heuristics)
        k = [s[2 * epoch + 1][0] for s in (k1, k2)]
        p = [s[2 * epoch + 1][0] for s in (x1, x2)]
        first = [s[2 * epoch][0] for s in (k1, k2, x1, x2)]
        widths = sorted({c[2] for c in walks[label]}, reverse=True)
        log(f"train step b128 bf16, epoch {epoch} ({label}; N {widths}): "
            f"kernels {sum(k) / 2:.1f} ms, plain attention {sum(p) / 2:.1f} "
            f"ms (second steps {[round(v, 1) for v in k]} / "
            f"{[round(v, 1) for v in p]}; first steps, kernel, kernel, "
            f"plain, plain: {[round(v, 1) for v in first]})")

    mod = TrainModule(dataclasses.replace(cfg, attention_impl="fused"), tc,
                      "ce", iters_per_epoch=2, device="cuda")
    state = mod.load(sd, seed=SEED)
    calls = []
    with _recording(qa, calls):
        mod.loss_and_grads(state, *batches[0],
                           **profile_train.step_variants(cfg)["hybrid_0.9"])
    torch.cuda.synchronize()
    walks[BUCKET_09] = tuple(calls)
    del state, mod
    torch.cuda.empty_cache()
    return counts, walks


def path_kernels_vs_plain(walks):
    """Phase 9: each distinct launch geometry of the recorded training walks,
    kernel vs plain on a seeded input of that geometry, then both timed in
    turns.  B3 is timed through ``fused_qkv_attention_bwd`` (both kernels
    and the wrapper's allocations and score-cotangent work) against the
    plain backward, and each of its two kernels alone on the wrapper's
    arguments.  Beside each: its bound and, where one exists, the library
    call's time (none for a forward that emits scores or a backward with a
    score cotangent).  Returns ({walk: per-step sums}, {kernel: worst
    error})."""
    from tpat_tpu_torch.ops import qkv_attention as qa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    lib = qa._bwd_library()
    ms, yard = {}, {}
    worst = {"B1": 0.0, "B2": 0.0, "B3": 0.0}
    for call in sorted({c for w in walks.values() for c in w}, key=str):
        kind, b, n, c3, dt, h, mode, extra, kv, has_ds = call
        qkv = torch.randn(b, n, c3, device="cuda", generator=gen).to(dt)
        where = f"B={b} N={n} kv_valid={kv} mode={mode}"
        bnd = bound_ms(*qkv_work(b, n, c3, h, qkv.element_size(), mode, extra,
                                 kv, bwd=kind == "bwd"), dt)
        if kind == "fwd":
            name = "B1" if kv is None else "B2"
            eo, es = _compare(qa, qkv, h, mode, extra, kv)
            worst[name] = max(worst[name], eo, es)
            kern, plain = _fwd_pair(qa, kv)
            with torch.no_grad():
                ms[call] = _turns(lambda: kern(qkv, h, mode, extra),
                                  lambda: plain(qkv, h, mode, extra))
            yard[call] = (bnd, *((None, None) if mode is not None else
                                 library_ms("qkv", qkv, h, kv_valid=kv)))
            log(f"{name} {where}: kernel {ms[call][0]:.4f} ms, plain "
                f"{ms[call][1]:.4f} ms, library {yard[call][1]} ms, bound "
                f"{bnd[0]:.4f} ms ({bnd[1]}); out abs err {eo:.3g}, score abs "
                f"err {es:.3g}")
            continue
        d_out = torch.randn(b, n, c3 // 3, device="cuda", generator=gen).to(dt)
        ds = (n * torch.randn(b, n - extra, device="cuda", generator=gen)
              if has_ds else None)
        worst["B3"] = max(worst["B3"], _compare_bwd(qa, qkv, d_out, ds, h,
                                                    mode, extra, kv))
        pair, plain = _turns(
            lambda: qa.fused_qkv_attention_bwd(qkv, d_out, ds, h, mode, extra,
                                               kv),
            lambda: qa.fused_qkv_attention_bwd_plain(qkv, d_out, ds, h, mode,
                                                     extra, kv))
        args, _dqkv, _keep = qa._bwd_launch_args(qkv, d_out, ds, h, mode,
                                                 extra, kv)
        rows = lambda: lib.tpat_qkv_attention_bwd_rows(*args)  # noqa: E731
        cols = lambda: lib.tpat_qkv_attention_bwd_cols(*args)  # noqa: E731
        if rows() != 0 or cols() != 0:
            raise AssertionError("backward kernel launch failed")
        r, c = _turns(rows, cols)
        ms[call] = (r, c, pair, plain)
        lib_bwd = (None, None) if has_ds else library_ms(
            "qkv", qkv, h, kv_valid=kv, d_out=d_out)
        yard[call] = (bnd, *lib_bwd)
        log(f"B3 {where} score cotangent {has_ds}: rows {r:.4f} + cols "
            f"{c:.4f} ms; through fused_qkv_attention_bwd {pair:.4f} ms, "
            f"plain backward {plain:.4f} ms, library backward {lib_bwd[0]} "
            f"ms ({lib_bwd[1]}), bound {bnd[0]:.4f} ms ({bnd[1]})")
    sums = {}
    for name, walk in walks.items():
        s = {"B1": [0.0, 0.0], "B2": [0.0, 0.0], "B3": [0.0] * 4}
        for key in ("B1", "B2", "B3"):
            s[key + "bound"], s[key + "lib"], s[key + "backends"] = {}, 0.0, set()
        for call in walk:
            key = "B3" if call[0] == "bwd" else "B1" if call[8] is None else "B2"
            s[key] = [a + t for a, t in zip(s[key], ms[call])]
            (bms, by), lib_ms, backend = yard[call]
            s[key + "bound"][by] = s[key + "bound"].get(by, 0.0) + bms
            s[key + "lib"] = (None if lib_ms is None or s[key + "lib"] is None
                              else s[key + "lib"] + lib_ms)
            if backend is not None:
                s[key + "backends"].add(backend)
        sums[name] = s
        b1, b2, b3 = s["B1"], s["B2"], s["B3"]
        log(f"per b128 train step, {name}: B1 {b1[0]:.4f} ms (plain "
            f"{b1[1]:.4f}); B2 {b2[0]:.4f} ms (plain {b2[1]:.4f}); B3 rows "
            f"{b3[0]:.4f} + cols {b3[1]:.4f} ms, through "
            f"fused_qkv_attention_bwd {b3[2]:.4f} ms (plain backward "
            f"{b3[3]:.4f})")
    log("kernel vs plain at the training path's geometries: worst abs err "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
    return sums, worst


ATTENTION_PAIR = ({"attention_impl": "fused"}, {"attention_impl": "xla"})
LAYERNORM_PAIR = ({"use_fused_layernorm": True}, {"use_fused_layernorm": False})


def train_step_f32(sd, pair=ATTENTION_PAIR, what="kernels vs plain attention"):
    """Phase 10 (and 17 with ``LAYERNORM_PAIR``): one f32 train step's loss
    and gradients, the config change ``pair[0]`` (kernels) vs ``pair[1]``
    (plain), same weights and batch, no drop-path, in each step variant of
    ``cli/profile_train.py``."""
    from tpat_tpu_torch.cli import profile_train
    from tpat_tpu_torch.engine.train import TrainModule
    from tpat_tpu_torch.ops import pruning

    cfg, tc = _train_configs("float32", 0.0)
    (x, y), = profile_train.synthetic_batches(cfg, STEP_BATCH_F32, 1,
                                              SEED + 5)
    topk = pruning.topk_select
    picked = []

    def recording_topk(scores, k):
        idx = topk(scores, k)
        picked.append(idx)
        return idx

    pruning.topk_select = recording_topk
    try:
        for name, kw in profile_train.step_variants(cfg).items():
            res = []
            for change in pair:
                c = dataclasses.replace(cfg, **change)
                mod = TrainModule(c, tc, "ce", iters_per_epoch=2, device="cuda")
                state = mod.load(sd, seed=SEED)
                picked.clear()
                loss, grads = mod.loss_and_grads(state, x, y, **kw)
                names = [n for g in state.optimizer.param_groups
                         for n in g["names"]]
                res.append((loss.item(), dict(zip(names, grads)), list(picked)))
            (lf, gf, tf), (lx, gx, tx) = res
            if not abs(lf - lx) <= STEP_LOSS_RTOL * abs(lx):
                raise AssertionError(f"{name}: loss {lf} vs {lx}")
            drops = 0 if kw["phase"] == "dense" else len(cfg.drop_loc)
            if len(tf) != drops or len(tx) != drops:
                raise AssertionError(f"{name}: {len(tf)} / {len(tx)} top-k "
                                     f"calls, expected {drops}")
            kept = [kw["num_left"][i] if "num_left" in kw else None
                    for i in cfg.drop_loc]
            reordered = _same_kept_tokens(name, tf, tx, kept, cfg.num_patches)
            worst = 0.0
            for k, g in gx.items():
                err = (gf[k] - g).abs().max().item()
                scale = g.abs().max().item()
                if not err <= GRAD_F32_REL * scale:
                    raise AssertionError(
                        f"{name}: grad {k} err {err:.3g} > {GRAD_F32_REL} x "
                        f"{scale:.3g}")
                worst = max(worst, err / scale if scale else 0.0)
            log(f"f32 train step, {what}, {name}, b{STEP_BATCH_F32}: loss "
                f"{lf:.6f} vs {lx:.6f} (plain); the same kept tokens at {drops} drop "
                f"blocks (rows ranked in another order, per block: "
                f"{reordered}); {len(gx)} parameter gradients, worst err / "
                f"max|grad| {worst:.3g}")
    finally:
        pruning.topk_select = topk


def _same_kept_tokens(name, picked_f, picked_x, kept, num_patches):
    """Both runs keep the same patch tokens at every drop block.  Each
    top-k call's indices are composed through the earlier gathers into
    original patch ids; the kept ones are the first ``kept`` (the hybrid's
    num_left prefix) or all k (static).  Their sets must be equal.  The
    order inside the set is not compared: two tokens whose scores agree to
    ~1e-6 relative (the kernel's scores differ from plain by that much) may
    rank either way, and a permutation of kept tokens changes no loss or
    gradient, which are compared on their own.  Returns the number of rows
    ranked in another order at each block."""
    ids_f = ids_x = None
    reordered = []
    for block, (jf, jx, k) in enumerate(zip(picked_f, picked_x, kept)):
        if ids_f is None:
            ids_f = ids_x = torch.arange(num_patches, device=jf.device).expand(
                jf.shape[0], -1)
        ids_f, ids_x = ids_f.gather(1, jf), ids_x.gather(1, jx)
        k = ids_f.shape[1] if k is None else k
        a = ids_f[:, :k].sort(dim=1).values
        b = ids_x[:, :k].sort(dim=1).values
        if not torch.equal(a, b):
            raise AssertionError(
                f"{name}: drop block {block}: the kept tokens differ in "
                f"{(a != b).any(1).sum().item()} rows")
        reordered.append((ids_f != ids_x).any(1).sum().item())
    return reordered


# ---------------------------------------------------------------------------
# Phases 12-15: the window kernels and the pretrain path
# ---------------------------------------------------------------------------


def _window_inputs(b, h, d, feat, shift, banded, dt, gen, scale_value=None):
    """A seeded window-attention call on the card: qkv (window-major when
    banded), scales around the model's initial 10 (exp of log 10 +
    N(0, 0.5^2)) or all ``scale_value``, the template or band of a random
    meta-MLP bias with the shift's region mask, and d_out."""
    from tpat_tpu_torch.models.mae import _shift_attn_mask
    from tpat_tpu_torch.ops import window_attention as wa

    n = feat[0] * feat[1]
    qkv = torch.randn(b, n, 3 * h * d, device="cuda", generator=gen).to(dt)
    scale = torch.exp(
        0.5 * torch.randn(h, device="cuda", generator=gen) + math.log(10.0))
    if scale_value is not None:
        scale = torch.full_like(scale, scale_value)
    bias = torch.randn(h, 16, 16, device="cuda", generator=gen)
    mask = _shift_attn_mask(feat, (4, 4), shift)
    if banded:
        tmpl, perm, _ = wa.build_band_template(bias, feat, (4, 4), shift, mask)
        qkv = qkv[:, torch.as_tensor(perm, device="cuda")]
    else:
        tmpl = wa.build_window_template(bias, feat, (4, 4), shift, mask)
    d_out = torch.randn(b, n, h * d, device="cuda", generator=gen).to(dt)
    return qkv.contiguous(), scale, tmpl.contiguous(), d_out


def _window_fns(wa, banded):
    """(kernel forward, plain forward, plain backward) of one form."""
    if banded:
        return (wa.fused_window_attention_banded,
                wa.fused_window_attention_banded_plain,
                wa.fused_window_attention_banded_bwd_plain)
    return (wa.fused_window_attention, wa.fused_window_attention_plain,
            wa.fused_window_attention_bwd_plain)


def _compare_window(wa, qkv, scale, tmpl, d_out, banded, what,
                    f32_atol=F32_ATOL, digest=None) -> tuple:
    """Kernel vs plain, forward and backward, on one input: (forward abs
    err, backward abs err, backward err / max|plain|, the largest over its
    outputs).  The f32 forward within ``f32_atol``, bf16 within BF16_TOL;
    the backward's outputs d_q, d_k, d_v, d_scale and d_template each within
    GRAD_*_REL of the tensor's largest |entry|."""
    kern, plain, plain_bwd = _window_fns(wa, banded)
    with torch.no_grad():
        out, pout = kern(qkv, scale, tmpl), plain(qkv, scale, tmpl)
    torch.cuda.synchronize()
    f32 = qkv.dtype == torch.float32
    e_fwd = (_close(out, pout, f32_atol, 0.0) if f32
             else _close(out, pout, BF16_TOL, BF16_TOL))
    got = wa.window_attention_bwd(qkv, scale, tmpl, d_out, banded)
    want = plain_bwd(qkv, scale, tmpl, d_out)
    torch.cuda.synchronize()
    _fold(digest, out, *got)
    rel = GRAD_F32_REL if f32 else GRAD_BF16_REL
    parts = list(zip(("d_q", "d_k", "d_v"), got[0].chunk(3, -1),
                     want[0].chunk(3, -1)))
    parts += [("d_scale", got[1], want[1]), ("d_template", got[2], want[2])]
    errs = [(_rel_close(g, w, rel, f"{what} {name}"), w.float().abs().max().item())
            for name, g, w in parts]
    return (e_fwd, max(e for e, _ in errs),
            max(e / top if top else 0.0 for e, top in errs))


def window_vs_plain() -> dict:
    """Phase 12: the window kernels vs their plain versions at B=2."""
    from tpat_tpu_torch.ops import window_attention as wa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    digest = hashlib.sha256()
    worst = {"B5 fwd": 0.0, "B5 bwd": 0.0, "B6 fwd": 0.0, "B6 bwd": 0.0}
    rel = {"B5": 0.0, "B6": 0.0}
    count = 0
    for h in (16, 4):
        for banded, ns in ((False, (64, 256)), (True, (128, 512))):
            for n in ns:
                for shift in ((0, 0), (2, 0)):
                    for dt in (torch.float32, torch.bfloat16):
                        what = (f"{'B6' if banded else 'B5'} H={h} N={n} "
                                f"shift={shift} {dt}")
                        args = _window_inputs(2, h, 32, (n // 8, 8), shift,
                                              banded, dt, gen)
                        ef, eb, rb = _compare_window(wa, *args, banded, what,
                                                     digest=digest)
                        key = "B6" if banded else "B5"
                        worst[f"{key} fwd"] = max(worst[f"{key} fwd"], ef)
                        worst[f"{key} bwd"] = max(worst[f"{key} bwd"], eb)
                        if dt == torch.bfloat16:
                            rel[key] = max(rel[key], rb)
                        count += 1
    # at the clamp: a logit's rounding error is the cosine's times the scale,
    # so the f32 forward's atol grows with it from F32_ATOL at the initial
    # scale of 10 (on an H100 it reached 1.1e-5 at scales near 100)
    for banded, n in ((False, 256), (True, 512)):
        for dt in (torch.float32, torch.bfloat16):
            key = "B6" if banded else "B5"
            what = f"{key} H=16 N={n} shift=(2, 0) {dt} scale={SCALE_CLAMP:g}"
            args = _window_inputs(2, 16, 32, (n // 8, 8), (2, 0), banded, dt,
                                  gen, scale_value=SCALE_CLAMP)
            ef, eb, rb = _compare_window(wa, *args, banded, what,
                                         f32_atol=F32_ATOL * SCALE_CLAMP / 10.0,
                                         digest=digest)
            worst[f"{key} fwd"] = max(worst[f"{key} fwd"], ef)
            worst[f"{key} bwd"] = max(worst[f"{key} bwd"], eb)
            if dt == torch.bfloat16:
                rel[f"{key} at the clamp"] = rb
            count += 1
    # a template row with no live entry (uniform p over its window): the
    # tensor-core kernels keep its 16-row query block whole
    for banded, n in ((False, 256), (True, 512)):
        key = "B6" if banded else "B5"
        what = f"{key} H=16 N={n} shift=(2, 0) bf16, row 5 all -1e30"
        qkv, scale, tmpl, d_out = _window_inputs(
            2, 16, 32, (n // 8, 8), (2, 0), banded, torch.bfloat16, gen)
        tmpl[:, 5] = -1e30
        ef, eb, rb = _compare_window(wa, qkv, scale, tmpl, d_out, banded, what,
                                     digest=digest)
        worst[f"{key} fwd"] = max(worst[f"{key} fwd"], ef)
        worst[f"{key} bwd"] = max(worst[f"{key} bwd"], eb)
        rel[f"{key} row without a live entry"] = rb
        count += 1
    log(f"window kernels vs plain at B=2, {count} cases (f32 and bf16): worst "
        "abs err " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
        + "; bf16 backward, worst err / max|plain| over its outputs: "
        + ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
        + f"; the kernel outputs' sha256 {digest.hexdigest()}")
    return worst


def _pretrain_counts(qa, wa) -> tuple:
    return (qa.launches, qa.bwd_rows_launches, qa.bwd_cols_launches,
            wa.launches, wa.banded_launches, wa.bwd_launches,
            wa.banded_bwd_launches)


# per-step launches (B1, B3 rows, B3 cols, B5 fwd, B6 fwd, B5 bwd, B6 bwd)
PRETRAIN_STEP_LAUNCHES = {"AudioSet": (12, 12, 12, 0, 16, 0, 16),
                          "ESC-50": (12, 12, 12, 16, 0, 16, 0)}


@contextlib.contextmanager
def _window_recording(wa, calls):
    """Route the window kernel launchers through a recorder: each launch
    appends (kind, B, N, 3C, dtype, H, banded).  They still count."""
    fwd, bwd = wa._forward_kernel, wa._backward_kernels

    def forward(qkv, scale, template, banded):
        calls.append(("wfwd", *qkv.shape, qkv.dtype, scale.shape[0], banded))
        return fwd(qkv, scale, template, banded)

    def backward(qkv, scale, template, d_out, banded):
        calls.append(("wbwd", *qkv.shape, qkv.dtype, scale.shape[0], banded))
        return bwd(qkv, scale, template, d_out, banded)

    wa._forward_kernel, wa._backward_kernels = forward, backward
    try:
        yield
    finally:
        wa._forward_kernel, wa._backward_kernels = fwd, bwd


def pretrain_path():
    """Phase 13: the MAE pretrain step at full width at each grid, every
    launch counted (per step and in all) and recorded; then the ms per step
    through the kernels and through 'xla', in turns.  Returns ({grid: launch
    counts}, {grid: one step's recorded launches}, {grid: step ms})."""
    from tpat_tpu_torch.cli import profile_pretrain as pp
    from tpat_tpu_torch.ops import qkv_attention as qa
    from tpat_tpu_torch.ops import window_attention as wa

    counts, walks, step_ms = {}, {}, {}
    for tl, grid in PRETRAIN_GRIDS:
        cfg = pp.pretrain_config(tl)
        model, step = pp.build(cfg, seed=SEED)
        x = pp.synthetic_batch(cfg, PRETRAIN_BATCH, seed=SEED + 6)
        pos0 = (model.pos_embed.detach().clone(),
                model.decoder_pos_embed.detach().clone())
        impls = sorted({blk.impl for blk in model.decoder_blocks})
        calls, losses = [], []
        torch.cuda.synchronize()
        with _recording(qa, calls), _window_recording(wa, calls):
            qa.launches = qa.prefix_launches = 0  # the main path starts here
            qa.bwd_rows_launches = qa.bwd_cols_launches = 0
            wa.launches = wa.banded_launches = 0
            wa.bwd_launches = wa.banded_bwd_launches = 0
            total = torch.zeros((), device="cuda")
            for i in range(PRETRAIN_STEPS):
                c0, i0 = _pretrain_counts(qa, wa), len(calls)
                new = step(total, i, x)
                torch.cuda.synchronize()
                losses.append((new - total).item())
                total = new
                got = tuple(a - b for a, b in zip(_pretrain_counts(qa, wa), c0))
                if got != PRETRAIN_STEP_LAUNCHES[grid]:
                    raise AssertionError(
                        f"{grid} step {i}: launches (B1, B3 rows, B3 cols, B5 "
                        f"fwd, B6 fwd, B5 bwd, B6 bwd) {got}, expected "
                        f"{PRETRAIN_STEP_LAUNCHES[grid]}")
                if walks.setdefault(grid, tuple(calls[i0:])) != tuple(calls[i0:]):
                    raise AssertionError(f"{grid}: steps launched at different "
                                         "geometries")
            counts[grid] = _pretrain_counts(qa, wa)  # the main path ends here
        if qa.prefix_launches:
            raise AssertionError(f"{grid}: the prefix kernel ran")
        if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
            raise AssertionError(f"{grid}: losses {losses} not finite and falling")
        if not (torch.equal(model.pos_embed, pos0[0])
                and torch.equal(model.decoder_pos_embed, pos0[1])):
            raise AssertionError(f"{grid}: a frozen pos embed moved")
        del model, step
        torch.cuda.empty_cache()
        log(f"pretrain {grid} grid (target length {tl}, {cfg.num_patches} "
            f"patches, decoder {impls}): losses {[round(v, 5) for v in losses]}; "
            f"launches per step as expected; totals (B1, B3 rows, B3 cols, B5 "
            f"fwd, B6 fwd, B5 bwd, B6 bwd) {counts[grid]}")
        step_ms[grid] = pp.time_steps(tl, PRETRAIN_TIMED)
        torch.cuda.empty_cache()
        log(f"pretrain step b{PRETRAIN_BATCH} bf16 {grid} grid: kernels "
            f"{step_ms[grid]['kernels']:.3f} ms, xla "
            f"{step_ms[grid]['xla']:.3f} ms (mean of two turns of "
            f"{PRETRAIN_TIMED} steps)")
    return counts, walks, step_ms


def pretrain_kernels_vs_plain(walks) -> tuple:
    """Phase 14: each distinct launch geometry of the pretrain walks, kernel
    vs plain on a seeded input of that geometry (bf16, B=32), then kernel and
    plain timed in turns, the library call and the bound beside them.
    Returns ({grid: {kernel: per-step sums}}, {kernel: worst error})."""
    from tpat_tpu_torch.ops import qkv_attention as qa
    from tpat_tpu_torch.ops import window_attention as wa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    per_call, worst = {}, {}
    for call in sorted({c for w in walks.values() for c in w}, key=str):
        backend = None  # the library call's SDPA backend, where it is chosen
        dev = None  # the window forward's device ms (torch.profiler)
        if call[0] in ("fwd", "bwd"):
            kind, b, n, c3, dt, h, mode, extra, kv, has_ds = call
            if mode is not None or kv is not None or has_ds:
                raise AssertionError(f"pretrain launch with scores: {call}")
            qkv = torch.randn(b, n, c3, device="cuda", generator=gen).to(dt)
            bnd = bound_ms(*qkv_work(b, n, c3, h, 2, bwd=kind == "bwd"), dt)
            if kind == "fwd":
                name = "B1"
                err = max(_compare(qa, qkv, h, None, extra))
                with torch.no_grad():
                    k, p = _turns(lambda: qa.fused_qkv_attention(qkv, h, None, extra),
                                  lambda: qa.fused_qkv_attention_plain(qkv, h, None, extra))
                lib, _ = library_ms("qkv", qkv, h)
            else:
                name = "B3"
                d_out = torch.randn(b, n, c3 // 3, device="cuda",
                                    generator=gen).to(dt)
                err = _compare_bwd(qa, qkv, d_out, None, h, None, extra, None)
                k, p = _turns(
                    lambda: qa.fused_qkv_attention_bwd(qkv, d_out, None, h, None, extra),
                    lambda: qa.fused_qkv_attention_bwd_plain(qkv, d_out, None, h, None, extra))
                lib, backend = library_ms("qkv", qkv, h, d_out=d_out)
        else:
            kind, b, n, c3, dt, h, banded = call
            name = ("B6" if banded else "B5") + (" fwd" if kind == "wfwd" else " bwd")
            qkv, scale, tmpl, d_out = _window_inputs(
                b, h, c3 // 3 // h, (n // 8, 8), (2, 0), banded, dt, gen)
            ef, eb, _ = _compare_window(wa, qkv, scale, tmpl, d_out, banded,
                                        f"{name} B={b} N={n}")
            kern, plain, plain_bwd = _window_fns(wa, banded)
            if kind == "wfwd":
                err = ef
                with torch.no_grad():
                    k, p = _turns(lambda: kern(qkv, scale, tmpl),
                                  lambda: plain(qkv, scale, tmpl))
                    dev = _device_ms(lambda: kern(qkv, scale, tmpl))
                lib, backend = library_ms("window", qkv, h, scale=scale,
                                          template=tmpl, banded=banded)
            else:
                err = eb
                k, p = _turns(
                    lambda: wa.window_attention_bwd(qkv, scale, tmpl, d_out, banded),
                    lambda: plain_bwd(qkv, scale, tmpl, d_out))
                lib, backend = library_ms("window", qkv, h, scale=scale,
                                          template=tmpl, banded=banded,
                                          d_out=d_out)
            bnd = bound_ms(*window_work(qkv, tmpl, banded, kind == "wbwd"), dt)
        worst[name] = max(worst.get(name, 0.0), err)
        per_call[call] = (name, k, p, lib, bnd, backend, dev)
        log(f"{name} B={b} N={n} {dt}: kernel {k:.4f} ms"
            f"{f' (device {dev:.4f})' if dev is not None else ''}, plain "
            f"{p:.4f} ms, library {lib:.4f} ms"
            f"{f' ({backend})' if backend else ''}, bound {bnd[0]:.4f} ms "
            f"({bnd[1]}); abs err {err:.3g}")
    sums = {}
    for grid, walk in walks.items():
        s = {}
        for call in walk:
            name, k, p, lib, (bms, by), backend, dev = per_call[call]
            e = s.setdefault(name, {"calls": 0, "ms": 0.0, "plain_ms": 0.0,
                                    "library_ms": 0.0, "bound": {},
                                    "backends": set(), "device_ms": 0.0})
            if backend is not None:
                e["backends"].add(backend)
            if dev is not None:
                e["device_ms"] += dev
            e["calls"] += 1
            e["ms"] += k
            e["plain_ms"] += p
            e["library_ms"] += lib
            e["bound"][by] = e["bound"].get(by, 0.0) + bms
        sums[grid] = s
        log(f"per b{PRETRAIN_BATCH} pretrain step, {grid} grid: " + "; ".join(
            f"{k} x{v['calls']} {v['ms']:.4f} ms (plain {v['plain_ms']:.4f}, "
            f"library {v['library_ms']:.4f}, bound "
            f"{sum(v['bound'].values()):.4f})" for k, v in s.items()))
    return sums, worst


def pretrain_step_f32():
    """Phase 15: one f32 pretrain step's loss and gradients at each grid,
    the window kernels ('auto') vs 'xla', from the same seeded weights and
    batch and the same step generator, so the same masks and dropout."""
    from tpat_tpu_torch.cli import profile_pretrain as pp
    from tpat_tpu_torch.engine import pretrain

    for tl, grid in PRETRAIN_GRIDS:
        res = {}
        for impl in ("auto", "xla"):
            cfg = pp.pretrain_config(tl, impl, "float32")
            model, _ = pp.build(cfg, seed=SEED)
            model.train()
            x = pp.synthetic_batch(cfg, STEP_BATCH_F32, seed=SEED + 7)
            gen = pretrain.step_generator(SEED, 0, "cuda")
            loss, _, _ = model(x, pp.MASK_RATIO, generator=gen,
                               deterministic=False)
            named = [(n, p) for n, p in model.named_parameters()
                     if p.requires_grad]
            grads = torch.autograd.grad(loss, [p for _, p in named])
            res[impl] = (loss.item(), dict(zip((n for n, _ in named), grads)),
                         sorted({blk.impl for blk in model.decoder_blocks}))
            del model
            torch.cuda.empty_cache()
        (lk, gk, ik), (lx, gx, _) = res["auto"], res["xla"]
        if not abs(lk - lx) <= STEP_LOSS_RTOL * abs(lx):
            raise AssertionError(f"{grid}: f32 loss {lk} vs {lx} (xla)")
        worst = 0.0
        for k, g in gx.items():
            err = (gk[k] - g).abs().max().item()
            scale = g.abs().max().item()
            if k.endswith("meta_mlp.fc2.bias"):
                # the sum of d(template): zero in exact arithmetic, noise in
                # both, held by size (tests/test_window_attention.py:61-68)
                if not max(scale, gk[k].abs().max().item()) < 5e-3:
                    raise AssertionError(f"{grid}: {k} not noise-sized")
                continue
            if not err <= GRAD_F32_REL * scale:
                raise AssertionError(f"{grid}: grad {k} err {err:.3g} > "
                                     f"{GRAD_F32_REL} x {scale:.3g}")
            worst = max(worst, err / scale if scale else 0.0)
        log(f"f32 pretrain step, {grid} grid, b{STEP_BATCH_F32}: decoder {ik} "
            f"loss {lk:.7f} vs {lx:.7f} (xla); {len(gx)} parameter gradients, "
            f"worst err / max|grad| {worst:.3g}")


# ---------------------------------------------------------------------------
# Phases 16-19: the LayerNorm kernels (B4) on the finetune and serving paths,
# and the probes (P1-P3)
# ---------------------------------------------------------------------------


def _ln_inputs(m, d, dt, gen):
    """x ~ N(0, 1) in dt, w ~ 1 + N(0, 0.1^2), b ~ N(0, 0.1^2) (f32), dy ~
    N(0, 1) in dt."""
    x = torch.randn(m, d, device="cuda", generator=gen).to(dt)
    w = 1.0 + 0.1 * torch.randn(d, device="cuda", generator=gen)
    b = 0.1 * torch.randn(d, device="cuda", generator=gen)
    dy = torch.randn(m, d, device="cuda", generator=gen).to(dt)
    return x, w, b, dy


def _compare_ln(ln, x, w, b, dy) -> tuple:
    """Kernel vs plain on one input, forward (y, mu, rstd) and backward
    (dx, dw, db from the plain mu and rstd): (forward abs err, backward abs
    err)."""
    what = f"layernorm M={x.shape[0]} D={x.shape[1]} {x.dtype}"
    with torch.no_grad():
        got = ln.layernorm_fwd(x, w, b, LN_EPS)
        want = ln.layernorm_fwd_plain(x, w, b, LN_EPS)
        got_b = ln.layernorm_bwd(x, w, want[1], want[2], dy)
        want_b = ln.layernorm_bwd_plain(x, w, want[1], want[2], dy)
    torch.cuda.synchronize()
    f32 = x.dtype == torch.float32
    tol = (F32_ATOL, 0.0) if f32 else (BF16_TOL, BF16_TOL)
    e_fwd = max(_close(g, p, *tol) for g, p in zip(got, want))
    rel = GRAD_F32_REL if f32 else GRAD_BF16_REL
    e_bwd = max(_rel_close(g, p, rel, f"{what} {name}")
                for name, g, p in zip(("dx", "dw", "db"), got_b, want_b))
    return e_fwd, e_bwd


def layernorm_vs_plain() -> dict:
    """Phase 16: the LayerNorm kernels vs their plain versions at
    M in LN_ROWS, every width of ``ops.layernorm.WIDTHS``, f32 and bf16."""
    from tpat_tpu_torch.ops import layernorm as ln

    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    worst = {"fwd": 0.0, "bwd": 0.0}
    count = 0
    for m in LN_ROWS:
        for d in ln.WIDTHS:
            for dt in (torch.float32, torch.bfloat16):
                ef, eb = _compare_ln(ln, *_ln_inputs(m, d, dt, gen))
                worst = {"fwd": max(worst["fwd"], ef),
                         "bwd": max(worst["bwd"], eb)}
                count += 1
    log(f"layernorm kernels vs plain, {count} cases (M {list(LN_ROWS)}, D "
        f"{list(ln.WIDTHS)}, f32 and bf16): worst abs err forward "
        f"{worst['fwd']:.3g}, backward {worst['bwd']:.3g}")
    return worst


@contextlib.contextmanager
def _ln_recording(ln, calls):
    """Route the LayerNorm kernel launchers through a recorder: each launch
    appends (kind, M, D, dtype).  They still count."""
    fwd, bwd = ln._forward_kernel, ln._backward_kernel

    def forward(x2, w, b, eps):
        calls.append(("lnfwd", *x2.shape, x2.dtype))
        return fwd(x2, w, b, eps)

    def backward(x2, w, mu, rstd, dy):
        calls.append(("lnbwd", *x2.shape, x2.dtype))
        return bwd(x2, w, mu, rstd, dy)

    ln._forward_kernel, ln._backward_kernel = forward, backward
    try:
        yield
    finally:
        ln._forward_kernel, ln._backward_kernel = fwd, bwd


def layernorm_serving(cfg, out_dir) -> tuple:
    """Phase 17, serving: the artifact of phase 4 loaded with
    ``use_fused_layernorm=True`` answers the same requests, 24 LayerNorm
    launches per bucket forward (counted and recorded); then ms per b128
    forward with the flag and without, in turns (off, on, on, off).
    Returns (launches, every recorded launch of every bucket, one b128
    forward's recorded launches)."""
    from tpat_tpu_torch.ops import layernorm as ln
    from tpat_tpu_torch.utils.serving import load_forward

    on, _ = load_forward(out_dir, device="cuda", cfg=dataclasses.replace(
        cfg, use_fused_layernorm=True))
    off, _ = load_forward(out_dir, device="cuda", cfg=cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    requests = {n: torch.randn(n, 1, 512, 128, device="cuda", generator=gen)
                for n in REQUESTS}
    calls, walk = [], None
    torch.cuda.synchronize()
    with _ln_recording(ln, calls):
        ln.launches = ln.bwd_launches = 0  # the main path starts here
        for n, x in requests.items():
            i0 = len(calls)
            y = on(x)
            torch.cuda.synchronize()
            forwards = math.ceil(n / BUCKETS[-1])
            if len(calls) - i0 != 24 * forwards:
                raise AssertionError(
                    f"request of {n}: {len(calls) - i0} layernorm launches, "
                    f"expected {24 * forwards} ({forwards} bucket forwards x "
                    "12 blocks x 2)")
            if y.shape != (n, 50) or not torch.isfinite(y).all():
                raise AssertionError(f"request of {n}: bad logits")
            if n == BUCKETS[-1]:
                walk = tuple(calls[i0:])
        launches = ln.launches  # the main path ends here
    if walk is None:
        raise AssertionError(f"no request filled the b{BUCKETS[-1]} bucket")
    if ln.bwd_launches or launches != len(calls):
        raise AssertionError(f"serving: {launches} forward and "
                             f"{ln.bwd_launches} backward layernorm launches, "
                             f"{len(calls)} recorded")
    x = requests[128]
    ms = {}
    for name, f in (("off", off), ("on", on), ("on", on), ("off", off)):
        ms.setdefault(name, []).append(_time_ms(lambda: f(x), iters=10))
    on_ms, off_ms = sum(ms["on"]) / 2, sum(ms["off"]) / 2
    log(f"serving with use_fused_layernorm: {launches} layernorm launches "
        f"(24 per bucket forward); b128 bf16 forward {on_ms:.3f} ms with the "
        f"flag, {off_ms:.3f} ms without ({128 / on_ms * 1e3:.1f} vs "
        f"{128 / off_ms * 1e3:.1f} clips/s; turns {ms})")
    return launches, tuple(calls), walk


def layernorm_training(sd) -> tuple:
    """Phase 17, training: phase 8's five epochs with
    ``use_fused_layernorm=True``, 24 forward and 24 backward LayerNorm
    launches per step asserted and every launch's (M, D) recorded (the
    counted main path); then in turns without the flag (asserting no
    launch), with it, with it, without, for the ms per step.  Returns
    ((forward, backward) launches, {epoch label: one step's launches})."""
    from tpat_tpu_torch.cli import profile_train
    from tpat_tpu_torch.ops import layernorm as ln

    cfg, tc = _train_configs("bfloat16", 0.1)
    batches = profile_train.synthetic_batches(
        cfg, profile_train.TRAIN_BATCH, 2, SEED + 4)

    def counts():
        return ln.launches, ln.bwd_launches

    def run(flag, count):
        calls = []
        with _ln_recording(ln, calls):
            if count:
                ln.launches = ln.bwd_launches = 0  # the main path starts here
            steps, losses = _run_epochs(
                dataclasses.replace(cfg, use_fused_layernorm=flag), tc, sd,
                batches, counts, calls, f"use_fused_layernorm={flag}")
            total = counts()  # the main path ends here
        want = LN_STEP_LAUNCHES if flag else (0, 0)
        for i, (_, got, _) in enumerate(steps):
            if got != want:
                raise AssertionError(
                    f"use_fused_layernorm={flag}, step {i}: layernorm "
                    f"launches (fwd, bwd) {got}, expected {want}")
        return steps, losses, total

    steps, losses, launches = run(True, True)
    walks = {label: steps[2 * i][2] for i, label in enumerate(EPOCH_LABELS)}
    log(f"training with use_fused_layernorm: losses per epoch "
        f"{[round(v, 4) for v in losses]}; layernorm launches (fwd, bwd) "
        f"{LN_STEP_LAUNCHES} per step as expected, totals {launches}")
    off1, _, _ = run(False, False)
    on1, _, _ = run(True, False)
    on2, _, _ = run(True, False)
    off2, _, _ = run(False, False)
    for epoch, label in enumerate(EPOCH_LABELS):
        k = [s[2 * epoch + 1][0] for s in (on1, on2)]
        p = [s[2 * epoch + 1][0] for s in (off1, off2)]
        log(f"train step b128 bf16, epoch {epoch} ({label}): "
            f"use_fused_layernorm {sum(k) / 2:.1f} ms, plain LayerNorm "
            f"{sum(p) / 2:.1f} ms (second steps {[round(v, 1) for v in k]} / "
            f"{[round(v, 1) for v in p]})")
    return launches, walks


def layernorm_library(x, w, b, dy=None):
    """The yardstick, as a call: ``F.layer_norm`` on the f32 cast followed
    by the cast to x's dtype (the function the kernel computes), or with
    ``dy`` its autograd backward alone.  The port never calls it."""
    d = x.shape[-1]
    if dy is None:
        return lambda: F.layer_norm(x.float(), (d,), w, b, LN_EPS).to(x.dtype)
    xr, wr, br = (t.detach().requires_grad_() for t in (x, w, b))
    out = F.layer_norm(xr.float(), (d,), wr, br, LN_EPS).to(x.dtype)
    return lambda: torch.autograd.grad(out, (xr, wr, br), dy, retain_graph=True)


def _device_ms(fn, iters=20) -> float:
    """Device ms per call of ``fn``: the summed durations of the CUDA kernels
    it launches over ``iters`` calls (``torch.profiler``), without the
    host's gaps between them.  For calls of a few tens of microseconds,
    whose CUDA-event times include the host's launch rate."""
    from torch.profiler import ProfilerActivity, profile

    from tpat_tpu_torch.cli.profile_forward import kernel_rows

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(r["device_ms"] for r in kernel_rows(prof, iters))


def ln_work(m, d, itemsize, bwd) -> tuple:
    """(bytes, f32 operations) a LayerNorm forward or backward needs: x read
    and y written (the backward reads x and dy and writes dx), mu and rstd
    (f32) written or read, the (D,) f32 parameters read and, backward, dw
    and db written.  About 8 operations per element forward, 12 backward."""
    if bwd:
        return 3 * m * d * itemsize + 8 * m + 12 * d, 12 * m * d
    return 2 * m * d * itemsize + 8 * m + 8 * d, 8 * m * d


def layernorm_at_path(geometries, timed) -> tuple:
    """Phase 18: each recorded LayerNorm geometry (every serving bucket and
    training step), kernel vs plain on a seeded input; those in ``timed``
    (B=128) then both timed with CUDA events in turns (each call through its
    wrapper), beside the bound and the library call, and the device time of
    each of the three (``_device_ms``).  Returns ({timed geometry: (ms,
    plain ms, library ms, bound, device ms of the three)}, worst abs err)."""
    from tpat_tpu_torch.ops import layernorm as ln

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    per, worst = {}, 0.0
    timed = set(timed)
    for call in sorted(set(geometries) | timed, key=str):
        kind, m, d, dt = call
        x, w, b, dy = _ln_inputs(m, d, dt, gen)
        ef, eb = _compare_ln(ln, x, w, b, dy)
        bwd = kind == "lnbwd"
        worst = max(worst, eb if bwd else ef)
        if call not in timed:
            continue
        _, mu, rstd = ln.layernorm_fwd_plain(x, w, b, LN_EPS)
        if bwd:
            kern = lambda: ln.layernorm_bwd(x, w, mu, rstd, dy)  # noqa: E731
            plain = lambda: ln.layernorm_bwd_plain(x, w, mu, rstd, dy)  # noqa: E731
        else:
            kern = lambda: ln.layernorm_fwd(x, w, b, LN_EPS)  # noqa: E731
            plain = lambda: ln.layernorm_fwd_plain(x, w, b, LN_EPS)  # noqa: E731
        library = layernorm_library(x, w, b, dy if bwd else None)
        with torch.no_grad():
            k, p = _turns(kern, plain)
            dev = [_device_ms(f) for f in (kern, plain)]
        with torch.no_grad() if not bwd else contextlib.nullcontext():
            lib = _time_ms(library)
            dev.append(_device_ms(library))
        nbytes, ops = ln_work(m, d, x.element_size(), bwd)
        bnd = bound_ms(nbytes, ops, torch.float32)
        per[call] = (k, p, lib, bnd, tuple(dev))
        log(f"layernorm {'bwd' if bwd else 'fwd'} M={m} D={d} {dt}: kernel "
            f"{k:.4f} ms, plain {p:.4f} ms, library {lib:.4f} ms, bound "
            f"{bnd[0]:.4f} ms ({bnd[1]}); device time kernel {dev[0]:.4f}, "
            f"plain {dev[1]:.4f}, library {dev[2]:.4f} ms; abs err "
            f"{eb if bwd else ef:.3g}")
    log(f"layernorm kernels vs plain at {len(set(geometries) | timed)} "
        f"recorded geometries ({len(timed)} timed): worst abs err {worst:.3g}")
    return per, worst


DEVICE_KEYS = ("device_ms", "plain_device_ms", "library_device_ms")


def _sum_walk(per, walk) -> dict:
    """A walk's per-call times summed: ms, plain_ms, library_ms, bound and
    the three device times."""
    s = dict.fromkeys(("ms", "plain_ms", "library_ms") + DEVICE_KEYS, 0.0)
    s["bound"] = {}
    for call in walk:
        k, p, lib, (bms, by), dev = per[call]
        for key, v in zip(("ms", "plain_ms", "library_ms") + DEVICE_KEYS,
                          (k, p, lib) + dev):
            s[key] += v
        s["bound"][by] = s["bound"].get(by, 0.0) + bms
    return s


def ln_matmul_library_ms(x, g, b, w) -> float:
    """The yardstick: ms per call, by CUDA events, of ``F.layer_norm`` (f32
    statistics, cast to x's dtype) followed by ``torch.matmul``.  The port
    never calls it."""
    with torch.no_grad():
        return _time_ms(lambda: torch.matmul(F.layer_norm(
            x.float(), (x.shape[1],), g, b, LN_EPS).to(x.dtype), w))


def _compare_variant(p1, qkv, variant) -> tuple:
    """P1 kernel vs plain on one input: out within F32_ATOL (f32) or
    BF16_TOL for the normalised variants, within UNNORM_F32_REL or
    GRAD_BF16_REL of the largest |entry| for noexp and mmonly; colsum within
    the score tolerance for 'full' and exactly zero otherwise.  Returns (the
    worst abs err, the kernel's out)."""
    what = f"P1 {variant} B={qkv.shape[0]} N={qkv.shape[1]} {qkv.dtype}"
    with torch.no_grad():
        out, colsum = p1.variant_attention(qkv, variant)
        pout, pcol = p1.variant_attention_plain(qkv, variant)
    torch.cuda.synchronize()
    f32 = qkv.dtype == torch.float32
    if variant in ("noexp", "mmonly"):
        err = _rel_close(out, pout, UNNORM_F32_REL if f32 else GRAD_BF16_REL,
                         what)
    else:
        err = (_close(out, pout, F32_ATOL, 0.0) if f32
               else _close(out, pout, BF16_TOL, BF16_TOL))
    if variant == "full":
        err = max(err, _close(colsum, pcol, SCORE_ATOL, SCORE_RTOL))
    elif colsum.shape != pcol.shape or colsum.any():
        raise AssertionError(f"{what}: colsum is not zero")
    return err, out


def sass_check(name: str, kernel: str, needles=("HGMMA", "UTMALDG")):
    """Counts of ``needles`` in the SASS of ``kernel`` (a substring of its
    mangled name) in the built ``csrc/<name>.cu``, by cuobjdump; raises if
    one is missing.  "not checked" where the toolkit has no cuobjdump."""
    from tpat_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        log(f"SASS of {kernel}: not checked (no cuobjdump)")
        return "not checked"
    sass = subprocess.run([tool, "-sass", str(_build.build(name))],
                          capture_output=True, text=True, check=True).stdout
    found = [f for f in sass.split("Function : ")[1:]
             if kernel in f.split(maxsplit=1)[0]]
    if len(found) != 1:
        raise AssertionError(f"no single SASS function of {kernel}")
    counts = {needle: found[0].count(needle) for needle in needles}
    log(f"SASS of {kernel}: {counts}")
    if min(counts.values()) == 0:
        raise AssertionError(f"{kernel}: SASS lacks one of {needles}: {counts}")
    return counts


def _bf16_ulps(t):
    """bf16 values as integers in the order of their values, so that
    neighbouring values differ by 1 (-0 and +0 both 0)."""
    v = t.contiguous().view(torch.int16).int()
    return torch.where(v < 0, -(v & 0x7FFF), v)


def ln_matmul_identity(p3) -> dict:
    """P3 in bf16 with w = I: the product is y itself, so the output is the
    kernel's LayerNorm rounded to bf16 once.  Held to ``p3.ln`` within one
    bf16 ulp at the scale of the larger of |y| and |(x - mu) rstd g|: the
    statistics are summed in another order than torch's (rstd moves by an
    f32 ulp), which moves y by a few f32 ulps of that term, many bf16 ulps
    of a y near 0 where b cancels it.  Logs and returns the share of
    entries that differ and how far, in bf16 ulps of y itself, over a few
    seeded inputs."""
    from tpat_tpu_torch.ops.layernorm import layernorm_fwd_plain  # p3.ln's

    m, k, seeds = P3_IDENTITY
    eye = torch.eye(k, device="cuda", dtype=torch.bfloat16)
    out = dict.fromkeys(("entries", "differ", "over_one_ulp_of_y",
                         "max_ulps_of_y"), 0)
    out["max_abs_y_over_one_ulp"] = 0.0
    for seed in range(SEED + 14, SEED + 14 + seeds):
        x, g, b, _ = p3.inputs(seed, m, k, k, torch.bfloat16)
        with torch.no_grad():
            got = p3.ln_matmul(x, g, b, eye)
            want, mu, rstd = layernorm_fwd_plain(x, g, b, p3.EPS)
        torch.cuda.synchronize()
        ulps = (_bf16_ulps(got) - _bf16_ulps(want)).abs()
        scale = torch.maximum(want.float().abs(),
                              ((x.float() - mu) * rstd * g).abs())
        ulp = torch.exp2(torch.floor(torch.log2(scale.clamp_min(1e-30))) - 7)
        err = (got.float() - want.float()).abs()
        if not torch.isfinite(got.float()).all() or (err > ulp).any():
            raise AssertionError(
                f"P3 w = I, seed {seed}: {int((err > ulp).sum())} entries "
                "further than one bf16 ulp of max(|y|, |(x - mu) rstd g|) "
                "from p3.ln")
        over = ulps > 1
        out["entries"] += got.numel()
        out["differ"] += int((ulps > 0).sum())
        out["over_one_ulp_of_y"] += int(over.sum())
        out["max_ulps_of_y"] = max(out["max_ulps_of_y"], int(ulps.max()))
        if over.any():
            out["max_abs_y_over_one_ulp"] = max(
                out["max_abs_y_over_one_ulp"],
                want.float().abs()[over].max().item())
    out["share_differing"] = out["differ"] / out["entries"]
    log(f"P3 w = I, M={m}, K=N={k}, {seeds} inputs: {out}")
    return out


def _same_bits(got, want, what):
    if not torch.equal(got, want):
        raise AssertionError(
            f"{what}: not the same bits (max abs diff "
            f"{(got.float() - want.float()).abs().max().item():.3g})")


def probe_work(b, n, itemsize, variant) -> tuple:
    """(bytes, FLOPs) of one P1/P2 call at C = 768, H = 12: qkv read, out
    written, the f32 colsum written for 'full'; 4 N^2 D FLOPs per (sample,
    head)."""
    nbytes = itemsize * b * n * 4 * 768 + (4 * b * 12 * n if variant == "full"
                                           else 0)
    return nbytes, 4 * b * 12 * n * n * 64


def probes_vs_plain() -> tuple:
    """Phase 19: P1's six variants vs plain at B=2 (N 33 and 257, f32 and
    bf16) and B=128 (N 257 and 181, bf16); P2's nine geometries vs plain at
    B=2 (N 33 and 257) and B=128 (N 257 and 181), bf16; P3 vs plain at
    ``P3_CASES``, each bf16 case launched three more times for the same
    bits, then with w = I (``ln_matmul_identity``).  In bf16 P1/P2 run
    B1's tensor-core body, so the nine P2 geometries must give P1
    'noscore''s bits at each input, and at B=128 P1 'full' and 'noscore'
    B1's out bits (``fused_qkv_attention`` with patch_mean scores and
    without).  Then each at the probe's shapes (B=128, N=257; P3's M, K,
    N), kernel and plain timed in turns beside the bound and the library
    call.  Returns ({probe: worst abs err}, {probe: times}, P3's w = I
    record)."""
    from tpat_tpu_torch.ops import qkv_attention as qa
    from tpat_tpu_torch.probes import probe_attn_grouping as p2
    from tpat_tpu_torch.probes import probe_attn_softmax as p1
    from tpat_tpu_torch.probes import probe_ln_matmul as p3

    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    bf16 = torch.bfloat16
    worst = {"P1": 0.0, "P2": 0.0, "P3": 0.0}
    inputs = {}
    for b, n, dt in ((2, 33, torch.float32), (2, 33, bf16),
                     (2, 257, torch.float32), (2, 257, bf16), (128, 257, bf16),
                     (128, 181, bf16)):
        qkv = torch.randn(b, n, 3 * p1.C, device="cuda", generator=gen).to(dt)
        inputs[b, n, dt] = qkv
        outs = {}
        for variant in p1.VARIANTS:
            err, outs[variant] = _compare_variant(p1, qkv, variant)
            worst["P1"] = max(worst["P1"], err)
        if dt == bf16:
            what = f"B={b} N={n}"
            with torch.no_grad():
                want = p2.grouped_attention_plain(qkv)
                for rows in p2.ROWS:
                    for heads in p2.HEADS:
                        got = p2.grouped_attention(qkv, rows, heads)
                        worst["P2"] = max(worst["P2"], _close(
                            got, want, BF16_TOL, BF16_TOL))
                        _same_bits(got, outs["noscore"],
                                   f"P2 {rows} rows, {heads} heads vs P1 "
                                   f"noscore, {what}")
                if b == 128:
                    for variant, mode in (("full", "patch_mean"),
                                          ("noscore", None)):
                        b1, _ = qa.fused_qkv_attention(qkv, p1.H, mode, 1)
                        _same_bits(outs[variant], b1,
                                   f"P1 {variant} vs B1 ({mode}), {what}")
    for m, k, n, dt in P3_CASES:
        x, g, b, w = p3.inputs(SEED + 13, m, k, n, dt)
        with torch.no_grad():
            got, want = p3.ln_matmul(x, g, b, w), p3.ln_matmul_plain(x, g, b, w)
            again = [p3.ln_matmul(x, g, b, w) for _ in range(3 if dt == bf16
                                                             else 0)]
        torch.cuda.synchronize()
        tol = (F32_ATOL, F32_ATOL) if dt == torch.float32 else (BF16_TOL, BF16_TOL)
        worst["P3"] = max(worst["P3"], _close(got, want, *tol))
        for i, a in enumerate(again):
            _same_bits(a, got, f"P3 launch {i + 2} at ({m}, {k}, {n})")
    identity = ln_matmul_identity(p3)
    log(f"probes vs plain: 36 P1 cases (6 variants), 36 P2 cases (9 "
        f"geometries), {len(P3_CASES)} P3 cases (each bf16 one the same bits "
        "over four launches): worst abs err " + ", ".join(
            f"{k} {v:.3g}" for k, v in worst.items()) + "; the same bits: "
        "P2's nine geometries and P1 noscore at each of 4 bf16 inputs, P1 "
        "full and noscore and B1 at B=128, N 257 and 181")

    times = {}
    qkv = inputs[128, 257, bf16]
    attention, _ = library_ms("qkv", qkv, p1.H)  # softmax attention, no scores
    for variant in p1.VARIANTS:
        with torch.no_grad():
            k, p = _turns(lambda: p1.variant_attention(qkv, variant),
                          lambda: p1.variant_attention_plain(qkv, variant))
        times[f"P1 {variant}"] = (
            k, p, attention if variant == "noscore" else None,
            bound_ms(*probe_work(128, 257, 2, variant), bf16))
    with torch.no_grad():
        plain = _time_ms(lambda: p2.grouped_attention_plain(qkv))
        for rows in p2.ROWS:
            for heads in p2.HEADS:
                k = _time_ms(lambda: p2.grouped_attention(qkv, rows, heads))
                times[f"P2 {rows} rows, {heads} heads"] = (
                    k, plain, attention,
                    bound_ms(*probe_work(128, 257, 2, None), bf16))
    x, g, b, w = p3.inputs(SEED + 13, p3.M, p3.K, p3.N, bf16)
    with torch.no_grad():
        k, p = _turns(lambda: p3.ln_matmul(x, g, b, w),
                      lambda: p3.ln_matmul_plain(x, g, b, w))
    m, kk, n = p3.M, p3.K, p3.N
    times["P3"] = (k, p, ln_matmul_library_ms(x, g, b, w),
                   bound_ms(2 * (m * kk + kk * n + m * n) + 8 * kk,
                            2 * m * kk * n, bf16))
    for key, (k, p, lib, (bms, by)) in times.items():
        log(f"{key} at the probe's shapes: kernel {k:.4f} ms, plain {p:.4f} "
            f"ms, library {lib} ms, bound {bms:.4f} ms ({by})")
    return worst, times, identity


def probe_mains() -> dict:
    """Phase 19, the probes' main path: each probe's ``main()`` once with
    PROBE_ITERS timed calls per row; returns each probe's launches."""
    from tpat_tpu_torch.probes import probe_attn_grouping as p2
    from tpat_tpu_torch.probes import probe_attn_softmax as p1
    from tpat_tpu_torch.probes import probe_ln_matmul as p3

    p1.launches = p2.launches = p3.launches = 0  # the main path starts here
    for probe in (p1, p2, p3):
        probe.main(iters=PROBE_ITERS)
    launches = {"P1": p1.launches, "P2": p2.launches, "P3": p3.launches}
    log(f"probe mains: launches {launches}")  # the main path ended above
    if min(launches.values()) == 0:
        raise AssertionError(f"a probe launched no kernel: {launches}")
    return launches


def _entry(name, source, replaces, launches, err, ms, plain, bound, lib,
           per, **extra):
    """One kernel's record in the kernels line; ``replaces`` is the TPU
    kernel's repo-relative file:line."""
    bms, by = bound
    return {"name": name, "route": "cuda",
            "source": "tpat_tpu_torch/csrc/" + source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": lib, "per": per,
            **extra}


def main():
    with tempfile.TemporaryDirectory() as tmp:
        run_phases(tmp)


def run_phases(tmp):
    smi = check_device()
    build_kernels()
    grid_err = kernel_vs_plain()
    ms, plain_ms, timed_err, serve_bound = time_kernel()
    cfg, sd, serve_launches, out_dir = serving_path(tmp)
    if serve_launches == 0:
        raise AssertionError("the serving path launched no qkv_attention kernel")
    model_level(cfg, sd)
    prefix_err, bwd_err = prefix_and_bwd_vs_plain()
    train_launches, walks = training_path(sd)
    if min(train_launches) == 0:
        raise AssertionError(f"training launches {train_launches}")
    sums, path_err = path_kernels_vs_plain(walks)
    train_step_f32(sd)
    win_err = window_vs_plain()
    pre_counts, pre_walks, _ = pretrain_path()
    pre_sums, pre_err = pretrain_kernels_vs_plain(pre_walks)
    pretrain_step_f32()
    ln_err = layernorm_vs_plain()
    ln_serve_launches, serve_calls, serve_walk = layernorm_serving(cfg, out_dir)
    ln_train_launches, ln_walks = layernorm_training(sd)
    train_step_f32(sd, LAYERNORM_PAIR, "fused vs plain LayerNorm")
    ln_per, ln_path_err = layernorm_at_path(
        serve_calls,
        [c for walk in (serve_walk, *ln_walks.values()) for c in walk])
    probe_err, probe_times, p3_identity = probes_vs_plain()
    p3_sass = sass_check("ln_matmul", "ln_matmul_bf16_tc_kernel")
    probe_launches = probe_mains()

    audioset, esc50 = pre_counts["AudioSet"], pre_counts["ESC-50"]
    window_launches = {"B5 fwd": esc50[3], "B6 fwd": audioset[4],
                       "B5 bwd": esc50[5], "B6 bwd": audioset[6]}
    if min(window_launches.values()) == 0:
        raise AssertionError(f"window kernel launches {window_launches}")
    step = sums[EPOCH_LABELS[3]]
    per_step = "one b128 bf16 hybrid train step at bucket 0.8"
    bwd = "tpat_tpu/ops/pallas_attention.py:366"
    bwd_note = ("plain_ms, bound_ms and library_ms are of the whole backward, "
                "which the rows and cols kernels compute together; pair_ms is "
                "both kernels through fused_qkv_attention_bwd")
    b3_err = max(bwd_err, path_err["B3"], pre_err["B3"])
    b3 = dict(plain=step["B3"][3], bound=bound_of(step["B3bound"]),
              lib=step["B3lib"], per=per_step, pair_ms=step["B3"][2],
              note=bwd_note,
              library_backend=sorted(step["B3backends"]))
    fwd_build = bf16_build("qkv_attention", "qkv_attention_fwd_bf16_kernel")
    kernels = [
        _entry("qkv_attention_fwd", "qkv_attention.cu", "tpat_tpu/ops/pallas_attention.py:121",
               serve_launches + train_launches[0] + audioset[0] + esc50[0],
               max(grid_err, timed_err, path_err["B1"], pre_err["B1"]),
               ms, plain_ms, bound_of(serve_bound), None,
               "one b128 bf16 serving forward (12 calls)",
               note="3 of the 12 calls (the drop blocks 3, 6, 9) emit "
                    "patch_mean scores, which no library call computes; the "
                    "9 without scores are timed against the library call in "
                    "phase 3",
               **fwd_build),
        _entry("qkv_attention_prefix_fwd", "qkv_attention.cu",
               "tpat_tpu/ops/pallas_attention.py:121", train_launches[1],
               max(prefix_err, path_err["B2"]), step["B2"][0], step["B2"][1],
               bound_of(step["B2bound"]), step["B2lib"], per_step,
               **fwd_build),
        _entry("qkv_attention_bwd_rows", "qkv_attention_bwd.cu", bwd,
               train_launches[2] + audioset[1] + esc50[1], b3_err,
               step["B3"][0], b3["plain"], b3["bound"], b3["lib"], per_step,
               pair_ms=b3["pair_ms"], note=bwd_note,
               library_backend=b3["library_backend"],
               **bf16_build("qkv_attention_bwd",
                            "qkv_attention_bwd_rows_bf16_kernel")),
        _entry("qkv_attention_bwd_cols", "qkv_attention_bwd.cu", bwd,
               train_launches[3] + audioset[2] + esc50[2], b3_err,
               step["B3"][1], b3["plain"], b3["bound"], b3["lib"], per_step,
               pair_ms=b3["pair_ms"], note=bwd_note,
               library_backend=b3["library_backend"],
               **bf16_build("qkv_attention_bwd",
                            "qkv_attention_bwd_cols_bf16_kernel")),
    ]
    for name, key, grid, replaces in (
            ("window_attention_fwd", "B5 fwd", "ESC-50",
             "tpat_tpu/ops/pallas_window_attention.py:457"),
            ("window_attention_bwd", "B5 bwd", "ESC-50",
             "tpat_tpu/ops/pallas_window_attention.py:491"),
            ("window_attention_banded_fwd", "B6 fwd", "AudioSet",
             "tpat_tpu/ops/pallas_window_attention.py:457"),
            ("window_attention_banded_bwd", "B6 bwd", "AudioSet",
             "tpat_tpu/ops/pallas_window_attention.py:222")):
        e = pre_sums[grid][key]
        fwd = key.endswith("fwd")
        build = WINDOW_FWD_BUILD if fwd else WINDOW_BWD_BUILD
        extra = {"library_backend": sorted(e["backends"])}
        if fwd:
            extra.update(device_ms=e["device_ms"], note=WINDOW_FWD_NOTE)
        else:
            extra["note"] = WINDOW_BWD_NOTE
        kernels.append(_entry(
            name, build[0] + ".cu", replaces, window_launches[key],
            max(win_err[key], pre_err[key]), e["ms"], e["plain_ms"],
            bound_of(e["bound"]), e["library_ms"],
            f"one b{PRETRAIN_BATCH} bf16 MAE pretrain step at the {grid} grid "
            f"({e['calls']} calls)", **extra, **build_fields(*build)))
    ln_fwd = _sum_walk(ln_per, serve_walk)
    ln_bwd = _sum_walk(ln_per, [c for c in ln_walks[EPOCH_LABELS[4]]
                                if c[0] == "lnbwd"])
    for name, line, launches, err, e, per in (
            ("layernorm_fwd", 41, ln_serve_launches + ln_train_launches[0],
             max(ln_err["fwd"], ln_path_err), ln_fwd,
             "one b128 bf16 serving forward (24 calls)"),
            ("layernorm_bwd", 53, ln_train_launches[1],
             max(ln_err["bwd"], ln_path_err), ln_bwd,
             "one b128 bf16 static train step (24 calls)")):
        kernels.append(_entry(
            name, "layernorm.cu", f"tpat_tpu/ops/pallas_layernorm.py:{line}",
            launches, err, e["ms"], e["plain_ms"], bound_of(e["bound"]),
            e["library_ms"], per, **{k: e[k] for k in DEVICE_KEYS},
            note="ms, plain_ms and library_ms by CUDA events around each "
                 "call's wrapper, which for calls of tens of microseconds "
                 "include the host's launch rate; the *device_ms fields are "
                 "the summed kernel durations of the same calls "
                 "(torch.profiler)"))

    def probe_entry(name, source, replaces, key, err_key, per, **extra):
        k, p, lib, bnd = probe_times[key]
        return _entry(name, source, replaces, probe_launches[err_key],
                      probe_err[err_key], k, p, bnd, lib, per, **extra)

    def rows(prefix):
        return {key[len(prefix):]: {"ms": k, "plain_ms": p, "library_ms": lib,
                                    "bound_ms": bnd[0]}
                for key, (k, p, lib, bnd) in probe_times.items()
                if key.startswith(prefix)}

    at = "one call at B=128, N=257, bf16"
    variants_build, grouped_build = probe_builds()
    kernels += [
        probe_entry("attn_probe_variants", "attn_probe.cu",
                    "scripts/probe_attn_softmax.py:42", "P1 full", "P1",
                    f"{at}, variant full", variants=rows("P1 "),
                    **variants_build),
        probe_entry("attn_probe_grouped", "attn_probe.cu",
                    "scripts/probe_attn_grouping.py:32", "P2 64 rows, 1 heads",
                    "P2", f"{at}, 64 query rows and 1 head per CTA",
                    geometries=rows("P2 "), **grouped_build),
        probe_entry("ln_matmul", "ln_matmul.cu",
                    "scripts/probe_ln_matmul.py:41", "P3", "P3",
                    "one call at M=32896, K=768, N=2304, bf16",
                    sass=p3_sass, identity=p3_identity,
                    **build_fields("ln_matmul", LN_MATMUL_DESIGN, {
                        "bf16": ("ln_matmul_bf16_tc_kernel",),
                        "f32": ("ln_matmul_f32_kernel",)})),
    ]
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
