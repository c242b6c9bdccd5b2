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
   compared again and timed with CUDA events;
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
    block.

The line before the last is a JSON object with each kernel's launches (from
the serving and training paths), error and times; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

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
    """Phases 2 and 6: one nvcc per source, all started together."""
    from tpat_tpu_torch.ops import _build

    names = ("qkv_attention", "qkv_attention_bwd")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        libs = list(pool.map(_build.build, names))
    log(f"build: {', '.join(lib.name for lib in libs)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for lib in libs:
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log(f"  ptxas {lib.name.split('.')[0]}: {line.strip()}")


def _close(got, want, atol, rtol) -> float:
    err = (got.float() - want.float()).abs()
    bound = atol + rtol * want.float().abs()
    if not torch.isfinite(got.float()).all() or (err > bound).any():
        raise AssertionError(
            f"kernel disagrees with plain: max abs err {err.max().item():.3g}"
            f" (atol {atol}, rtol {rtol})"
        )
    return err.max().item()


def _fwd_pair(qa, kv):
    """(kernel, plain) forward functions of (qkv, h, mode, extra): the
    plain form when kv is None, else the prefix form at kv_valid = kv."""
    if kv is None:
        return qa.fused_qkv_attention, qa.fused_qkv_attention_plain
    return (lambda qkv, *a: qa.fused_qkv_attention_prefix(qkv, kv, *a),
            lambda qkv, *a: qa.fused_qkv_attention_prefix_plain(qkv, kv, *a))


def _compare(qa, qkv, h, mode, extra, kv=None):
    """Kernel vs plain on one input; returns (out err, score err)."""
    kern, plain = _fwd_pair(qa, kv)
    with torch.no_grad():
        out, s = kern(qkv, h, mode, extra)
        pout, ps = plain(qkv, h, mode, extra)
    torch.cuda.synchronize()
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
    worst = {torch.float32: [0.0, 0.0], torch.bfloat16: [0.0, 0.0]}
    count = {torch.float32: 0, torch.bfloat16: 0}
    cases = [
        (2, h, d, n, mode, extra, dt)
        for h, d, ns in ((12, 64, (257, 181, 127, 90, 258, 129)),
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
        eo, es = _compare(qa, qkv, h, mode, extra)
        worst[dt] = [max(worst[dt][0], eo), max(worst[dt][1], es)]
        count[dt] += 1
    for dt, (eo, es) in worst.items():
        log(f"kernel vs plain, {count[dt]} cases, {dt}: worst out abs err "
            f"{eo:.3g}, worst score abs err {es:.3g}")
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


def time_kernel():
    """Kernel vs plain at B=128 bf16 for each attention call of the serving
    path, then both timed on that input in turns (plain, kernel, kernel,
    plain); returns the per-forward sums and the worst error."""
    from tpat_tpu_torch.ops import qkv_attention as qa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    total_k = total_p = worst = 0.0
    with torch.no_grad():
        for n, mode, calls in PATH_CALLS:
            qkv = torch.randn(128, n, 3 * 768, device="cuda",
                              generator=gen).to(torch.bfloat16)
            eo, es = _compare(qa, qkv, 12, mode, 1)
            worst = max(worst, eo, es)
            kern = lambda: qa.fused_qkv_attention(qkv, 12, mode, 1)  # noqa: E731
            plain = lambda: qa.fused_qkv_attention_plain(qkv, 12, mode, 1)  # noqa: E731
            k, p = _turns(kern, plain)
            log(f"time B=128 N={n} mode={mode}: kernel {k:.4f} ms, plain "
                f"{p:.4f} ms (x{calls} per forward); out abs err {eo:.3g}, "
                f"score abs err {es:.3g}")
            total_k += calls * k
            total_p += calls * p
    log(f"time per b128 forward, all 12 attention calls: kernel "
        f"{total_k:.4f} ms, plain {total_p:.4f} ms")
    return total_k, total_p, worst


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
    return cfg, sd, launches


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
    """max |got - want| <= rel * max |want|, for each of dq, dk and dv."""
    worst = 0.0
    for g, w, part in zip(got.chunk(3, -1), want.chunk(3, -1), "qkv"):
        err = (g.float() - w.float()).abs().max().item()
        scale = w.float().abs().max().item()
        if not torch.isfinite(g.float()).all() or not err <= rel * scale:
            raise AssertionError(
                f"{what} d{part}: kernel vs plain max abs err {err:.3g} > "
                f"{rel} x max|plain| {scale:.3g}")
        worst = max(worst, err)
    return worst


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
        for n in (257, 232, 189, 133, 90, 129, 258):
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


def _timed(batches, steps, qa, calls):
    """Yield the batches, recording each step's ms, launch counts and
    recorded launches."""
    for x, y in batches:
        torch.cuda.synchronize()
        c0, i0, t0 = _counts(qa), len(calls), time.perf_counter()
        yield x, y
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        steps.append((ms, tuple(a - b for a, b in zip(_counts(qa), c0)),
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
    pos0 = sd["pos_embed"].to("cuda")

    def run(impl, count):
        c = dataclasses.replace(cfg, attention_impl=impl)
        mod = TrainModule(c, tc, "ce", iters_per_epoch=2, device="cuda")
        state = mod.load(sd, seed=SEED)
        steps, phases, losses, calls = [], [], [], []
        with _recording(qa, calls):
            if count:
                qa.launches = qa.prefix_launches = 0  # the main path starts here
                qa.bwd_rows_launches = qa.bwd_cols_launches = 0
            for epoch in range(5):
                state, stats = mod.train_epoch(
                    state, _timed(batches, steps, qa, calls), epoch)
                phases.append(stats["phase"])
                losses.append(stats["loss"])
            counts = _counts(qa)  # the main path ends here
        if not torch.equal(state.model.pos_embed, pos0):
            raise AssertionError(f"{impl}: the frozen pos_embed moved")
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{impl}: losses {losses}")
        if phases != ["dense", "anneal", "anneal", "anneal", "static"]:
            raise AssertionError(f"{impl}: phases {phases}")
        del state, mod
        torch.cuda.empty_cache()
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
    arguments.  Returns ({walk: per-step sums}, {kernel: worst error})."""
    from tpat_tpu_torch.ops import qkv_attention as qa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    lib = qa._bwd_library()
    ms = {}
    worst = {"B1": 0.0, "B2": 0.0, "B3": 0.0}
    for call in sorted({c for w in walks.values() for c in w}, key=str):
        kind, b, n, c3, dt, h, mode, extra, kv, has_ds = call
        qkv = torch.randn(b, n, c3, device="cuda", generator=gen).to(dt)
        where = f"B={b} N={n} kv_valid={kv} mode={mode}"
        if kind == "fwd":
            name = "B1" if kv is None else "B2"
            eo, es = _compare(qa, qkv, h, mode, extra, kv)
            worst[name] = max(worst[name], eo, es)
            kern, plain = _fwd_pair(qa, kv)
            with torch.no_grad():
                ms[call] = _turns(lambda: kern(qkv, h, mode, extra),
                                  lambda: plain(qkv, h, mode, extra))
            log(f"{name} {where}: kernel {ms[call][0]:.4f} ms, plain "
                f"{ms[call][1]:.4f} ms; out abs err {eo:.3g}, score abs err "
                f"{es:.3g}")
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
        log(f"B3 {where} score cotangent {has_ds}: rows {r:.4f} + cols "
            f"{c:.4f} ms; through fused_qkv_attention_bwd {pair:.4f} ms, "
            f"plain backward {plain:.4f} ms")
    sums = {}
    for name, walk in walks.items():
        s = {"B1": [0.0, 0.0], "B2": [0.0, 0.0], "B3": [0.0] * 4}
        for call in walk:
            key = "B3" if call[0] == "bwd" else "B1" if call[8] is None else "B2"
            s[key] = [a + t for a, t in zip(s[key], ms[call])]
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


def train_step_f32(sd):
    """Phase 10: one f32 train step's loss and gradients, kernels vs plain
    attention, same weights and batch, no drop-path, in each step variant
    of ``cli/profile_train.py``."""
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
            res = {}
            for impl in ("fused", "xla"):
                c = dataclasses.replace(cfg, attention_impl=impl)
                mod = TrainModule(c, tc, "ce", iters_per_epoch=2, device="cuda")
                state = mod.load(sd, seed=SEED)
                picked.clear()
                loss, grads = mod.loss_and_grads(state, x, y, **kw)
                names = [n for g in state.optimizer.param_groups
                         for n in g["names"]]
                res[impl] = (loss.item(), dict(zip(names, grads)), list(picked))
            (lf, gf, tf), (lx, gx, tx) = res["fused"], res["xla"]
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
            log(f"f32 train step, {name}, b{STEP_BATCH_F32}: loss {lf:.6f} vs "
                f"{lx:.6f} (plain); the same kept tokens at {drops} drop "
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


def main():
    smi = check_device()
    build_kernels()
    grid_err = kernel_vs_plain()
    ms, plain_ms, timed_err = time_kernel()
    with tempfile.TemporaryDirectory() as tmp:
        cfg, sd, serve_launches = serving_path(tmp)
    if serve_launches == 0:
        raise AssertionError("the serving path launched no qkv_attention kernel")
    model_level(cfg, sd)
    prefix_err, bwd_err = prefix_and_bwd_vs_plain()
    train_launches, walks = training_path(sd)
    if min(train_launches) == 0:
        raise AssertionError(f"training launches {train_launches}")
    sums, path_err = path_kernels_vs_plain(walks)
    train_step_f32(sd)

    step = sums[EPOCH_LABELS[3]]
    per_step = "one b128 bf16 hybrid train step at bucket 0.8"
    source = "tpat_tpu_torch/csrc/"
    bwd = "tpat_tpu/ops/pallas_attention.py:366"
    bwd_note = ("plain_ms is the whole plain backward, which the rows and "
                "cols kernels replace together; pair_ms is both kernels "
                "through fused_qkv_attention_bwd")
    log(smi)
    print(json.dumps({"kernels": [
        {"name": "qkv_attention_fwd", "route": "cuda",
         "source": source + "qkv_attention.cu",
         "replaces": "tpat_tpu/ops/pallas_attention.py:121",
         "launches": serve_launches + train_launches[0],
         "max_abs_err": max(grid_err, timed_err, path_err["B1"]), "ms": ms,
         "plain_ms": plain_ms, "per": "one b128 bf16 serving forward"},
        {"name": "qkv_attention_prefix_fwd", "route": "cuda",
         "source": source + "qkv_attention.cu",
         "replaces": "tpat_tpu/ops/pallas_attention.py:121",
         "launches": train_launches[1],
         "max_abs_err": max(prefix_err, path_err["B2"]),
         "ms": step["B2"][0], "plain_ms": step["B2"][1], "per": per_step},
        {"name": "qkv_attention_bwd_rows", "route": "cuda",
         "source": source + "qkv_attention_bwd.cu", "replaces": bwd,
         "launches": train_launches[2],
         "max_abs_err": max(bwd_err, path_err["B3"]), "ms": step["B3"][0],
         "pair_ms": step["B3"][2], "plain_ms": step["B3"][3],
         "per": per_step, "note": bwd_note},
        {"name": "qkv_attention_bwd_cols", "route": "cuda",
         "source": source + "qkv_attention_bwd.cu", "replaces": bwd,
         "launches": train_launches[3],
         "max_abs_err": max(bwd_err, path_err["B3"]), "ms": step["B3"][1],
         "pair_ms": step["B3"][2], "plain_ms": step["B3"][3],
         "per": per_step, "note": bwd_note},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
