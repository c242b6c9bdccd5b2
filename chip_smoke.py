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
2. build: nvcc builds ``tpat_tpu_torch/csrc/qkv_attention.cu`` for sm_90a;
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
   (pruning indices exactly equal) and in bf16 at keep 1.0.

The line before the last is a JSON object with the kernel's launches, error
and times; the last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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

# ViT-B/16 ESC-50, keep 0.7 at blocks (3, 6, 9): attention calls per forward
PATH_CALLS = (
    (257, None, 3), (257, "patch_mean", 1),
    (181, None, 2), (181, "patch_mean", 1),
    (127, None, 2), (127, "patch_mean", 1),
    (90, None, 2),
)
REQUESTS = (1, 5, 32, 128, 200)
BUCKETS = (1, 8, 32, 128)


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


def build_kernel():
    from tpat_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.build("qkv_attention")
    log(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")
    report = lib.with_suffix(".log").read_text().splitlines()
    for line in report:
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


def _close(got, want, atol, rtol) -> float:
    err = (got.float() - want.float()).abs()
    bound = atol + rtol * want.float().abs()
    if not torch.isfinite(got.float()).all() or (err > bound).any():
        raise AssertionError(
            f"kernel disagrees with plain: max abs err {err.max().item():.3g}"
            f" (atol {atol}, rtol {rtol})"
        )
    return err.max().item()


def _compare(qa, qkv, h, mode, extra):
    """Kernel vs plain on one input; returns (out err, score err)."""
    with torch.no_grad():
        out, s = qa.fused_qkv_attention(qkv, h, mode, extra)
        pout, ps = qa.fused_qkv_attention_plain(qkv, h, mode, extra)
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
            p1, k1, k2, p2 = (_time_ms(plain), _time_ms(kern),
                              _time_ms(kern), _time_ms(plain))
            k, p = (k1 + k2) / 2, (p1 + p2) / 2
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


def main():
    smi = check_device()
    build_kernel()
    grid_err = kernel_vs_plain()
    ms, plain_ms, timed_err = time_kernel()
    max_err = max(grid_err, timed_err)
    with tempfile.TemporaryDirectory() as tmp:
        cfg, sd, launches = serving_path(tmp)
    if launches == 0:
        raise AssertionError("the serving path launched no qkv_attention kernel")
    model_level(cfg, sd)

    log(smi)
    print(json.dumps({"kernels": [{
        "name": "qkv_attention_fwd",
        "route": "cuda",
        "source": "tpat_tpu_torch/csrc/qkv_attention.cu",
        "replaces": "tpat_tpu/ops/pallas_attention.py:121",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
