"""Two trees' kernels in one call on the card, each tree's own code, in
turns parent, change, change, parent: phase 19 of ``chip_smoke.py`` (the
attention probes P1/P2), or with ``--window`` the window attention B6
(banded) and B5 (dense).

    python3 probe_turns.py <parent tree> [--window] [--out FILE]
    python3 probe_turns.py --phases [--out FILE]
    python3 probe_turns.py --dense-phases [--out FILE]

The parent tree is a ``git archive`` of the parent commit unpacked under a
directory that ``.gitignore`` lists (``build/``).  Each turn is one
process, so that it imports its own tree's ``tpat_tpu_torch``; it calls the
tree's ``chip_smoke.check_device``, ``probes_vs_plain`` and
``probe_builds``, runs each attention probe's ``main()`` at 200 timed calls
a row, and times B1 (``fused_qkv_attention`` without scores and with
'patch_mean' scores) beside P1 'noscore' and 'full' at B = 128, N = 257 and
181, in turns.  With ``--window`` a turn holds B6 forward and backward
against plain at B = 32, N = 512 (the AudioSet grid), H = 16, D = 32, bf16,
shift (2, 0), and B5's at B = 32, N = 256 (the ESC-50 grid), shifts (2, 0)
and (0, 0), records the sha256 of each one's outputs, times each by CUDA
events (the mean of two runs of 20 calls)
and by its kernels' device time (``torch.profiler``), and times phase 13's
AudioSet-grid and ESC-50-grid b32 pretrain steps through the kernels and
through 'xla' (``cli.profile_pretrain.time_steps``).  Every turn's record
goes into one JSON file (default ``build/probe_turns.json``, with
``--window`` ``build/window_turns.json``; ``--out`` names another).

``--dense-phases`` looks into this tree's B5 alone (``build/
window_dense_phases.json``): each kernel's device time by ``torch.profiler``
and by CUDA events around 20 calls queued behind a 20 ms spin of the card,
at the (slices, cluster) the library picks and with the cluster forced to
1, then a copy of ``csrc/window_attention_dense.cu`` with clock64 marks
after each step of both kernels, built and run at B = 32, N = 256, H = 16,
whose first thread per CTA gives the cycles of each step.

``--phases`` looks into this tree's B6 alone (``build/
window_phases.json``): each kernel's device time by ``torch.profiler`` and
by CUDA events around 20 calls queued behind a 20 ms spin of the card (so
that the host's gaps between calls are hidden), at the slices the library
picks and at 1, 4 and 32; then a copy of ``csrc/window_attention_banded.cu``
with clock64 marks after each step of the forward's and the backward's
diagonal loop, built and run at the same shapes, whose first warp per CTA
gives the cycles per sample of each step."""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def turn(tree: str) -> dict:
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    import chip_smoke as cs
    from tpat_tpu_torch.ops import qkv_attention as qa
    from tpat_tpu_torch.probes import probe_attn_grouping as p2
    from tpat_tpu_torch.probes import probe_attn_softmax as p1

    rec = {"tree": tree, "card": cs.check_device()}
    worst, times, _ = cs.probes_vs_plain()
    rec["worst"] = worst
    rec["phase19"] = {k: {"ms": v[0], "plain_ms": v[1], "library_ms": v[2],
                          "bound_ms": v[3][0]} for k, v in times.items()}
    variants, grouped = cs.probe_builds()
    rec["registers"] = {"P1": variants["registers"], "P2": grouped["registers"]}
    rec["spill_bytes"] = {"P1": variants["spill_bytes"],
                          "P2": grouped["spill_bytes"]}
    rec["P1 main"], rec["P2 main"] = p1.main(iters=200), p2.main(iters=200)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 12)
    rec["B1 beside P1"] = {}
    for n in p1.WIDTHS:
        qkv = torch.randn(p1.B, n, 3 * p1.C, device="cuda",
                          generator=gen).to(torch.bfloat16)
        with torch.no_grad():
            for mode, variant in ((None, "noscore"), ("patch_mean", "full")):
                b1, probe = cs._turns(
                    lambda: qa.fused_qkv_attention(qkv, p1.H, mode, 1),
                    lambda: p1.variant_attention(qkv, variant))
                rec["B1 beside P1"][f"N={n} {mode}"] = {
                    "B1_ms": b1, f"P1 {variant}_ms": probe}
    return rec


def window_calls(cs, wa, torch, feat, shift, banded, gen) -> dict:
    """One window form at B = 32, H = 16, D = 32, bf16 on a seeded input:
    kernel vs plain (the forward's max abs err and the backward's, over its
    outputs), the sha256 of the kernels' outputs (out, d_qkv, d_scale,
    d_template; the turns draw the same inputs, so one kernel's bits can be
    held across trees), then each direction's ms by CUDA events (the mean
    of two runs of 20 calls) and its kernels' device ms
    (``torch.profiler``)."""
    import hashlib

    n = feat[0] * feat[1]
    qkv, scale, tmpl, d_out = cs._window_inputs(
        32, 16, 32, feat, shift, banded, torch.bfloat16, gen)
    fwd, bwd = cs._compare_window(wa, qkv, scale, tmpl, d_out, banded,
                                  f"B=32 N={n} shift={shift}")[:2]
    rec = {"max_abs_err": {"fwd": fwd, "bwd": bwd}}
    kern = (wa.fused_window_attention_banded if banded
            else wa.fused_window_attention)
    digest = hashlib.sha256()
    with torch.no_grad():
        for t in (kern(qkv, scale, tmpl),
                  *wa.window_attention_bwd(qkv, scale, tmpl, d_out, banded)):
            digest.update(t.contiguous().cpu().view(torch.uint8).numpy()
                          .tobytes())
    rec["sha256"] = digest.hexdigest()
    calls = {"fwd": lambda: kern(qkv, scale, tmpl),
             "bwd": lambda: wa.window_attention_bwd(qkv, scale, tmpl, d_out,
                                                     banded)}
    with torch.no_grad():
        for name, fn in calls.items():
            rec[f"{name}_ms"] = (cs._time_ms(fn) + cs._time_ms(fn)) / 2
            rec[f"{name}_device_ms"] = cs._device_ms(fn)
    return rec


def window_turn(tree: str) -> dict:
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    import chip_smoke as cs
    from tpat_tpu_torch.cli import profile_pretrain as pp
    from tpat_tpu_torch.ops import window_attention as wa

    rec = {"tree": tree, "card": cs.check_device()}
    cs.build_kernels()  # all of the tree's sources at once
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 9)
    # B6 at the top level, as the records of earlier trees have it
    rec.update(window_calls(cs, wa, torch, (64, 8), (2, 0), True, gen))
    for shift in ((2, 0), (0, 0)):
        rec[f"B5 shift {shift}"] = window_calls(cs, wa, torch, (32, 8), shift,
                                                False, gen)
    rec["step_ms"] = pp.time_steps(1024, cs.PRETRAIN_TIMED)
    rec["esc50_step_ms"] = pp.time_steps(512, cs.PRETRAIN_TIMED)
    return rec


# clock64 marks: after each anchor of a loop, the cycles since the last
# mark are added to that step's sum
MARKS = {
    "fwd": ("  for (int i = x.group, k = 0; i < x.count; i += kGroups, ++k) {\n"
            "    x.take(i, k);\n    uint32_t qh[kD / 16][4], ql[kD / 16][4];\n",
            {"take (wait, copy-out and split, barriers)": "    x.take(i, k);\n",
             "stats sweep": "    stats<false>(m, l, unused, e, cs, dp, qh, ql, nullptr, t, x.band, scale, qb,\n                 x.qlive, lane);\n",
             "p and p.v": "      mma::product_nn<kD>(acc, pa, t.vt, kb * kBlk, lane);\n    }\n",
             "store out": "        x.c, acc, qb * kBlk, kW, 1.f, lane);\n"}),
    "bwd": ("  for (int i = x.group, k = 0; i < x.count; i += kGroups, ++k) {\n"
            "    float2 old[2][2];",
            {"slab load, take": "    x.take(i, k);\n",
             "stats sweep": "    w.rows(m, il, delta, e, cs, dp, qh, ql, da);\n",
             "dlog, dq^, store dq": "                         kW, lane);\n",
             "transposes, dk^, dv, stores": "    mma::store_rows<kD>(dst + 2 * x.c, w.stride, dv, qb * kBlk, kW, 1.f,\n                        lane);\n"}),
}


def instrumented(src: str) -> str:
    """The source with clock64 sums per step in the forward's loop and the
    backward's diagonal loop, written out per CTA by its first warp."""
    src = src.replace(
        "namespace {\n\nusing mma::bf16;",
        "__device__ unsigned long long tpat_cycles[2][1024][8];\n"
        "extern \"C\" int tpat_cycles_read(void* dst) {\n"
        "  return cudaMemcpyFromSymbol(dst, tpat_cycles, sizeof(tpat_cycles));\n}\n"
        "namespace {\n\nusing mma::bf16;", 1)
    for d, (loop, anchors) in MARKS.items():
        at = src.index(loop)
        src = (src[:at] + "  unsigned long long acc_[8] = {0};\n"
               "  unsigned long long last_ = clock64();\n" + src[at:])
        pos = at
        for k, anchor in enumerate(anchors.values()):
            pos = src.index(anchor, pos) + len(anchor)
            mark = ("    { const unsigned long long t_ = clock64(); "
                    f"acc_[{k}] += t_ - last_; last_ = t_; }}\n")
            src = src[:pos] + mark + src[pos:]
        end = src.index("\n  }\n", pos) + len("\n  }\n")
        out = ("  if (threadIdx.x == 0) {\n"
               "    const int cta = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);\n"
               f"    if (cta < 1024) for (int k = 0; k < 7; ++k) tpat_cycles[{int(d == 'bwd')}][cta][k] = acc_[k];\n"
               f"    if (cta < 1024) tpat_cycles[{int(d == 'bwd')}][cta][7] = (x.count + 1) / 2;\n  }}\n")
        src = src[:end] + out + src[end:]
    return src


def phases() -> dict:
    import ctypes
    import subprocess as sp

    import numpy as np
    import torch

    import chip_smoke as cs
    from tpat_tpu_torch.ops import _build
    from tpat_tpu_torch.ops import window_attention as wa

    rec = {"card": cs.check_device()}
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 9)
    qkv, scale, band, d_out = cs._window_inputs(
        32, 16, 32, (64, 8), (2, 0), True, torch.bfloat16, gen)
    calls = {"fwd": lambda: wa.fused_window_attention_banded(qkv, scale, band),
             "bwd": lambda: wa.window_attention_bwd(qkv, scale, band, d_out,
                                                     True)}

    def queued(fn, iters=20):
        torch.cuda._sleep(int(2e7))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    chosen = wa.banded_slices
    with torch.no_grad():
        for slices in (None, 1, 4, 32):
            if slices is not None:
                wa.banded_slices = lambda *args, s=slices: s
            key = f"slices {slices or chosen(32, 512, 16, False, 0)}" + (
                "" if slices else " (the library's)")
            rec[key] = {f"{d}_{m}": f(fn) for d, fn in calls.items()
                        for m, f in (("device_ms", cs._device_ms),
                                     ("queued_ms", queued))}
            print(key, rec[key], flush=True)
        wa.banded_slices = chosen
    src = _build.CSRC / "window_attention_banded.cu"
    path = _build.BUILD_DIR / "window_attention_banded_phases.cu"
    lib = _build.BUILD_DIR / "libwindow_attention_banded_phases.so"
    path.write_text(instrumented(src.read_text()))
    sp.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
            str(lib), str(path)], check=True, capture_output=True)
    load = _build.load
    _build.load = lambda name: ctypes.CDLL(str(lib))
    wa._banded_library.cache_clear()
    cdll = wa._banded_library()
    _build.load = load
    cdll.tpat_cycles_read.argtypes = [ctypes.c_void_p]
    with torch.no_grad():
        for d, fn in calls.items():
            fn()
            torch.cuda.synchronize()
            cycles = np.zeros((2, 1024, 8), np.uint64)
            assert cdll.tpat_cycles_read(cycles.ctypes.data) == 0
            ctas = 64 * chosen(32, 512, 16, d == "bwd", 0)
            per = (cycles[int(d == "bwd"), :ctas, :7].astype(np.float64)
                   / cycles[int(d == "bwd"), :ctas, 7:8].astype(np.float64))
            rec[f"{d} cycles a sample"] = dict(zip(MARKS[d][1], (
                round(float(v), 1) for v in per.mean(0))))
            print(d, rec[f"{d} cycles a sample"], flush=True)
    wa._banded_library.cache_clear()
    return rec


# clock64 marks in window_attention_dense.cu: per direction, the anchor of
# the kernel's start and the anchors after which each step's cycles end
DENSE_MARKS = {
    "fwd": ("  Cta<false> x(smem_raw, &full, a, &qkv_map, nullptr);\n", {
        "constructor (live map scan, slots)":
            "  Cta<false> x(smem_raw, &full, a, &qkv_map, nullptr);\n",
        "take (wait, copy-out and split, barriers)":
            "    x.take(i);\n    uint32_t qh[kD / 16][4], ql[kD / 16][4];\n",
        "stats sweep": "    for (int r = 0; r < 2; ++r) il[r] = 1.f / mma::quad_sum(l[r]);\n",
        "p.v, store out": "        x.c, acc, qb * kBlk, x.n, 1.f, lane);\n"}),
    "bwd": ("  Cta<true> x(smem_raw, &full, a, &qkv_map, &do_map);\n", {
        "constructor (live map scan, slots)":
            "  Cta<true> x(smem_raw, &full, a, &qkv_map, &do_map);\n",
        "zeros, take (wait, copy-out and split, barriers)":
            "  float ds = 0.f;\n  for (int i = 0; i < x.count; ++i) {\n    x.take(i);\n",
        "rows: stats sweep": "          t.drow[row] = delta[r];\n        }\n",
        "rows: dlog, dq^, store dq": "      store_normalised<kD>(dst, stride, dq, t.qhi, t.qlo, t.qfac, qb * kBlk,\n                           n, lane);\n",
        "barrier": "    __syncthreads();  // every row's stats\n",
        "keys: dk^, dv, stores": "      mma::store_rows<kD>(dst + 2 * x.c, stride, dv, kb * kBlk, n, 1.f,\n                          lane);\n"}),
}


def instrumented_dense(src: str) -> str:
    """window_attention_dense.cu with clock64 sums per step of each
    kernel, written out per CTA by its first thread after the sample loop
    (the backward's before its ticket)."""
    src = src.replace(
        "namespace {\n\nusing mma::bf16;",
        "__device__ unsigned long long tpat_cycles[2][1024][8];\n"
        "extern \"C\" int tpat_cycles_read(void* dst) {\n"
        "  return cudaMemcpyFromSymbol(dst, tpat_cycles, sizeof(tpat_cycles));\n}\n"
        "namespace {\n\nusing mma::bf16;", 1)
    for d, (start, anchors) in DENSE_MARKS.items():
        at = src.index(start)
        src = (src[:at] + "  unsigned long long acc_[8] = {0};\n"
               "  unsigned long long last_ = clock64();\n" + src[at:])
        pos = at
        for k, anchor in enumerate(anchors.values()):
            pos = src.index(anchor, pos) + len(anchor)
            mark = ("    { const unsigned long long t_ = clock64(); "
                    f"acc_[{k}] += t_ - last_; last_ = t_; }}\n")
            src = src[:pos] + mark + src[pos:]
        out = ("  if (threadIdx.x == 0) {\n"
               "    const int cta = blockIdx.x + gridDim.x * blockIdx.y;\n"
               f"    if (cta < 1024) for (int k = 0; k < 7; ++k) tpat_cycles[{int(d == 'bwd')}][cta][k] = acc_[k];\n"
               f"    if (cta < 1024) tpat_cycles[{int(d == 'bwd')}][cta][7] = x.count;\n  }}\n")
        if d == "fwd":
            end = src.index("\n  }\n", pos) + len("\n  }\n")
        else:
            end = src.index("  // d_scale: the CTA's partial", pos)
        src = src[:end] + out + src[end:]
    return src


def dense_phases() -> dict:
    """B5 at B = 32, N = 256, H = 16, shift (2, 0): each kernel's device
    and queued ms at the library's (slices, cluster) and with the cluster
    forced to 1 (every CTA scans the whole template); then the cycles per
    CTA of each step of an instrumented copy (the CTA's samples summed)."""
    import ctypes
    import subprocess as sp

    import numpy as np
    import torch

    import chip_smoke as cs
    from tpat_tpu_torch.ops import _build
    from tpat_tpu_torch.ops import window_attention as wa

    rec = {"card": cs.check_device()}
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 9)
    qkv, scale, tmpl, d_out = cs._window_inputs(
        32, 16, 32, (32, 8), (2, 0), False, torch.bfloat16, gen)
    calls = {"fwd": lambda: wa.fused_window_attention(qkv, scale, tmpl),
             "bwd": lambda: wa.window_attention_bwd(qkv, scale, tmpl, d_out,
                                                     False)}

    def queued(fn, iters=20):
        torch.cuda._sleep(int(2e7))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    chosen = wa.dense_slices
    with torch.no_grad():
        for cluster in (None, 1):
            if cluster is not None:
                wa.dense_slices = lambda *args, c=cluster: (
                    chosen(*args)[0], c)
            key = (f"(slices, cluster) {wa.dense_slices(32, 256, 16, False, 0)}"
                   + ("" if cluster else " (the library's)"))
            rec[key] = {f"{d}_{m}": f(fn) for d, fn in calls.items()
                        for m, f in (("device_ms", cs._device_ms),
                                     ("queued_ms", queued))}
            print(key, rec[key], flush=True)
        wa.dense_slices = chosen
    src = _build.CSRC / "window_attention_dense.cu"
    path = _build.BUILD_DIR / "window_attention_dense_phases.cu"
    lib = _build.BUILD_DIR / "libwindow_attention_dense_phases.so"
    path.write_text(instrumented_dense(src.read_text()))
    sp.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
            str(lib), str(path)], check=True, capture_output=True)
    load = _build.load
    _build.load = lambda name: ctypes.CDLL(str(lib))
    wa._dense_library.cache_clear()
    cdll = wa._dense_library()
    _build.load = load
    cdll.tpat_cycles_read.argtypes = [ctypes.c_void_p]
    with torch.no_grad():
        for d, fn in calls.items():
            fn()
            torch.cuda.synchronize()
            cycles = np.zeros((2, 1024, 8), np.uint64)
            assert cdll.tpat_cycles_read(cycles.ctypes.data) == 0
            slices = wa.dense_slices(32, 256, 16, d == "bwd", 0)[0]
            per = cycles[int(d == "bwd"), :16 * slices].astype(np.float64)
            names = list(DENSE_MARKS[d][1])
            rec[f"{d} cycles a CTA"] = dict(zip(names, (
                round(float(v), 1) for v in per[:, :len(names)].mean(0))))
            rec[f"{d} samples a CTA"] = float(per[:, 7].mean())
            print(d, rec[f"{d} cycles a CTA"], flush=True)
    wa._dense_library.cache_clear()
    return rec


def main():
    if "--dense-phases" in sys.argv:
        out = (sys.argv[sys.argv.index("--out") + 1] if "--out" in sys.argv
               else os.path.join(HERE, "build", "window_dense_phases.json"))
        os.chdir(HERE)
        sys.path.insert(0, HERE)
        rec = dense_phases()
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"probe_turns: dense phases into {out}")
        return
    if "--phases" in sys.argv:
        out = (sys.argv[sys.argv.index("--out") + 1] if "--out" in sys.argv
               else os.path.join(HERE, "build", "window_phases.json"))
        os.chdir(HERE)
        sys.path.insert(0, HERE)
        rec = phases()
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"probe_turns: phases into {out}")
        return
    parent = os.path.abspath(sys.argv[1])
    window = "--window" in sys.argv
    out = (sys.argv[sys.argv.index("--out") + 1] if "--out" in sys.argv
           else os.path.join(HERE, "build", "window_turns.json"
                             if window else "probe_turns.json"))
    records = []
    for tree in (parent, HERE, HERE, parent):
        proc = subprocess.run([sys.executable, __file__,
                               "--window-turn" if window else "--turn", tree],
                              capture_output=True, text=True)
        sys.stdout.write(proc.stdout[-4000:])
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-8000:])
            sys.exit(f"probe_turns: the turn in {tree} failed")
        records.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(records, f, indent=1)
    print(f"probe_turns: {len(records)} turns into {out}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--turn"]:
        print(json.dumps(turn(os.path.abspath(sys.argv[2]))))
    elif sys.argv[1:2] == ["--window-turn"]:
        print(json.dumps(window_turn(os.path.abspath(sys.argv[2]))))
    else:
        main()
