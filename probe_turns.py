"""Phase 19 of ``chip_smoke.py`` for two trees in one call on the card: the
attention probes P1/P2 of this tree against those of a parent tree, each
tree's own code, in turns parent, change, change, parent.

    python3 probe_turns.py <parent tree> [--out chiprun_out/probe_turns.json]

The parent tree is a ``git archive`` of the parent commit unpacked under a
directory that ``.gitignore`` lists (``build/``).  Each turn is one
process, so that it imports its own tree's ``tpat_tpu_torch``; it calls the
tree's ``chip_smoke.check_device``, ``probes_vs_plain`` and
``probe_builds``, runs each attention probe's ``main()`` at 200 timed calls
a row, and times B1 (``fused_qkv_attention`` without scores and with
'patch_mean' scores) beside P1 'noscore' and 'full' at B = 128, N = 257 and
181, in turns.  Every turn's record goes into one JSON file."""

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


def main():
    parent = os.path.abspath(sys.argv[1])
    out = (sys.argv[sys.argv.index("--out") + 1] if "--out" in sys.argv
           else os.path.join(HERE, "chiprun_out", "probe_turns.json"))
    records = []
    for tree in (parent, HERE, HERE, parent):
        proc = subprocess.run([sys.executable, __file__, "--turn", tree],
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
    else:
        main()
