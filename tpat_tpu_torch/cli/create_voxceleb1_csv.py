"""The VoxCeleb1 label CSV (copy of ``tpat_tpu/cli/create_voxceleb1_csv.py``):
rows ``{i},/m/vc{i+1:04d},"sid-{i+1:04d}"``.  The reference writes 1252
rows for the 1251 speakers; kept, so index -> name lookups match (the last
row is never referenced).

Usage: python -m tpat_tpu_torch.cli.create_voxceleb1_csv [--out voxceleb1_label.csv]
"""

from __future__ import annotations

import argparse


def create_csv(out: str = "voxceleb1_label.csv", n: int = 1252) -> str:
    with open(out, "w", encoding="utf-8") as f:
        f.write("index,mid,display_name\n")
        for i in range(n):
            f.write(f'{i},/m/vc{i + 1:04d},"sid-{i + 1:04d}"\n')
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="voxceleb1_label.csv")
    args = p.parse_args(argv)
    path = create_csv(args.out)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
