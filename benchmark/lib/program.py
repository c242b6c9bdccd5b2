"""What the drivers share: the config files' arguments for the program,
the check that the program's sizes are the configuration's, the
reference's float32 policy, and the training cells' correctness numbers."""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.lib import compare


def train_numbers(program: Dict, ref: Dict) -> Dict:
    """The finetune and pretrain cells' correctness numbers (each traffic
    file's ``limits`` names those its cell compares)."""
    moved = compare.moved_leaves(ref["grad"])
    large = compare.large_leaves(moved, ref["sizes"])
    return {"loss_gap": compare.loss_gap(program["loss"], ref["loss"]),
            "grad_gap": compare.leaf_gap(program["grad"], ref["grad"]),
            "change_gap": compare.leaf_gap(program["change"], ref["change"],
                                           moved),
            "median_change_gap": compare.median_leaf_gap(
                program["change"], ref["change"], moved),
            "large_leaf_change_gap": compare.leaf_gap(
                program["change"], ref["change"], large)}


def first_moment(optimizer, p) -> torch.Tensor:
    """AdamW's first moment of ``p`` (zeros where the optimizer holds none:
    no update has run)."""
    m = optimizer.state.get(p, {}).get("exp_avg")
    return torch.zeros_like(p) if m is None else m


def leaves(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """{leaf: tensor}.  A packed qkv projection counts as three leaves, its
    q, k and v thirds, as separate projections would: under softmax the
    key bias's gradient is nought to rounding, and the rule on the
    reference's gradient (``compare.moved_leaves``) can then leave it out
    of the change without the q and v biases beside it."""
    out = {}
    for name, t in tensors.items():
        t = t.detach()
        if name.endswith(("qkv.weight", "qkv.bias")):
            for part, third in zip("qkv", t.chunk(3, dim=0)):
                out[f"{name}[{part}]"] = third
        else:
            out[name] = t
    return out


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """{leaf: norm} over ``leaves``."""
    return {n: float(t.norm()) for n, t in leaves(tensors).items()}


def leaf_sizes(tensors: Dict[str, torch.Tensor]) -> Dict[str, int]:
    """{leaf: number of entries} over ``leaves``."""
    return {n: t.numel() for n, t in leaves(tensors).items()}


def tuples(args: Dict) -> Dict:
    """JSON lists to the tuples the config classes take."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in args.items()}


def check_sizes(cfg, sizes: Dict):
    """The program's configuration must be the one the reference and the
    work counts read."""
    for k, v in sizes.items():
        if hasattr(cfg, k):
            got = getattr(cfg, k)
            got = list(got) if isinstance(got, tuple) else got
            if got != v:
                raise ValueError(f"the program's {k} is {got!r}, the "
                                 f"configuration file's {v!r}")


class no_tf32:
    """Full float32 products for the reference (TF32 off), restored on
    exit."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved
