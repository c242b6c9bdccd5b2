"""The numbers that decide ``correct``: gaps between the program's readings
and the reference's.

- ``loss_gap``: the largest relative gap of a step's loss over the checked
  steps.
- ``leaf_gap``: by the worst leaf, the gap between the program's norm of a
  leaf and the reference's (not the norm of their difference), over the
  reference's norm of that leaf or of the median leaf, whichever is
  larger, since some gradients are all but zero.
- ``median_leaf_gap``: the same per-leaf gap, by the median leaf.
- ``large_leaves``: the leaves of ``MIN_ENTRIES`` entries or more, whose
  change the worst leaf is taken over where a smaller leaf's swings.
- ``answer_gaps``: each answer's largest logit gap over the reference's
  largest |logit| of that answer; the serving cell compares the worst and
  the median.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Optional, Sequence

# a leaf whose reference gradient is under this share of the median leaf's
# moves under Adam by round-off alone: it is left out of the change
NOUGHT_GRADIENT = 1e-3
# AdamW's first steps move an entry by about its learning rate, in the
# direction of its gradient's sign, so a leaf's change over a few steps
# turns on the signs of its entries whose gradients lie near zero: the
# norm of a leaf of n entries swings by some 1/sqrt(n) of itself (over 6%
# under 256 entries) between two sound runs
MIN_ENTRIES = 256


def loss_gap(program: Sequence[float], reference: Sequence[float]) -> float:
    return max(abs(p - r) / abs(r) for p, r in zip(program, reference))


def leaf_gap(program: Dict[str, float], reference: Dict[str, float],
             leaves: Optional[Iterable[str]] = None) -> float:
    names = list(reference if leaves is None else leaves)
    median = statistics.median(reference[n] for n in reference)
    return max(abs(program[n] - reference[n]) / max(reference[n], median)
               for n in names)


def median_leaf_gap(program: Dict[str, float], reference: Dict[str, float],
                    leaves: Iterable[str]) -> float:
    """The median over ``leaves`` of ``leaf_gap``'s per-leaf gap: steady
    where one small leaf's round-off makes the worst leaf swing."""
    median = statistics.median(reference[n] for n in reference)
    return statistics.median(abs(program[n] - reference[n])
                             / max(reference[n], median) for n in leaves)


def moved_leaves(ref_grad_norms: Dict[str, float]) -> List[str]:
    """Leaves whose reference gradient is not nought to rounding."""
    median = statistics.median(ref_grad_norms.values())
    return [n for n, g in ref_grad_norms.items() if g >= NOUGHT_GRADIENT * median]


def large_leaves(names: Iterable[str], sizes: Dict[str, int]) -> List[str]:
    """Those of ``names`` with ``MIN_ENTRIES`` entries or more."""
    return [n for n in names if sizes[n] >= MIN_ENTRIES]


def answer_gaps(program, reference):
    """Each answer's gap: the largest gap of its logits over the
    reference's largest |logit| of that answer.  program, reference:
    (answers, classes) numpy arrays."""
    import numpy as np

    scale = np.abs(reference).max(axis=1)
    return np.abs(program - reference).max(axis=1) / scale


def serve_numbers(program, reference) -> Dict[str, float]:
    """The serving cell's numbers: the worst answer's gap, which an answer
    altered where it is produced moves, and the median answer's, which a
    lower precision moves while a few kept tokens that differ near ties of
    the importance do not."""
    import numpy as np

    gaps = answer_gaps(program, reference)
    return {"answer_gap": float(gaps.max()),
            "median_answer_gap": float(np.median(gaps))}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every number is at or under its limit (a NaN fails)."""
    return all(numbers[k] <= limits[k] for k in limits)
