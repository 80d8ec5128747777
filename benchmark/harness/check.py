"""The comparison that decides ``correct``: the program's readings of a
round against the reference's, each gap held to its limit.

Every number is a relative gap where the reference's reading is the
denominator. Norms are taken leaf by leaf (a leaf is one named parameter
tensor), and a leaf's gap is the gap between the two sides' norms, not the
norm of their difference, measured against the larger of the reference's
norm of that leaf and of the median leaf: some gradients are all but zero.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Sequence

# A leaf whose reference gradient is under this share of the median leaf's
# at its first live step moves under AdamW by round-off alone (a conv bias
# before BatchNorm, whose mean BatchNorm removes): its change is not compared.
STILL_LEAF = 1e-3


def loss_gap(program: Sequence[float], reference: Sequence[float]) -> float:
    """The worst step's |loss gap| / |reference loss|; 1 where the program
    has fewer steps or a loss that is not finite."""
    if len(program) != len(reference):
        return 1.0
    gaps = [abs(p - r) / abs(r) for p, r in zip(program, reference)]
    return max(g if g == g else 1.0 for g in gaps)


def worst_leaf(program: Dict[str, float], reference: Dict[str, float]) -> float:
    """The worst leaf's |norm gap| / max(its reference norm, the median
    leaf's); a leaf missing on the program's side reads 1."""
    med = statistics.median(reference.values())
    worst = 0.0
    for name, ref in reference.items():
        got = program.get(name)
        gap = 1.0 if got is None or got != got else abs(got - ref) / max(ref, med)
        worst = max(worst, gap)
    return worst


def moving_leaves(first_grads: Sequence[Dict[str, float]]) -> List[str]:
    """Leaves whose reference gradient at their first live step is at least
    ``STILL_LEAF`` of that step's median leaf."""
    out = []
    for grads in first_grads:
        med = statistics.median(grads.values())
        out += [n for n, g in grads.items() if g >= STILL_LEAF * med]
    return out


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every compared number within its limit (and a number at all)."""
    return all(readings.get(k, float("nan")) <= lim for k, lim in limits.items())


def report(readings: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """Each compared number beside its limit. The limits file has to name
    exactly the numbers the driver compares."""
    if set(readings) != set(limits):
        raise ValueError(f"the limits name {sorted(limits)}, the driver compares {sorted(readings)}")
    return {k: {"value": readings[k], "limit": lim} for k, lim in limits.items()}
