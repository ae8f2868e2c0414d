"""The numbers that decide ``correct``, each compared with its limit.

A training cell compares the program's first steps with the reference's
(``reference/``): each step's loss, the norm of each leaf's first
gradient as the optimizer got it, and the norm of each leaf's change
after the steps. A gap of norms is |‖program‖ − ‖reference‖| over the
larger of the reference leaf's norm and the median leaf's; the number is
the worst leaf's. Leaves whose reference gradient is under a thousandth
of the median leaf's move by round-off alone under Adam and are left out
of the change. The joint cell also compares the label table's change as
a vector.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

#: a leaf moves by more than round-off where its reference gradient is at
#: least this share of the median leaf's
MOVED = 1e-3


def loss_gap(program: Sequence[float], reference: Sequence[float]) -> float:
    """The largest relative gap of the steps' losses."""
    if len(program) != len(reference) or not all(map(math.isfinite,
                                                      program)):
        return math.inf
    return max(abs(p - r) / max(abs(r), 1e-30)
               for p, r in zip(program, reference))


def moved(grad_norms: Dict[str, float]) -> List[str]:
    """Leaves whose reference gradient norm is at least MOVED of the
    median leaf's."""
    median = float(np.median(list(grad_norms.values())))
    return [k for k, v in grad_norms.items() if v >= MOVED * median]


def leaf_gap(program: Dict[str, float], reference: Dict[str, float],
             leaves: Sequence[str] = None) -> float:
    """The worst leaf's |‖p‖ − ‖r‖| / max(‖r‖, median ‖r‖); a leaf the
    program lacks reads as a norm of 0."""
    leaves = list(reference) if leaves is None else list(leaves)
    median = float(np.median([reference[k] for k in leaves]))
    worst = 0.0
    for k in leaves:
        p = program.get(k, 0.0)
        if not math.isfinite(p):
            return math.inf
        worst = max(worst, abs(p - reference[k]) / max(reference[k],
                                                        median, 1e-30))
    return worst


def median_leaf_gap(program: Dict[str, float],
                    reference: Dict[str, float]) -> float:
    """The median over leaves of |‖p‖ − ‖r‖| / max(‖r‖, median ‖r‖): a
    reading that the noise of a few small leaves does not move."""
    median = float(np.median(list(reference.values())))
    gaps = [abs(program.get(k, 0.0) - r) / max(r, median, 1e-30)
            for k, r in reference.items()]
    return float(np.median(gaps)) if all(map(math.isfinite, gaps)) \
        else math.inf


def training_numbers(program: dict, reference: dict) -> Dict[str, float]:
    """The numbers of a training cell's first steps; `program` and
    `reference` hold "losses", "grad_norms" and "change_norms". A cell
    compares those its limits name."""
    return {
        "loss_gap": loss_gap(program["losses"], reference["losses"]),
        "loss_gap_first": loss_gap(program["losses"][:1],
                                   reference["losses"][:1]),
        "grad_gap": leaf_gap(program["grad_norms"],
                             reference["grad_norms"]),
        "grad_gap_median": median_leaf_gap(program["grad_norms"],
                                           reference["grad_norms"]),
        "change_gap": leaf_gap(program["change_norms"],
                               reference["change_norms"],
                               moved(reference["grad_norms"])),
    }


def vector_gap(program: torch.Tensor, reference: torch.Tensor,
               weight: torch.Tensor) -> float:
    """‖program − reference‖ / ‖reference‖ of two changes of one tensor,
    each entry's square weighted by `weight` (the reference's RMS gradient
    of the entry: Adam moves an entry whose gradient is nought to
    rounding by a full step of either sign, and the weight leaves such
    entries out). Unlike a gap of norms it reads a change in the wrong
    direction: a state left unchanged reads 1, a change of the wrong sign
    2."""
    if program.shape != reference.shape or \
            not bool(torch.isfinite(program).all()):
        return math.inf
    p, r, w = program.double(), reference.double(), weight.double()
    return float(torch.sqrt((w * (p - r) ** 2).sum()
                            / max(float((w * r * r).sum()), 1e-300)))


def score_gap(program: np.ndarray, reference: np.ndarray) -> float:
    """The widest gap of a row's scores from the reference's, over the
    root mean square of that row's reference scores."""
    if program.shape != reference.shape or not np.isfinite(program).all():
        return math.inf
    rms = np.sqrt(np.mean(reference.astype(np.float64) ** 2, axis=1))
    gap = np.abs(program.astype(np.float64) - reference).max(axis=1)
    return float((gap / np.maximum(rms, 1e-30)).max())


def entries(numbers: Dict[str, float], limits: Dict[str, float]) -> list:
    """[{"name", "value", "limit"}] in the limits' order; a number with no
    reading fails."""
    return [{"name": k, "value": float(numbers.get(k, math.inf)),
             "limit": float(limit)} for k, limit in limits.items()]


def passed(checks: list) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks)


def worst_leaves(program: dict, reference: dict, n: int = 5) -> dict:
    """For a look at the training numbers: the `n` leaves with the
    largest gaps of the first gradient and of the change, each as
    [leaf, gap, program's norm, reference's norm]."""
    out = {}
    for key, leaves in (("grad_norms", list(reference["grad_norms"])),
                        ("change_norms", moved(reference["grad_norms"]))):
        r = reference[key]
        median = float(np.median([r[k] for k in leaves]))
        rows = [[k, abs(program[key].get(k, 0.0) - r[k]) /
                 max(r[k], median, 1e-30), program[key].get(k, 0.0), r[k]]
                for k in leaves]
        out[key] = sorted(rows, key=lambda x: -x[1])[:n]
    out["losses"] = [program["losses"], reference["losses"]]
    return out
