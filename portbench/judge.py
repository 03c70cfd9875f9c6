"""The numbers that decide ``correct``, each held against its cell's limit.

Training (``TrainReadings`` of the program and of the reference):

* ``loss_gap``: the largest ``|program - reference| / |reference|`` of
  the steps' losses;
* ``grad_gap``: over the leaves, the largest gap between the program's and
  the reference's norm of the first step's gradient as the optimizer took
  it (each read from its own state after that step), over the reference's
  norm of that leaf or of the median leaf, whichever is larger;
* ``change_gap``: the same for the norm of each leaf's change over the
  steps, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's (they move by round-off alone).

Scoring: ``pctr_gap``, the largest ``|program - reference|`` of a pCTR
over the sampled batches.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

import torch

from portbench.reference import TrainReadings, norm

STILL = 1e-3        # a leaf's gradient under STILL x the median leaf's: not compared


def _gaps(prog: Dict[str, float], ref: Dict[str, float], leaves) -> Dict[str, float]:
    leaves = list(leaves)
    floor = statistics.median(ref[k] for k in leaves)
    return {k: abs(prog.get(k, math.inf) - ref[k]) / max(ref[k], floor) for k in leaves}


def _worst(gaps: Dict[str, float]) -> float:
    return max(gaps.values(), key=lambda g: math.inf if math.isnan(g) else g)


def moved_leaves(ref: TrainReadings) -> List[str]:
    """The leaves whose change is compared."""
    floor = statistics.median(ref.grad.values())
    return [k for k, g in ref.grad.items() if g >= STILL * floor]


def train_numbers(prog: TrainReadings, ref: TrainReadings) -> Dict[str, float]:
    if len(prog.losses) != len(ref.losses):
        loss_gap = math.inf
    else:
        loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog.losses, ref.losses))
    return {"loss_gap": loss_gap,
            "grad_gap": _worst(_gaps(prog.grad, ref.grad, ref.grad)),
            "change_gap": _worst(_gaps(prog.change, ref.change, moved_leaves(ref)))}


def train_detail(prog: TrainReadings, ref: TrainReadings) -> str:
    """The gap of every leaf, for the run's log."""
    lines = []
    for what, gaps in (("grad", _gaps(prog.grad, ref.grad, ref.grad)),
                       ("change", _gaps(prog.change, ref.change, moved_leaves(ref)))):
        lines.append(f"{what} gaps by leaf: " + " ".join(
            f"{k}={g:.3e}" for k, g in sorted(gaps.items(), key=lambda kv: -kv[1])))
    return "\n".join(lines)


def score_numbers(prog: List[torch.Tensor], ref: List[torch.Tensor]) -> Dict[str, float]:
    gap = 0.0
    for p, r in zip(prog, ref):
        if p.shape != r.shape:
            return {"pctr_gap": math.inf}
        d = float(torch.max(torch.abs(p.to(torch.float64) - r.to(torch.float64))))
        gap = d if (d > gap or math.isnan(d)) else gap
    return {"pctr_gap": gap}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """Whether every number is within its limit (a missing or NaN number is
    not), and ``{name: {"value", "limit"}}`` in the limits' order."""
    ok, shown = True, {}
    for name, limit in limits.items():
        value = numbers.get(name, math.nan)
        ok = ok and value <= limit
        shown[name] = {"value": value, "limit": limit}
    return ok, shown
