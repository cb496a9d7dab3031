"""The comparison that decides ``correct``: the program's first training
steps against the plain reference's, from the same draws, weights and
dropout seed.

The numbers, each the worst case over steps or leaves:

* ``loss_gap``: over the first three steps, |program loss - reference
  loss| / |reference loss|; ``first_loss_gap`` the first step's alone;
* ``grad_gap``: the gap between the norms of each leaf's first gradient
  as the optimizer received it (program: worked out from its state after
  one update; reference: after clipping), over the larger of the
  reference's norm of that leaf and of the median leaf, since some
  gradients are all but zero;
* ``grad_diff``: the norm of the difference of each leaf's first
  gradient over that leaf's own reference norm, so that a small leaf that
  is wrong reads as wrong as a large one;
* ``change_gap``: as ``grad_gap``, for the norms of each leaf's change
  after three steps; ``change_diff``: as ``grad_diff``, for the change
  (an update of the wrong sign keeps the norms and reads 2 here).

``grad_diff``, ``change_gap`` and ``change_diff`` leave out the leaves
whose first reference gradient is under ``TINY_GRADIENT`` of the median
leaf's: their values are round-off, which the optimizer's normalisation
amplifies into moves of full size.

A cell compares the numbers that ``portbench/limits/<workload>.json``
gives a limit; a number that is not finite fails.
"""
import json
import math
import statistics
from pathlib import Path
from typing import Any, Dict, Iterable

import torch

NUMBERS = ("loss_gap", "first_loss_gap", "grad_gap", "grad_diff",
           "change_gap", "change_diff")
TINY_GRADIENT = 1e-3


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def _norm(x) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def leaf_norms(program: Dict[str, torch.Tensor],
               reference: Dict[str, torch.Tensor]) -> Dict[str, list]:
    """Each leaf's [reference norm, program norm, norm of the
    difference]."""
    return {k: [_norm(reference[k]), _norm(program[k]),
                _norm(program[k].double() - reference[k].double())]
            for k in reference}


def norm_numbers(norms: Dict[str, list], leaves: Iterable[str]):
    """(worst gap of norms over the larger of the leaf's and the median
    leaf's reference norm, worst norm of the difference over the leaf's
    own reference norm), over ``leaves``."""
    leaves = list(leaves)
    median = statistics.median(norms[k][0] for k in norms)
    gap = diff = 0.0
    for k in leaves:
        ref, got, delta = norms[k]
        gap = max(gap, _finite(abs(got - ref) / max(ref, median, 1e-30)))
        diff = max(diff, _finite(delta / max(ref, 1e-30)))
    return gap, diff


def moved_leaves(grad_norms: Dict[str, list]):
    """The leaves whose first reference gradient is at least
    ``TINY_GRADIENT`` of the median leaf's."""
    median = statistics.median(n[0] for n in grad_norms.values())
    return [k for k, n in grad_norms.items()
            if n[0] >= TINY_GRADIENT * median]


def numbers_from_norms(losses, reference_losses, grads: Dict[str, list],
                       changes: Dict[str, list]) -> Dict[str, float]:
    gaps = [_finite(abs(got - want) / max(abs(want), 1e-30))
            for got, want in zip(losses, reference_losses)]
    moved = moved_leaves(grads)
    grad_gap, _ = norm_numbers(grads, grads)
    _, grad_diff = norm_numbers(grads, moved)
    change_gap, change_diff = norm_numbers(changes, moved)
    return {"loss_gap": max(gaps), "first_loss_gap": gaps[0],
            "grad_gap": grad_gap, "grad_diff": grad_diff,
            "change_gap": change_gap, "change_diff": change_diff}


def compare(program: Dict[str, Any],
            reference: Dict[str, Any]) -> Dict[str, float]:
    """Every number from two sets of readings (``losses``, ``grads``,
    ``changes``, as ``train_readings`` gives them)."""
    return numbers_from_norms(
        program["losses"], reference["losses"],
        leaf_norms(program["grads"], reference["grads"]),
        leaf_norms(program["changes"], reference["changes"]))


def load_limits(bench_dir: Path, workload: str) -> Dict[str, float]:
    """The cell's limits, by number (the file's other keys are notes)."""
    limits = json.loads((bench_dir / "limits" / f"{workload}.json")
                        .read_text())
    return {name: float(limits[name]) for name in NUMBERS if name in limits}


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """``({name: {"value", "limit"}}, correct)`` over the numbers that
    have a limit: correct where each is finite and within its limit."""
    values = {name: numbers[name] for name in NUMBERS if name in limits}
    correct = bool(values) and all(
        math.isfinite(v) and v <= limits[name] for name, v in values.items())
    # A number that is not finite is written as text, so the result line
    # stays JSON.
    table = {name: {"value": v if math.isfinite(v) else repr(v),
                    "limit": limits[name]} for name, v in values.items()}
    return table, correct
