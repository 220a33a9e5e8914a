"""The comparison that decides ``correct`` for a training cell.

The program's first steps and the reference's, from the same weights on
the same batches, give four numbers:

* ``loss_gap``: the largest gap, in nats, between the two losses of a
  step, over the compared steps;
* ``grad_norm_gap``: the first step's gradient as the optimizer takes it
  (after the clip), leaf by leaf: the gap between the two norms of a leaf
  over the reference's norm of that leaf or of the median leaf, whichever
  is larger, at the worst leaf;
* ``grad_leaf_gap``: the same gap over the reference's norm of that leaf
  alone, at the worst leaf that moves (below): a leaf far under the median
  leaf, such as a scan's A or D, whose gradient a kernel got wrong reads
  small in ``grad_norm_gap`` and, under Adam's normalised step, in
  ``change_norm_gap`` too;
* ``change_norm_gap``: each leaf's change over the compared steps, held
  the same way, over the leaves that move: a leaf whose reference gradient
  is under a thousandth of the median leaf's moves by round-off alone
  under Adam's normalised step, and is left out of this and of
  ``grad_leaf_gap``.

Each cell's limits are in ``limits/<workload>.json``, with the readings
they were set from; a number without a limit there is reported and not
held.
"""
from __future__ import annotations

import json
import math
import os
import statistics
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
NUMBERS = ("loss_gap", "grad_norm_gap", "change_norm_gap", "grad_leaf_gap")
STILL = 1e-3          # a leaf's gradient under this share of the median's


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float],
              keep: Optional[List[str]] = None, own: bool = False
              ) -> Dict[str, float]:
    """Each kept leaf's gap of norms over the reference's norm of it, or
    (``own`` false) of the median kept leaf where that is larger."""
    paths = keep if keep is not None else list(reference)
    floor = 0.0 if own else statistics.median(reference[p] for p in paths)
    return {p: abs(program[p] - reference[p]) / max(reference[p], floor)
            for p in paths}


def moving_leaves(reference: Dict) -> List[str]:
    g = reference["first_grad"]
    median = statistics.median(g.values())
    return [p for p in g if g[p] >= STILL * median]


def numbers(program: Dict, reference: Dict) -> Dict[str, float]:
    """The four numbers of ``program`` against ``reference``, each a dict
    with ``losses`` (one a step), ``first_grad`` and ``change`` ({leaf
    path: norm})."""
    if set(program["first_grad"]) != set(reference["first_grad"]):
        raise ValueError("the program's and the reference's trees differ")
    steps = len(reference["losses"])
    loss_gap = max(abs(a - b) for a, b in zip(program["losses"][:steps],
                                              reference["losses"]))
    moving = moving_leaves(reference)
    return {"loss_gap": loss_gap,
            "grad_norm_gap": max(leaf_gaps(program["first_grad"],
                                           reference["first_grad"]).values()),
            "change_norm_gap": max(leaf_gaps(program["change"],
                                             reference["change"],
                                             moving).values()),
            "grad_leaf_gap": max(leaf_gaps(program["first_grad"],
                                           reference["first_grad"], moving,
                                           own=True).values())}


def limits(workload: str) -> Dict[str, float]:
    with open(os.path.join(HERE, "limits", f"{workload}.json")) as f:
        return json.load(f)["limits"]


def judge(values: Dict[str, float], held: Dict[str, float]
          ) -> Dict[str, Dict]:
    """Each number with its limit (None where it has none) and whether it
    passes; a number that is not finite fails."""
    out = {}
    for name in NUMBERS:
        v, lim = values.get(name), held.get(name)
        ok = v is not None and math.isfinite(v) and (lim is None
                                                     or v <= lim)
        out[name] = {"value": v, "limit": lim, "ok": ok}
    return out
