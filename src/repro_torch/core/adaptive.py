"""Profile-guided adaptive replanning: the measurement→decision loop.

Port of ``repro/core/adaptive.py``, unchanged: the cost model is plain Python.

Every planning knob in PRs 1–9 was a constant fixed at plan time:
``node.cost`` is in abstract units, ``fusion.fuse``'s fan-in/group gates
are abstract units, ``keep_parallelism`` is a constant, and
``speculate_after`` is one number.  Meanwhile the executor measures
ground truth on every completion — per-cluster wall seconds, per-dispatch
driver overhead, per-value sizes.  This module closes the loop (ROADMAP
item 2): it holds the *policy* state and the *pure decision functions*
shared by the real :class:`repro_torch.cluster.ClusterExecutor` and the offline
:class:`repro_torch.core.simulator.ClusterSim`, so that offline policy search
and the live runtime provably agree (the ``pick_speculation`` pattern
from PR 4, generalized).

Three design rules keep the loop safe:

1. **Decisions are scale-invariant.**  Every decision (re-fusion trigger,
   calibrated fusion gates, derived ``speculate_after``) depends only on
   *ratios* of measured seconds — uniformly scaling all observed
   durations (a faster machine, a slower day) changes no decision.
   ``tests/test_adaptive.py`` pins this as a property.
2. **Decisions never touch values.**  Calibration rescales costs, picks
   placements, and regroups *not-yet-dispatched* clusters; member tasks
   still execute the same pure functions in the same topological order,
   so results stay bit-for-bit equal to ``execute_sequential``.
3. **Decisions are journaled.**  A mid-run re-fusion is appended to the
   run log and replayed verbatim on ``--resume`` — a restarted driver
   reconstructs the exact post-refusion plan before reconciling ``done``
   claims (see ``docs/adaptive.md``).
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "CostModel", "RefuseGovernor", "RunTrace", "fn_key", "refusion_due",
    "MIN_OBS", "MAX_REFUSIONS", "MIN_FRONTIER", "GATE_OVERHEADS",
    "SPEC_AFTER_MIN", "SPEC_AFTER_MAX",
]

# -- policy constants (documented in docs/adaptive.md) -------------------
MIN_OBS = 6          # completions required before any adaptive decision
MAX_REFUSIONS = 3    # hard cap on mid-run re-fusions per incarnation
MIN_FRONTIER = 4     # smallest not-yet-dispatched frontier worth re-fusing
GATE_OVERHEADS = 8.0  # calibrated gate: fuse while cluster compute
#                       seconds stay within this many dispatch overheads
SPEC_AFTER_MIN = 1.5  # derived speculate_after clamp (×expected duration)
SPEC_AFTER_MAX = 8.0


def fn_key(node) -> Optional[str]:
    """Profile key for a task node: the *code identity* of its function.

    Observed duration ratios generalize across tasks by template, not by
    task id — every call of the same function body tends to mis-cost the
    same way.  ``__qualname__`` is stable across processes and resumes
    (unlike ``id(fn)``) and shared by all tasks traced from one def.
    """
    fn = getattr(node, "fn", None)
    if fn is None:
        return None
    return getattr(fn, "__qualname__", None) or getattr(
        fn, "__name__", None)


@dataclasses.dataclass
class CostModel:
    """Calibrates abstract ``node.cost`` units against measured seconds.

    ``observe()`` is fed one completed cluster at a time: the planned
    cost in units and the measured wall seconds.  It maintains

    * ``unit_s`` — EWMA seconds per cost unit (the same 0.9/0.1 blend the
      pre-adaptive executor used for speculation expectations), i.e. the
      global exchange rate between planner units and wall clock;
    * ``fn_ratio`` — per-function-template seconds-per-unit, the
      profile-guided part: a template that runs 60× its declared cost
      keeps that ratio wherever it appears next;
    * a per-observation ratio log, from which the re-fusion trigger
      computes duration *skew* and the speculation auto-tuner computes
      duration *variance* — both as dimensionless ratios.
    """

    alpha: float = 0.1       # EWMA weight for the global unit (PR-4 blend)
    fn_alpha: float = 0.5    # per-template ratios adapt fast (few samples)
    unit_s: Optional[float] = None
    dispatch_s: float = 0.0  # measured mean per-dispatch driver seconds
    n_obs: int = 0
    fn_ratio: Dict[str, float] = dataclasses.field(default_factory=dict)
    ratio_log: List[float] = dataclasses.field(default_factory=list)

    # ------------------------------------------------------- observations
    def observe(self, planned_units: float, wall_s: float,
                fn_units: Tuple[Tuple[Optional[str], float], ...] = (),
                ) -> float:
        """Record one completed cluster.  ``fn_units`` lists the cluster's
        members as ``(fn_key, declared_units)`` pairs; the cluster's wall
        is attributed to each template proportional to its declared share
        (exact for homogeneous clusters and singletons — probes)."""
        ratio = wall_s / max(planned_units, 1e-9)
        self.unit_s = (ratio if self.unit_s is None
                       else (1 - self.alpha) * self.unit_s
                       + self.alpha * ratio)
        self.n_obs += 1
        self.ratio_log.append(ratio)
        for key, units in fn_units:
            if key is None or units <= 0:
                continue
            old = self.fn_ratio.get(key)
            self.fn_ratio[key] = (ratio if old is None
                                  else (1 - self.fn_alpha) * old
                                  + self.fn_alpha * ratio)
        return ratio

    def observe_dispatch(self, total_overhead_s: float,
                         n_dispatched: int) -> None:
        """Refresh the measured per-dispatch cost from the executor's
        running ``dispatch_overhead_s`` / ``dispatched`` counters."""
        if n_dispatched > 0:
            self.dispatch_s = total_overhead_s / n_dispatched

    # ---------------------------------------------------------- exchange
    def seconds(self, units: float) -> float:
        """Planner units → predicted wall seconds (identity uncalibrated)."""
        return units * (self.unit_s if self.unit_s else 1.0)

    def corrected_units(self, node) -> float:
        """Profile-corrected cost of ``node`` in *units*: declared cost
        rescaled by its template's observed ratio relative to the global
        unit.  A template never observed keeps its declared cost.  The
        correction is a ratio of two measured seconds-per-unit figures,
        so a uniform rescale of all observations cancels out."""
        cost = max(getattr(node, "cost", 1.0), 1e-9)
        if not self.unit_s:
            return cost
        r = self.fn_ratio.get(fn_key(node))
        if r is None:
            return cost
        return cost * (r / self.unit_s)

    def fuse_gates(self, base_fanin: float, base_group: float,
                   ) -> Tuple[float, float]:
        """Calibrated fusion cost gates, in (corrected) units.

        The point of fusing is amortizing the per-dispatch control-plane
        round-trip, so the natural gate is "keep fusing while a cluster's
        compute stays within :data:`GATE_OVERHEADS` dispatch overheads".
        Expressed in units that is ``GATE_OVERHEADS × dispatch_s /
        unit_s`` — invariant under uniform time rescaling.  Falls back to
        the static abstract-unit gates until both rates are measured."""
        if not self.unit_s or self.dispatch_s <= 0.0:
            return base_fanin, base_group
        gate = GATE_OVERHEADS * self.dispatch_s / self.unit_s
        return gate, gate

    # ---------------------------------------------------------- variance
    def skew(self, start: int = 0) -> float:
        """Duration skew of observations ``start:``, as max/median of the
        per-cluster seconds-per-unit ratios.  ≈1 when declared costs are
        proportional to the truth; large when some clusters are running
        far over their plan relative to the rest."""
        window = self.ratio_log[start:]
        if len(window) < 2:
            return 1.0
        srt = sorted(window)
        med = srt[len(srt) // 2]
        return srt[-1] / max(med, 1e-12)

    def cv(self) -> float:
        """Coefficient of variation (std/mean) of the observed ratios —
        dimensionless duration variance."""
        n = len(self.ratio_log)
        if n < 2:
            return 0.0
        mean = sum(self.ratio_log) / n
        if mean <= 0:
            return 0.0
        var = sum((r - mean) ** 2 for r in self.ratio_log) / (n - 1)
        return math.sqrt(var) / mean

    def derived_speculate_after(self) -> Optional[float]:
        """Auto-tuned speculation threshold (×expected duration): tight
        when durations are predictable (a straggler stands out quickly),
        loose when natural variance is high (so ordinary spread does not
        burn workers on twins).  ``None`` until enough observations."""
        if self.n_obs < MIN_OBS:
            return None
        return min(SPEC_AFTER_MAX,
                   max(SPEC_AFTER_MIN, SPEC_AFTER_MIN + 2.0 * self.cv()))


@dataclasses.dataclass
class RefuseGovernor:
    """Hysteresis around the re-fusion trigger.

    Fires when the duration skew of observations *since the last fire*
    exceeds ``skew_threshold``.  After a fire (or a no-op fire that left
    the partition unchanged) the window resets, so the governor must see
    :data:`MIN_OBS` fresh completions that are *themselves* skewed before
    acting again — one lopsided historical cluster cannot trigger
    re-fusion forever.  ``MAX_REFUSIONS`` is the hard cap per driver
    incarnation."""

    skew_threshold: float = 4.0
    min_obs: int = MIN_OBS
    max_refusions: int = MAX_REFUSIONS
    fired: int = 0
    window_start: int = 0    # ratio_log index where the current window opens
    last_skew: float = 1.0

    def should_fire(self, model: CostModel) -> bool:
        if self.fired >= self.max_refusions:
            return False
        if model.n_obs - self.window_start < self.min_obs:
            return False
        self.last_skew = model.skew(self.window_start)
        return self.last_skew > self.skew_threshold

    def note_fired(self, model: CostModel) -> None:
        self.fired += 1
        self.window_start = model.n_obs

    def note_no_change(self, model: CostModel) -> None:
        """The trigger fired but re-fusion reproduced the same partition:
        reset the window without spending a fire, so the governor stays
        quiet until genuinely new evidence arrives."""
        self.window_start = model.n_obs


def refusion_due(model: CostModel, governor: RefuseGovernor,
                 n_frontier: int, *, min_frontier: int = MIN_FRONTIER,
                 ) -> bool:
    """The shared re-fusion trigger: enough not-yet-dispatched clusters
    to be worth regrouping, and the governor's skew window open.  Both
    the live executor and :class:`repro_torch.core.simulator.ClusterSim` call
    exactly this predicate (``tests/test_adaptive.py`` pins agreement)."""
    if n_frontier < min_frontier:
        return False
    return governor.should_fire(model)


# -------------------------------------------------------------- run traces

@dataclasses.dataclass
class RunTrace:
    """A recorded execution profile, replayable through the simulator.

    ``tasks`` maps member tid → attributed wall seconds (a cluster's
    measured wall split over its members by declared-cost share), which
    makes the trace *plan-independent*: a candidate policy that fuses the
    graph differently still prices each cluster as the sum of its
    members' recorded seconds.  This is what wires the offline search
    (``hillclimb.py search`` / :func:`repro_torch.core.simulator.search_policy`)
    to live measurements."""

    tasks: Dict[int, float] = dataclasses.field(default_factory=dict)
    n_workers: int = 0
    unit_s: float = 0.0
    dispatch_s: float = 0.0

    def record(self, members, nodes: Dict[int, Any], wall_s: float) -> None:
        """Attribute one completed cluster's wall over its members."""
        total = sum(max(nodes[m].cost, 1e-9) for m in members)
        for m in members:
            self.tasks[m] = wall_s * max(nodes[m].cost, 1e-9) / total

    def cluster_seconds(self, members, nodes: Dict[int, Any]) -> float:
        """Predicted seconds for a (possibly re-fused) cluster: recorded
        member seconds where known, declared cost × recorded unit rate
        otherwise."""
        unit = self.unit_s or 1.0
        return sum(self.tasks.get(m, nodes[m].cost * unit) for m in members)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"tasks": {str(t): s for t, s in self.tasks.items()},
                       "n_workers": self.n_workers, "unit_s": self.unit_s,
                       "dispatch_s": self.dispatch_s}, f)

    @staticmethod
    def load(path: str) -> "RunTrace":
        with open(path) as f:
            raw = json.load(f)
        return RunTrace(
            tasks={int(t): float(s) for t, s in raw["tasks"].items()},
            n_workers=int(raw.get("n_workers", 0)),
            unit_s=float(raw.get("unit_s", 0.0)),
            dispatch_s=float(raw.get("dispatch_s", 0.0)))
