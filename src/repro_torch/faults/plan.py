"""Deterministic, seeded fault plans for the control and data planes.

Port of ``repro/faults/plan.py``, unchanged.

A :class:`FaultPlan` is a replayable description of *what goes wrong* in a
run: a seed plus a list of :class:`FaultRule`\\ s addressed by
``(src, dst, verb, nth-match)``.  The same plan against the same workload
injects the same faults — so a chaos failure found by a randomized soak is
reproduced by re-running its logged seed, and a test pins an exact failure
sequence instead of hoping a sleep races the right way.

Rules fire at two injection points:

* **Frames** — :class:`~repro_torch.faults.wrappers.FaultyChannel` consults
  :meth:`frame_actions` for every control-plane message it carries, in
  both directions.  Actions: ``drop`` (the frame vanishes — sensible for
  keepalives; the control verbs assume TCP's reliable-or-dead contract),
  ``delay`` (held ``delay`` seconds, order preserved), ``dup`` (delivered
  twice — handlers must be idempotent), ``reorder`` (swapped with the
  next frame on the link), and ``sever`` (the matching frame *starts a
  timed partition*: for ``window`` seconds every frame in both directions
  is withheld and delivered when the window closes, exactly what a
  transient network partition does to an established TCP stream).
* **Peer fetches** — :meth:`fetch_hook` returns a per-worker callback
  installed into :func:`repro_torch.cluster.serde.peer_fetch`; ``fail_fetch``
  rules make the matched transfer attempt raise ``TransferLost``
  (``nth=N`` fails exactly the Nth matching attempt), ``delay`` rules
  stall it.

Determinism: each rule draws from its own ``random.Random`` seeded by
``(plan seed, rule index)``, and ``nth`` counters are kept per concrete
``(rule, src, dst)`` link — so concurrency elsewhere in the run cannot
perturb which frame a rule hits.  Plans pickle cleanly (state resets in
the new process: a worker's copy counts its own fetch attempts, which is
exactly the addressing the fetch rules use).
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field, replace
from typing import Any, Dict, FrozenSet, List, Optional, Tuple

__all__ = ["FaultRule", "FaultPlan", "ACTIONS"]

ACTIONS = ("drop", "delay", "dup", "reorder", "sever", "fail_fetch")

#: wildcard matching any endpoint / verb
ANY = "*"


@dataclass(frozen=True)
class FaultRule:
    """One addressable fault: *when* frames matching ``(src, dst, verb)``
    pass, fire ``action`` on the ``nth`` match (1-based; ``None`` means
    every match, gated by ``prob``), at most ``count`` times total per
    link (``None`` = unlimited)."""

    action: str
    src: Any = ANY              # "driver", a worker id, or "*"
    dst: Any = ANY
    verb: str = ANY             # frame verb ("done", "hb", ...) or
    #                             "peer_fetch" for data-plane rules
    nth: Optional[int] = None   # fire on the Nth match of this rule
    prob: float = 1.0           # else fire per-match with this probability
    count: Optional[int] = None  # max firings per link (None = unlimited;
    #                              an ``nth`` rule defaults to firing once)
    delay: float = 0.05         # seconds (delay action)
    window: float = 1.0         # partition length in seconds (sever action)

    def __post_init__(self) -> None:
        if self.action not in ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r} "
                             f"(expected one of {ACTIONS})")
        if self.nth is not None and self.nth < 1:
            raise ValueError("nth is 1-based")
        if not 0.0 <= self.prob <= 1.0:
            raise ValueError("prob must be in [0, 1]")

    def matches(self, src: Any, dst: Any, verb: str) -> bool:
        return ((self.src == ANY or self.src == src)
                and (self.dst == ANY or self.dst == dst)
                and (self.verb == ANY or self.verb == verb))


def _link(a: Any, b: Any) -> FrozenSet[Any]:
    return frozenset((a, b))


@dataclass
class FaultPlan:
    """A seeded set of fault rules plus the runtime state that makes them
    deterministic.  Build with the fluent helpers::

        plan = (FaultPlan(seed=7)
                .drop(verb="hb", prob=0.5)
                .sever(src=2, dst="driver", verb="done", nth=2, window=3.0)
                .fail_fetch(dst=1, nth=1))
    """

    seed: int = 0
    rules: List[FaultRule] = field(default_factory=list)

    def __post_init__(self) -> None:
        self._lock = threading.Lock()
        # per-(rule idx, link) match and fire counters
        self._matches: Dict[Tuple[int, FrozenSet[Any]], int] = {}
        self._fired: Dict[Tuple[int, FrozenSet[Any]], int] = {}
        self._rngs: Dict[int, random.Random] = {}
        # active partitions: link -> monotonic end time
        self._severed: Dict[FrozenSet[Any], float] = {}
        self._stats: Dict[str, int] = {}

    # pickling ships the *description*; counters restart in the new
    # process (each process addresses its own injection points)
    def __getstate__(self) -> dict:
        return {"seed": self.seed, "rules": list(self.rules)}

    def __setstate__(self, state: dict) -> None:
        self.seed = state["seed"]
        self.rules = state["rules"]
        self.__post_init__()

    # ------------------------------------------------------ rule builders
    def add(self, rule: FaultRule) -> "FaultPlan":
        self.rules.append(rule)
        return self

    def _mk(self, action: str, **kw: Any) -> "FaultPlan":
        if kw.get("nth") is not None and "count" not in kw:
            kw["count"] = 1     # "the Nth match" fires once by default
        return self.add(FaultRule(action=action, **kw))

    def drop(self, **kw: Any) -> "FaultPlan":
        return self._mk("drop", **kw)

    def delay(self, seconds: float = 0.05, **kw: Any) -> "FaultPlan":
        return self._mk("delay", delay=seconds, **kw)

    def duplicate(self, **kw: Any) -> "FaultPlan":
        return self._mk("dup", **kw)

    def reorder(self, **kw: Any) -> "FaultPlan":
        return self._mk("reorder", **kw)

    def sever(self, window: float = 1.0, **kw: Any) -> "FaultPlan":
        return self._mk("sever", window=window, **kw)

    def fail_fetch(self, **kw: Any) -> "FaultPlan":
        kw.setdefault("verb", "peer_fetch")
        return self._mk("fail_fetch", **kw)

    # -------------------------------------------------------- evaluation
    def _rng(self, idx: int) -> random.Random:
        rng = self._rngs.get(idx)
        if rng is None:
            # rule-scoped stream: cross-channel interleaving cannot shift
            # which draws a rule sees
            rng = self._rngs[idx] = random.Random((self.seed << 16) ^ idx)
        return rng

    def frame_actions(self, src: Any, dst: Any, verb: str
                      ) -> List[FaultRule]:
        """Rules that fire for one frame travelling ``src -> dst``.
        Evaluating is the side effect: match counters advance, ``sever``
        firings open their partition window."""
        fired: List[FaultRule] = []
        with self._lock:
            link = _link(src, dst)
            for idx, rule in enumerate(self.rules):
                if rule.action == "fail_fetch":
                    continue            # fetch rules live in fetch_hook
                if not rule.matches(src, dst, verb):
                    continue
                key = (idx, link)
                n = self._matches[key] = self._matches.get(key, 0) + 1
                if not self._should_fire(rule, idx, key, n):
                    continue
                fired.append(rule)
                if rule.action == "sever":
                    end = time.monotonic() + rule.window
                    if end > self._severed.get(link, 0.0):
                        self._severed[link] = end
                self._stats[rule.action] = \
                    self._stats.get(rule.action, 0) + 1
        return fired

    def _should_fire(self, rule: FaultRule, idx: int,
                     key: Tuple[int, FrozenSet[Any]], n: int) -> bool:
        if rule.count is not None and self._fired.get(key, 0) >= rule.count:
            return False
        if rule.nth is not None:
            if n < rule.nth:
                return False
        elif rule.prob < 1.0 and self._rng(idx).random() >= rule.prob:
            return False
        self._fired[key] = self._fired.get(key, 0) + 1
        return True

    def severed(self, a: Any, b: Any) -> Optional[float]:
        """End time (monotonic) of an active partition on link ``{a, b}``,
        or ``None``.  Partitions are symmetric: a severed link withholds
        frames in both directions."""
        with self._lock:
            end = self._severed.get(_link(a, b))
            if end is not None and end <= time.monotonic():
                del self._severed[_link(a, b)]
                return None
            return end

    def fetch_hook(self, wid: Any):
        """Per-worker callback for :func:`repro_torch.cluster.serde.peer_fetch`:
        called as ``hook(ref, attempt)`` at the top of every fetch attempt
        by worker ``wid``.  ``fail_fetch`` rules raise ``TransferLost``
        (marked ``injected``), ``delay`` rules sleep."""

        def hook(ref: Any, attempt: int) -> None:
            owner = getattr(ref, "wid", ANY)
            fired: List[FaultRule] = []
            with self._lock:
                link = _link(wid, owner)
                for idx, rule in enumerate(self.rules):
                    if rule.action not in ("fail_fetch", "delay"):
                        continue
                    if rule.verb not in (ANY, "peer_fetch"):
                        continue
                    if not rule.matches(wid, owner, "peer_fetch"):
                        continue
                    key = (idx, link)
                    n = self._matches[key] = self._matches.get(key, 0) + 1
                    if self._should_fire(rule, idx, key, n):
                        fired.append(rule)
                        self._stats[rule.action] = \
                            self._stats.get(rule.action, 0) + 1
            for rule in fired:
                if rule.action == "delay":
                    time.sleep(rule.delay)
                else:
                    from repro_torch.cluster.serde import TransferLost
                    e = TransferLost(
                        f"fault injection: peer fetch of task "
                        f"{getattr(ref, 'tid', '?')} from worker {owner} "
                        f"failed (rule {rule})")
                    e.injected = True
                    raise e

        return hook

    def stats(self) -> Dict[str, int]:
        """Fired counts per action — what the plan actually did."""
        with self._lock:
            return dict(self._stats)


def scaled(plan: FaultPlan, prob_scale: float) -> FaultPlan:
    """A copy of ``plan`` with every probabilistic rule's ``prob`` scaled
    (clamped to [0, 1]); ``nth`` rules are left exact.  The knob the bench
    matrix turns to sweep loss/delay intensity without rebuilding rules."""
    out = FaultPlan(seed=plan.seed)
    for r in plan.rules:
        out.add(replace(r, prob=max(0.0, min(1.0, r.prob * prob_scale)))
                if r.nth is None else r)
    return out
