"""Deterministic fault injection + the policies that survive it.

Port of ``repro/faults/__init__.py``, unchanged: fault injection is plain Python.

The network between driver and workers is no longer assumed
perfect-or-dead: this package makes every failure mode *injectable and
replayable* (seeded :class:`FaultPlan` driving channel/listener wrappers
and a peer-fetch hook) and every survival decision *a policy*
(:class:`RetryPolicy` backoff for fetches and dials; the executor's
suspect-vs-dead grace window, relay-fallback degradation, and
quarantine/probe/re-admit scoring are configured knobs, not constants).
See ``docs/faults.md``.
"""
from .plan import ACTIONS, FaultPlan, FaultRule, scaled
from .retry import RetryPolicy
from .wrappers import FaultyChannel, FaultyListener

__all__ = ["ACTIONS", "FaultPlan", "FaultRule", "RetryPolicy",
           "FaultyChannel", "FaultyListener", "scaled"]
