"""Futures for async graph submission (``submit``/``gather``).

Port of ``repro/cluster/futures.py``, unchanged.

A :class:`ClusterFuture` is the driver-side handle for one submitted
:class:`~repro_torch.core.graph.TaskGraph`.  The heavy lifting happens on a
background driver thread per submission; every run gets a fresh worker
pool, and submissions to the SAME executor queue behind its run lock (its
stats are per-run) — use one executor per job for true concurrency.  The
future carries completion state across threads plus a snapshot of the
run's ``stats`` (including the data-plane counters ``bytes_moved`` /
``transfers_direct`` / ``transfers_driver`` and the speculation counters
``n_speculative`` / ``speculative_wins`` / ``speculative_wasted_s``) and
``wall_time``, so callers of overlapping submissions don't race on the
executor's per-run fields.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional


class ClusterFuture:
    def __init__(self, label: str = "") -> None:
        self.label = label
        self._event = threading.Event()
        self._result: Optional[Dict[int, Any]] = None
        self._error: Optional[BaseException] = None
        self._stats: Dict[str, int] = {}
        self._wall_time = 0.0

    # -- producer side ------------------------------------------------------
    def _set_result(self, value: Dict[int, Any],
                    stats: Optional[Dict[str, int]] = None,
                    wall_time: float = 0.0) -> None:
        self._result = value
        self._stats = dict(stats or {})
        self._wall_time = wall_time
        self._event.set()

    def _set_error(self, exc: BaseException) -> None:
        self._error = exc
        self._event.set()

    # -- consumer side ------------------------------------------------------
    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Dict[int, Any]:
        if not self._event.wait(timeout):
            raise TimeoutError(f"future {self.label or id(self)} not done "
                               f"after {timeout}s")
        if self._error is not None:
            raise self._error
        assert self._result is not None
        return self._result

    def exception(self, timeout: Optional[float] = None):
        self._event.wait(timeout)
        return self._error

    @property
    def stats(self) -> Dict[str, int]:
        """Per-run stats snapshot (empty until the run completes)."""
        return dict(self._stats)

    @property
    def wall_time(self) -> float:
        return self._wall_time


def gather(*futures: ClusterFuture,
           timeout: Optional[float] = None) -> List[Dict[int, Any]]:
    """Wait for every future; returns their results in argument order.
    ``timeout`` bounds the TOTAL wait (shared deadline across futures).
    The first error encountered is raised (after all futures settle)."""
    deadline = None if timeout is None else time.monotonic() + timeout
    for f in futures:
        remaining = (None if deadline is None
                     else max(0.0, deadline - time.monotonic()))
        if not f._event.wait(remaining):
            raise TimeoutError(
                f"gather: future {f.label or id(f)} not done within "
                f"{timeout}s total")
    return [f.result(0) for f in futures]
