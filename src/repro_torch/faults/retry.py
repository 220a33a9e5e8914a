"""RetryPolicy — the one retry/backoff vocabulary for the whole runtime.

Port of ``repro/faults/retry.py``, unchanged.

Every network-facing operation that can transiently fail (a peer data-plane
fetch, a TCP dial into the driver's listener) retries through one of these
instead of hand-rolled ``while``/``sleep`` loops: bounded attempts,
exponential backoff with jitter (so a thundering herd of consumers retrying
against one recovering owner de-phases instead of re-synchronizing), and an
optional overall deadline that caps the *total* time spent regardless of
how the per-attempt delays add up.

The policy is a frozen description, safe to share across threads and to
pickle into worker config; the mutable state (attempt counter, start time)
lives in each :meth:`run` call.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

__all__ = ["RetryPolicy"]


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff, jitter, and a deadline.

    * ``attempts`` — total tries (1 = no retry).
    * ``base_delay`` — sleep after the first failure, in seconds.
    * ``factor`` — backoff multiplier per further failure.
    * ``max_delay`` — per-sleep ceiling.
    * ``jitter`` — fraction of the computed delay added uniformly at
      random (``0.5`` means each sleep lands in ``[d, 1.5d]``); this is
      what keeps a fleet of retriers from phase-locking.
    * ``deadline`` — optional overall wall budget in seconds, measured
      from the first attempt; once exceeded the last error is raised
      even if attempts remain.
    """

    attempts: int = 3
    base_delay: float = 0.05
    factor: float = 2.0
    max_delay: float = 2.0
    jitter: float = 0.5
    deadline: Optional[float] = None

    def backoff(self, attempt: int, rng: Optional[random.Random] = None
                ) -> float:
        """Sleep before attempt ``attempt+1`` (attempt is 0-based and names
        the try that just failed)."""
        d = min(self.base_delay * (self.factor ** attempt), self.max_delay)
        if self.jitter > 0:
            r = rng.random() if rng is not None else random.random()
            d *= 1.0 + self.jitter * r
        return d

    def run(self, fn: Callable[[int], Any], *,
            retryable: Optional[Callable[[BaseException], bool]] = None,
            on_retry: Optional[Callable[[int, BaseException], None]] = None,
            rng: Optional[random.Random] = None) -> Any:
        """Call ``fn(attempt)`` until it returns, retrying failures.

        ``retryable(exc)`` gates each retry (default: everything retries);
        a non-retryable error, the last attempt's error, or any error past
        the deadline propagates unchanged.  ``on_retry(attempt, exc)`` is
        observability only — exceptions it raises are swallowed.
        """
        start = time.monotonic()
        for attempt in range(max(1, self.attempts)):
            try:
                return fn(attempt)
            except BaseException as e:      # noqa: BLE001 — re-raised below
                last = attempt >= max(1, self.attempts) - 1
                if last or (retryable is not None and not retryable(e)):
                    raise
                delay = self.backoff(attempt, rng)
                if self.deadline is not None:
                    left = self.deadline - (time.monotonic() - start)
                    if left <= 0:
                        raise
                    delay = min(delay, left)
                if on_retry is not None:
                    try:
                        on_retry(attempt, e)
                    except Exception:
                        pass
                time.sleep(max(0.0, delay))
        raise AssertionError("unreachable")     # pragma: no cover
