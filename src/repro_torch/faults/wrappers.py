"""Fault-injecting wrappers over the control-plane Channel/Listener.

Port of ``repro/faults/wrappers.py``, unchanged.

:class:`FaultyChannel` decorates any driver-side channel (pipe, spawn, or
TCP) with the faults a :class:`~repro_torch.faults.plan.FaultPlan` prescribes,
conforming to the same protocol the executor already speaks — so every
deployment shape is injectable without touching the transports themselves.

Mechanics worth knowing:

* **Withheld frames stay ordered.**  Delay and sever never reorder: once a
  frame is parked, later frames on the same direction queue behind it
  (release times are monotone per direction) — exactly how a congested or
  partitioned TCP stream behaves.  Only an explicit ``reorder`` rule swaps
  adjacent frames.
* **Delivery without wire traffic.**  A parked inbound frame whose release
  time passes may have no new socket bytes to piggyback on, and the
  driver's ``wait()`` will not report the channel readable.  The wrapper
  therefore exposes ``has_ready()``/``drain_ready()``, and the executor's
  pump drains them every iteration; parked *outbound* frames flush from
  :meth:`maybe_heartbeat`, which the driver loop calls every iteration on
  every live channel.
* **Partitions are visible as silence.**  The wrapper keeps its own
  ``last_delivered`` clock; while a sever window is open (and the wrapped
  transport still looks healthy underneath — bytes do arrive, the wrapper
  just withholds them), :meth:`dead` reports the standard
  ``"no heartbeat for ..."`` verdict once the silence exceeds the
  heartbeat timeout.  The executor's suspect/grace machinery then sees a
  partitioned worker exactly as it would a real one.

:class:`FaultyListener` wraps the driver's accept loop: ``accept``-verb
rules can drop a handshaken dial (the socket closes; the worker's
:class:`~repro_torch.faults.retry.RetryPolicy` re-dials) or delay its adoption.
"""
from __future__ import annotations

import time
from typing import Any, List, Optional, Tuple

from .plan import FaultPlan, FaultRule

__all__ = ["FaultyChannel", "FaultyListener"]

DRIVER = "driver"


class _Direction:
    """Parked frames for one direction of the link (FIFO + one reorder
    hold).  Not locked: both directions are touched only from the driver
    loop thread."""

    __slots__ = ("queue", "hold", "hold_deadline")

    def __init__(self) -> None:
        self.queue: List[Tuple[float, tuple]] = []   # (release, msg)
        self.hold: Optional[tuple] = None            # reorder-held frame
        self.hold_deadline = 0.0

    def park(self, msg: tuple, release: float) -> None:
        if self.queue:
            release = max(release, self.queue[-1][0])   # keep FIFO order
        self.queue.append((release, msg))

    def ripe(self, now: float) -> List[tuple]:
        out: List[tuple] = []
        while self.queue and self.queue[0][0] <= now:
            out.append(self.queue.pop(0)[1])
        if self.hold is not None and now >= self.hold_deadline:
            out.append(self.hold)
            self.hold = None
        return out

    def pending(self, now: float) -> bool:
        return (bool(self.queue) and self.queue[0][0] <= now) or \
            (self.hold is not None and now >= self.hold_deadline)


class FaultyChannel:
    """Driver-side channel decorated with a fault plan.

    ``wid`` names the worker endpoint for rule addressing; the driver end
    is always ``"driver"``.  Every attribute the executor pokes beyond the
    Channel protocol (``proc``, ``kind``, ``sock``, ``last_seen``, ...)
    delegates to the wrapped channel.
    """

    #: max seconds a reorder rule holds a frame waiting for its swap
    #: partner before giving up and delivering it anyway
    REORDER_HOLD = 0.25

    def __init__(self, inner: Any, plan: FaultPlan, wid: Any, *,
                 silence_timeout: Optional[float] = None) -> None:
        self.inner = inner
        self.plan = plan
        self.wid = wid
        self.silence_timeout = (
            silence_timeout if silence_timeout is not None
            else getattr(inner, "heartbeat_timeout", 5.0))
        self._out = _Direction()        # driver -> worker
        self._in = _Direction()         # worker -> driver
        self._last_delivered = time.monotonic()

    def __getattr__(self, name: str) -> Any:
        return getattr(self.inner, name)

    # ------------------------------------------------------------ helpers
    def _severed_until(self) -> Optional[float]:
        return self.plan.severed(DRIVER, self.wid)

    def _apply(self, msg: tuple, src: Any, dst: Any, d: _Direction,
               emit: List[tuple], now: float) -> None:
        """Run one frame through the plan; survivors land in ``emit`` (to
        send/deliver now) or are parked in ``d``."""
        verb = msg[0] if msg else "?"
        rules = self.plan.frame_actions(src, dst, verb)
        sev = self._severed_until()
        if sev is not None:
            # the partition swallows everything, including the frame whose
            # match opened the window; delivery resumes when it closes
            d.park(msg, sev)
            return
        dup = False
        release: Optional[float] = None
        for r in rules:
            if r.action == "drop":
                return
            if r.action == "delay":
                release = max(release or 0.0, now + r.delay)
            elif r.action == "dup":
                dup = True
            elif r.action == "reorder" and d.hold is None \
                    and release is None:
                d.hold = msg
                d.hold_deadline = now + self.REORDER_HOLD
                return
        if release is not None or d.queue:
            d.park(msg, release if release is not None else now)
            if dup:
                d.park(msg, release if release is not None else now)
            return
        emit.append(msg)
        if dup:
            emit.append(msg)
        if d.hold is not None:      # the swap partner passed: release hold
            emit.append(d.hold)
            d.hold = None

    def _flush_out(self, now: float) -> None:
        for msg in self._out.ripe(now):
            self.inner.send(msg)

    # ----------------------------------------------------- write side
    def send(self, msg: tuple) -> None:
        now = time.monotonic()
        self._flush_out(now)
        emit: List[tuple] = []
        self._apply(msg, DRIVER, self.wid, self._out, emit, now)
        for m in emit:
            self.inner.send(m)

    def send_many(self, msgs: List[tuple]) -> None:
        now = time.monotonic()
        self._flush_out(now)
        emit: List[tuple] = []
        for msg in msgs:
            self._apply(msg, DRIVER, self.wid, self._out, emit, now)
        if emit:
            self.inner.send_many(emit)

    def maybe_heartbeat(self) -> None:
        self._flush_out(time.monotonic())
        if self._severed_until() is None:
            self.inner.maybe_heartbeat()
        # during a partition the driver's keepalives are withheld too —
        # the worker-side silence watchdog must see a real outage

    # ------------------------------------------------------ read side
    def selectable(self):
        return self.inner.selectable()

    def recv_available(self) -> List[tuple]:
        now = time.monotonic()
        emit: List[tuple] = []
        for msg in self.inner.recv_available():
            self._apply(msg, self.wid, DRIVER, self._in, emit, now)
        out = self._in.ripe(now) + emit
        if out:
            self._last_delivered = now
        return out

    def has_ready(self) -> bool:
        """Parked inbound frames whose release time has passed (the pump
        drains these even when the wire is silent)."""
        return self._in.pending(time.monotonic())

    def drain_ready(self) -> List[tuple]:
        now = time.monotonic()
        out = self._in.ripe(now)
        if out:
            self._last_delivered = now
        return out

    # ------------------------------------------------------- liveness
    def dead(self) -> Optional[str]:
        r = self.inner.dead()
        if r is not None:
            return r
        if self._severed_until() is not None:
            silent = time.monotonic() - self._last_delivered
            if silent > self.silence_timeout:
                # same verdict string a silent TcpChannel produces, so the
                # executor's silence classifier treats both alike
                return (f"no heartbeat for {silent:.1f}s "
                        f"(timeout {self.silence_timeout}s)")
        return None

    def close(self) -> None:
        # best-effort flush of parked outbound frames (a die/stop queued
        # behind a delay should still reach the worker)
        try:
            for _, msg in self._out.queue:
                self.inner.send(msg)
            if self._out.hold is not None:
                self.inner.send(self._out.hold)
        except Exception:
            pass
        self._out.queue.clear()
        self._out.hold = None
        self.inner.close()


class FaultyListener:
    """Accept-side fault injection: ``verb="accept"`` rules fire per
    handshaken dial.  ``drop`` closes the fresh socket (the worker's dial
    retry policy re-dials), ``delay`` stalls adoption."""

    def __init__(self, inner: Any, plan: FaultPlan) -> None:
        self.inner = inner
        self.plan = plan

    def __getattr__(self, name: str) -> Any:
        return getattr(self.inner, name)

    @property
    def address(self) -> str:
        return self.inner.address

    def _filter(self, pair):
        sock, hello = pair
        src = hello.get("wid", hello.get("pid", "?"))
        for r in self.plan.frame_actions(src, DRIVER, "accept"):
            if r.action == "delay":
                time.sleep(r.delay)
            elif r.action == "drop":
                try:
                    sock.close()
                except OSError:
                    pass
                return None
        return pair

    def get_worker(self, timeout: float):
        deadline = time.monotonic() + timeout
        while True:
            left = max(0.001, deadline - time.monotonic())
            pair = self._filter(self.inner.get_worker(left))
            if pair is not None:
                return pair

    def poll_worker(self):
        pair = self.inner.poll_worker()
        if pair is None:
            return None
        return self._filter(pair)

    def fileno(self) -> int:
        return self.inner.fileno()

    def close(self) -> None:
        self.inner.close()
