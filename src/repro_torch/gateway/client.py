"""Client half of the multi-tenant gateway: ``repro_torch.connect``.

Port of ``repro/gateway/client.py``.  What is the port's own: the graph and
its inputs are pickled with the port's tensor reducer
(:func:`repro_torch.cluster.serde.dumps`), so an input tensor crosses as its
host bytes plus dtype, shape and device, as a result tensor does the other
way; a result's ``stats`` add ``result_decode_s``, the seconds this client
took to unpickle it (its tensors copied onto their devices).

A :class:`Client` is one tenant session on a resident gateway
(:class:`repro_torch.gateway.GatewayService`).  It dials the gateway's client
port with the same framed handshake the pool's workers use — JSON hello,
constant-time token check, pickled frames only after authentication —
except the hello carries ``role: client``, so the service routes it to a
tenant session instead of adopting it into the worker pool.

Usage::

    with repro_torch.connect("gw-host:7777", token=tok, tenant="serve") as c:
        fut = c.submit(graph, {"x": batch})     # non-blocking
        results = fut.result()                  # keyed by graph's own ids

Concurrency model: ``submit`` is non-blocking (the graph is pickled and
framed on the caller's thread, so unpicklable task functions fail *here*
with a clear error, not on the gateway); one reader thread per client
resolves futures as ``result``/``failed`` frames arrive, so any number
of submissions can be in flight and complete out of order.  Results are
bit-identical to ``repro_torch.execute_sequential`` of the same graph — the
gateway runs the same deterministic lower/fuse/execute passes every
other backend uses.

Failure semantics: a quota rejection or task failure fails only that
future, with the service's original typed exception
(:class:`repro_torch.gateway.QuotaExceeded`, ``TaskFailed``, ``MissingInput``
...) re-raised from ``future.result()``.  A dropped connection or
``close()`` fails every pending future with
:class:`repro_torch.gateway.SessionClosed`.
"""
from __future__ import annotations

import pickle
import queue
import threading
import time
from typing import Any, Dict, Optional

from repro_torch.cluster import serde
from repro_torch.cluster.channel import (ChannelClosed, _dial_and_welcome,
                                         _recv_frame, _send_frame)
from repro_torch.cluster.futures import ClusterFuture
from repro_torch.config import TENANT_FIELDS
from repro_torch.core.graph import TaskGraph

from .errors import GatewayError, SessionClosed

__all__ = ["Client", "connect"]


class Client:
    """One authenticated tenant session on a gateway.  Thread-safe:
    ``submit``/``stats``/``close`` may be called from any thread."""

    def __init__(self, sock, session_id: int, config: Dict[str, Any],
                 address: str) -> None:
        self._sock = sock
        self.session_id = session_id
        self.address = address
        self.tenant: str = config.get("tenant", "default")
        self.quota: Dict[str, Any] = dict(config.get("quota") or {})
        self._send_lock = threading.Lock()
        self._lock = threading.Lock()
        self._pending: Dict[int, ClusterFuture] = {}
        self._next_id = 0
        self._stats_replies: "queue.Queue[dict]" = queue.Queue()
        self._closed = False
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True,
            name=f"gateway-client-{self.tenant}")
        self._reader.start()

    # ------------------------------------------------------------- submit
    def submit(self, graph: TaskGraph,
               inputs: Optional[Dict[str, Any]] = None, *,
               config=None, outputs_only: Optional[bool] = None,
               label: str = "") -> ClusterFuture:
        """Submit ``graph`` for execution on the shared pool; returns a
        :class:`~repro_torch.cluster.futures.ClusterFuture` resolving to the
        result dict keyed by the graph's own task ids.

        Task functions must be picklable (module-level functions or
        ``functools.partial`` over them) — the graph ships to another
        process.  ``config`` accepts a :class:`repro_torch.ClusterConfig` for
        ``run_graph`` compatibility, but only its ``outputs_only`` field
        travels: pool-level knobs are the operator's, not the tenant's
        (see ``repro_torch.config.TENANT_FIELDS``).
        """
        if config is not None and outputs_only is None:
            oo = getattr(config, "outputs_only", False)
            outputs_only = True if oo else None
        opts: Dict[str, Any] = {}
        if outputs_only is not None:
            opts["outputs_only"] = bool(outputs_only)
        if label:
            opts["label"] = str(label)
        assert set(opts) <= TENANT_FIELDS
        # pickle on the caller's thread: an unpicklable task fn fails
        # HERE with the standard pickle error, not as a gateway reject
        blob = serde.dumps((graph, dict(inputs or {})))
        with self._lock:
            if self._closed:
                raise SessionClosed("client is closed")
            cjid = self._next_id
            self._next_id += 1
            fut = ClusterFuture(label or f"{self.tenant}/c{cjid}")
            self._pending[cjid] = fut
        try:
            _send_frame(self._sock,
                        pickle.dumps(("submit", cjid, blob, opts),
                                     protocol=5),
                        lock=self._send_lock)
        except OSError as e:
            with self._lock:
                self._pending.pop(cjid, None)
            raise SessionClosed(f"gateway connection lost: {e!r}") from e
        return fut

    def gather(self, *futures: ClusterFuture,
               timeout: Optional[float] = None):
        """Resolve several futures, re-raising the first error."""
        from repro_torch.cluster.futures import gather as _gather
        return _gather(*futures, timeout=timeout)

    # -------------------------------------------------------------- stats
    def stats(self, timeout: float = 30.0) -> Dict[str, Any]:
        """Per-tenant gateway statistics (admission counters, in-flight
        accounting, and submit-to-dispatch / submit-to-gather latency
        percentiles), as one snapshot dict keyed by tenant."""
        with self._lock:
            if self._closed:
                raise SessionClosed("client is closed")
        _send_frame(self._sock, pickle.dumps(("stats",), protocol=5),
                    lock=self._send_lock)
        try:
            return self._stats_replies.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError(
                f"no stats reply from {self.address} in {timeout}s"
            ) from None

    # ------------------------------------------------------------ teardown
    def close(self) -> None:
        """End the session.  Pending futures fail with
        :class:`SessionClosed`; the gateway cancels their jobs and
        collects their values (other tenants are untouched)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        try:
            _send_frame(self._sock, pickle.dumps(("bye",), protocol=5),
                        lock=self._send_lock)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._reader.join(timeout=5.0)
        self._fail_pending(SessionClosed("client closed with futures "
                                         "still pending"))

    def __enter__(self) -> "Client":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -------------------------------------------------------------- reader
    def _read_loop(self) -> None:
        try:
            while True:
                msg = _recv_frame(self._sock)
                verb = msg[0]
                if verb == "result":
                    _, cjid, result_blob, report = msg
                    fut = self._take(cjid)
                    if fut is not None:
                        t0 = time.perf_counter()
                        results = pickle.loads(result_blob)
                        del result_blob, msg   # a frame may be gigabytes
                        stats = dict(report.get("stats") or {},
                                     result_decode_s=time.perf_counter() - t0)
                        fut._set_result(
                            results, stats=stats,
                            wall_time=report.get("wall_time", 0.0))
                elif verb == "failed":
                    _, cjid, exc_blob = msg
                    fut = self._take(cjid)
                    if fut is not None:
                        try:
                            exc = pickle.loads(exc_blob)
                        except Exception:
                            exc = GatewayError(
                                "job failed (error not picklable)")
                        fut._set_error(exc)
                elif verb == "stats":
                    self._stats_replies.put(msg[1])
                # unknown verbs are skipped: forward compatibility
        except (ChannelClosed, OSError, EOFError, pickle.UnpicklingError):
            pass
        self._fail_pending(SessionClosed(
            f"gateway session to {self.address} ended"))

    def _take(self, cjid: int) -> Optional[ClusterFuture]:
        with self._lock:
            return self._pending.pop(cjid, None)

    def _fail_pending(self, exc: BaseException) -> None:
        with self._lock:
            pending, self._pending = self._pending, {}
        for fut in pending.values():
            fut._set_error(exc)


def connect(address: str, token: Optional[str] = None, *,
            tenant: str = "default", priority: float = 1.0,
            timeout: float = 30.0) -> Client:
    """Open a tenant session on the gateway at ``address``
    (``"host:port"``).  ``tenant`` names the accounting/quota/fair-share
    identity — two clients with the same tenant share one budget;
    ``priority`` is the tenant's fair-share weight in the resident
    dispatch tier (higher ⇒ more dispatch slots under contention).
    Context-manager friendly: ``with repro_torch.connect(...) as c: ...``.
    """
    sock, sid, config, _ = _dial_and_welcome(
        address, token=token, has_graph=True, timeout=timeout,
        retry_interval=0.2,
        extra={"role": "client", "tenant": str(tenant),
               "priority": float(priority)})
    if not config.get("gateway"):
        # a plain driver/worker listener answered: tell the operator they
        # pointed the client at the worker port, not the client port
        try:
            sock.close()
        except OSError:
            pass
        raise GatewayError(
            f"{address} accepted the dial but is not a gateway client "
            "port (did you connect to the worker listener?)")
    return Client(sock, sid, config, address)
