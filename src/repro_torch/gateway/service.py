"""Resident gateway service: one shared worker pool, many tenants.

Port of ``repro/gateway/service.py``.  What is the port's own:

* **Result frames carry tensors as host bytes.**  A job's results are
  pickled with the port's tensor reducer
  (:func:`repro_torch.cluster.serde.dumps`, buffers in band): a tensor
  crosses as its host bytes plus dtype, shape and device, and lands on its
  device in the client.  The stats sent with
  it add ``result_bytes`` and ``result_encode_s``.
* **The pool's start method.**  A config that names none resolves here,
  not in the executor: ``"spawn"`` when a CUDA device is present, else
  ``"fork"``.  A resident pool outlives the moment this process first
  holds a CUDA value (a job's results are decoded onto their device here,
  before they are pickled for the client), and a worker started after
  that moment (an elastic join) could not use CUDA if it were forked.
* Each job's ``stats`` carry its own ``kernel_launches``, ``tasks_run``
  and ``recomputed`` (``repro_torch/cluster/executor.py``).

:class:`GatewayService` turns the cluster runtime from a per-run library
into a long-lived *service*: it owns a single resident
:class:`~repro_torch.cluster.executor.ClusterExecutor` (one worker pool, one
union run — see ``start_resident``/``submit_job``), binds a **client
listener**, and multiplexes any number of authenticated tenant sessions
onto that pool.  ``repro_torch.connect``
(:mod:`repro_torch.gateway.client`) is the other half.

Two listeners, one protocol
---------------------------
Workers and clients speak the same framed handshake (JSON hello, token,
pickled frames after auth), but land on *different ports*: the
executor's worker listener adopts every successful dial into the pool
(any `repro-worker` dialing a live run is an elastic join), so client
dials must not reach it.  The gateway binds its own
:class:`~repro_torch.cluster.channel.TcpListener` for hellos carrying
``role: client``; anything else on that port is rejected with a clear
"wrong port" reason.

Admission control
-----------------
Per-tenant quotas are enforced *before* a job consumes any executor
state, via ``submit_job``'s admission gate (called post-fusion, when the
job's true cluster count is known, pre-enqueue):

* ``max_inflight_clusters`` — ceiling on the tenant's not-yet-finished
  clusters across all its in-flight jobs;
* ``max_store_bytes`` — ceiling on the tenant's *declared* object-store
  footprint (sum of ``out_bytes`` over in-flight jobs' tasks; declared
  rather than measured, so admission is a pure function of the submitted
  graphs, not of runtime racing).

A rejected submission fails only its own future with a picklable
:class:`~repro_torch.gateway.errors.QuotaExceeded`; nothing was admitted, so
there is nothing to clean up.

Isolation & accounting
----------------------
Task failures, cancellations and client disconnects are scoped to the
owning tenant by the resident executor (``fail_job``); the service adds
the session layer: a dropped client cancels exactly that session's
in-flight jobs.  Per-tenant counters and SLO latency reservoirs
(submit→first-dispatch, submit→gather) feed :meth:`GatewayService.stats`
and the gateway CLI's periodic report; ``session`` /
``sessionend`` records go to the resident run log so a restarted gateway
can re-create tenant quotas (jobs in flight at the crash fail; clients
resubmit — graphs are pure, so a resubmit is bit-identical).
"""
from __future__ import annotations

import pickle
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from repro_torch.cluster import serde
from repro_torch.cluster.channel import (ChannelClosed, TcpListener,
                                         _recv_frame, _send_frame)
from repro_torch.cluster.executor import ClusterExecutor
from repro_torch.config import ClusterConfig, TENANT_FIELDS

from .errors import GatewayError, QuotaExceeded

__all__ = ["GatewayService", "TenantQuota"]


def _pctl(xs: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile (q in [0, 100]); None on empty."""
    if not xs:
        return None
    s = sorted(xs)
    k = max(0, min(len(s) - 1, int(round(q / 100.0 * (len(s) - 1)))))
    return s[k]


@dataclass(frozen=True)
class TenantQuota:
    """Admission ceilings for one tenant; ``None`` means unlimited."""
    max_inflight_clusters: Optional[int] = None
    max_store_bytes: Optional[int] = None

    def as_dict(self) -> Dict[str, Optional[int]]:
        return {"max_inflight_clusters": self.max_inflight_clusters,
                "max_store_bytes": self.max_store_bytes}

    @classmethod
    def of(cls, v) -> "TenantQuota":
        if v is None:
            return cls()
        if isinstance(v, cls):
            return v
        return cls(**{k: v[k] for k in
                      ("max_inflight_clusters", "max_store_bytes")
                      if k in v})


class _TenantState:
    """Aggregated accounting for one tenant (all its sessions)."""

    def __init__(self, quota: TenantQuota) -> None:
        self.quota = quota
        self.sessions = 0
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.rejected = 0
        self.inflight_jobs = 0
        self.inflight_clusters = 0
        self.inflight_bytes = 0
        self.lat_dispatch: List[float] = []   # submit -> first dispatch
        self.lat_gather: List[float] = []     # submit -> result collected

    def snapshot(self) -> Dict[str, Any]:
        return {
            "sessions": self.sessions,
            "submitted": self.submitted,
            "completed": self.completed,
            "failed": self.failed,
            "rejected": self.rejected,
            "inflight_jobs": self.inflight_jobs,
            "inflight_clusters": self.inflight_clusters,
            "inflight_bytes": self.inflight_bytes,
            "quota": self.quota.as_dict(),
            "slo": {
                "submit_to_first_dispatch_s": {
                    "p50": _pctl(self.lat_dispatch, 50),
                    "p99": _pctl(self.lat_dispatch, 99)},
                "submit_to_gather_s": {
                    "p50": _pctl(self.lat_gather, 50),
                    "p99": _pctl(self.lat_gather, 99)},
            },
        }


class _Session:
    """One client connection: a read loop on its own thread, plus one
    small waiter thread per in-flight job (bounded by the tenant's
    cluster quota) that ships the result frame when the future
    resolves."""

    def __init__(self, service: "GatewayService", sock, sid: int,
                 tenant: str) -> None:
        self.service = service
        self.sock = sock
        self.sid = sid
        self.tenant = tenant
        self.send_lock = threading.Lock()
        self.jobs_lock = threading.Lock()
        self.jobs: Dict[int, Any] = {}       # client job id -> future
        self.closed = False
        self.thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"gateway-session-{tenant}-{sid}")

    # ---------------------------------------------------------------- wire
    def _send(self, *frame: Any) -> None:
        try:
            _send_frame(self.sock, pickle.dumps(frame, protocol=5),
                        lock=self.send_lock)
        except OSError:
            pass                      # read loop notices the dead socket

    def _fail(self, cjid: int, exc: BaseException) -> None:
        try:
            blob = pickle.dumps(exc, protocol=5)
        except Exception:
            blob = pickle.dumps(GatewayError(repr(exc)), protocol=5)
        self._send("failed", cjid, blob)

    # ---------------------------------------------------------------- loop
    def _run(self) -> None:
        svc = self.service
        try:
            while True:
                try:
                    msg = _recv_frame(self.sock)
                except (ChannelClosed, OSError, EOFError,
                        pickle.UnpicklingError):
                    break
                verb = msg[0]
                if verb == "submit":
                    self._handle_submit(msg[1], msg[2], msg[3])
                elif verb == "stats":
                    self._send("stats", svc.stats())
                elif verb == "bye":
                    break
                # unknown verbs skipped: forward compatibility
        finally:
            self.closed = True
            with self.jobs_lock:
                live = dict(self.jobs)
            for fut in live.values():
                svc.executor.cancel_job(fut.job_id, "client disconnected")
            try:
                self.sock.close()
            except OSError:
                pass
            svc._end_session(self)

    # -------------------------------------------------------------- submit
    def _handle_submit(self, cjid: int, blob: bytes,
                       opts: Dict[str, Any]) -> None:
        svc = self.service
        bad = set(opts) - TENANT_FIELDS
        if bad:
            self._fail(cjid, GatewayError(
                f"submit options {sorted(bad)} are not tenant-settable "
                f"(allowed: {sorted(TENANT_FIELDS)})"))
            return
        try:
            graph, inputs = pickle.loads(blob)
        except Exception as e:
            self._fail(cjid, GatewayError(f"undecodable job graph: {e!r}"))
            return
        declared = sum(getattr(n, "out_bytes", 0) or 0
                       for n in graph.nodes.values())
        tenant = self.tenant

        def admission(n_clusters: int) -> None:
            # called by submit_job post-fusion, pre-enqueue; raising
            # aborts the submission with no executor residue
            with svc._lock:
                t = svc._tenant(tenant)
                q = t.quota
                if (q.max_inflight_clusters is not None
                        and t.inflight_clusters + n_clusters
                        > q.max_inflight_clusters):
                    t.rejected += 1
                    raise QuotaExceeded(
                        f"tenant {tenant!r}: admitting {n_clusters} "
                        f"cluster(s) would put {t.inflight_clusters + n_clusters} "
                        f"in flight (limit {q.max_inflight_clusters})",
                        tenant, "inflight_clusters",
                        q.max_inflight_clusters,
                        t.inflight_clusters + n_clusters)
                if (q.max_store_bytes is not None
                        and t.inflight_bytes + declared
                        > q.max_store_bytes):
                    t.rejected += 1
                    raise QuotaExceeded(
                        f"tenant {tenant!r}: job declares {declared} "
                        f"store bytes, would put "
                        f"{t.inflight_bytes + declared} in flight "
                        f"(limit {q.max_store_bytes})",
                        tenant, "store_bytes", q.max_store_bytes,
                        t.inflight_bytes + declared)
                # reserve atomically with the check
                t.submitted += 1
                t.inflight_jobs += 1
                t.inflight_clusters += n_clusters
                t.inflight_bytes += declared

        try:
            fut = svc.executor.submit_job(
                graph, inputs, tenant=tenant,
                outputs_only=opts.get("outputs_only"),
                label=opts.get("label", ""), admission=admission)
        except QuotaExceeded as e:
            self._fail(cjid, e)
            return
        except Exception as e:     # bad graph (validate), pool down, ...
            self._fail(cjid, GatewayError(f"submission failed: {e!r}"))
            return
        with self.jobs_lock:
            self.jobs[cjid] = fut
        threading.Thread(
            target=self._await, args=(cjid, fut, declared), daemon=True,
            name=f"gateway-wait-{tenant}-j{fut.job_id}").start()

    def _await(self, cjid: int, fut, declared: int) -> None:
        svc = self.service
        exc = fut.exception(None)          # blocks until the job resolves
        with self.jobs_lock:
            self.jobs.pop(cjid, None)
        with svc._lock:
            t = svc._tenant(self.tenant)
            t.inflight_jobs -= 1
            t.inflight_clusters -= fut.n_clusters
            t.inflight_bytes -= declared
            if exc is None:
                t.completed += 1
                s = fut.stats
                if s.get("submit_to_first_dispatch_s") is not None:
                    t.lat_dispatch.append(s["submit_to_first_dispatch_s"])
                if s.get("submit_to_gather_s") is not None:
                    t.lat_gather.append(s["submit_to_gather_s"])
            else:
                t.failed += 1
        if exc is None:
            t0 = time.perf_counter()
            blob = serde.dumps(fut.result())
            stats = dict(fut.stats, result_bytes=len(blob),
                         result_encode_s=time.perf_counter() - t0)
            self._send("result", cjid, blob,
                       {"wall_time": fut.wall_time, "stats": stats})
        else:
            self._fail(cjid, exc)


class GatewayService:
    """The resident multi-tenant service.  Construct with the pool's
    :class:`repro_torch.ClusterConfig` (worker count, transport, channel,
    token, checkpointing, fault policy — all operator-owned), then
    :meth:`start` to bring up the pool and begin accepting clients::

        cfg = repro_torch.ClusterConfig(n_workers=8, token=tok)
        with GatewayService(cfg, quotas={"serve": TenantQuota(64)}) as gw:
            print("clients dial", gw.address)
            gw.serve_forever()

    ``config.resume`` is interpreted at the *gateway* level: tenant
    sessions (quotas, fair-share weights) are restored from the named
    run log, but the pool starts a fresh run — jobs in flight at the
    crash fail on their clients, which resubmit (pure graphs make the
    resubmission bit-identical).
    """

    def __init__(self, config: Optional[ClusterConfig] = None, *,
                 client_address: str = "127.0.0.1:0",
                 quotas: Optional[Dict[str, Any]] = None,
                 default_quota: Any = None,
                 **legacy: Any) -> None:
        from repro_torch.config import resolve_config
        cfg = resolve_config(config, legacy, owner="GatewayService")
        self._restored_sessions: Dict[str, Dict[str, Any]] = {}
        if cfg.resume is not None:
            import os
            from repro_torch.checkpoint.runlog import load_run
            state = load_run(os.path.join(
                cfg.checkpoint_dir, f"{cfg.resume}.log"))
            self._restored_sessions = dict(state.sessions)
            cfg = cfg.replace(resume=None)     # fresh pool run id
        self.config = cfg
        self.client_address_spec = client_address
        self.default_quota = TenantQuota.of(default_quota)
        self.quotas = {t: TenantQuota.of(q)
                       for t, q in (quotas or {}).items()}
        self._lock = threading.Lock()
        self._tenants: Dict[str, _TenantState] = {}
        self._sessions: Dict[int, _Session] = {}
        self._session_seq = 0
        self._stop = threading.Event()
        self._accept_thread: Optional[threading.Thread] = None
        self.executor: Optional[ClusterExecutor] = None
        self.listener: Optional[TcpListener] = None
        self.started = time.time()

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "GatewayService":
        if self.executor is not None:
            return self
        if self.config.start_method is None:
            import torch
            self.config = self.config.replace(
                start_method="spawn" if torch.cuda.is_available() else "fork")
        self.executor = ClusterExecutor(config=self.config)
        self.executor.start_resident()
        self.listener = TcpListener(self.client_address_spec,
                                    token=self.config.token)
        for tenant, info in self._restored_sessions.items():
            q = TenantQuota.of(info.get("quota"))
            self.quotas.setdefault(tenant, q)
            with self._lock:
                self._tenant(tenant)
            if info.get("priority") is not None:
                self.executor.set_tenant_weight(tenant, info["priority"])
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="gateway-accept")
        self._accept_thread.start()
        return self

    @property
    def address(self) -> str:
        """The client port (``host:port``) — what ``repro_torch.connect`` and
        ``run_graph(connect=...)`` dial.  Distinct from the executor's
        worker listener."""
        if self.listener is None:
            raise RuntimeError("gateway not started")
        return self.listener.address

    def stop(self, timeout: float = 30.0) -> None:
        """Drain: stop accepting, close every session (their pending
        futures fail client-side with ``SessionClosed``), then shut the
        resident pool down."""
        self._stop.set()
        if self.listener is not None:
            self.listener.close()
        with self._lock:
            sessions = list(self._sessions.values())
        for s in sessions:
            try:
                s.sock.close()
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)
        if self.executor is not None:
            self.executor.shutdown_resident(timeout=timeout)
            self.executor.close()

    def __enter__(self) -> "GatewayService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def serve_forever(self, poll: float = 0.5) -> None:
        """Block until :meth:`stop` (or KeyboardInterrupt).  Re-raises
        the resident driver's error if the pool dies underneath the
        service — a gateway with no pool must crash loudly, not keep
        accepting doomed submissions."""
        while not self._stop.wait(poll):
            ex = self.executor
            if ex is None:
                break
            if ex._resident is not None and not ex._resident.is_alive():
                self._stop.set()
                if ex._resident_error is not None:
                    raise ex._resident_error

    # -------------------------------------------------------------- accept
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            pair = self.listener.poll_worker()
            if pair is None:
                time.sleep(0.02)
                continue
            sock, hello = pair
            if hello.get("role") != "client":
                # a worker (or rejoiner) dialed the CLIENT port: tell it
                # where it went wrong instead of adopting or hanging it
                try:
                    _send_frame(sock, pickle.dumps(
                        ("reject", "this is the gateway client port; "
                         "workers dial the pool's worker listener"),
                        protocol=5))
                except OSError:
                    pass
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            self._open_session(sock, hello)

    def _open_session(self, sock, hello: Dict[str, Any]) -> None:
        tenant = str(hello.get("tenant") or "default")
        priority = hello.get("priority")
        with self._lock:
            sid = self._session_seq
            self._session_seq += 1
            t = self._tenant(tenant)
            t.sessions += 1
            first = t.sessions == 1
            session = _Session(self, sock, sid, tenant)
            self._sessions[sid] = session
        if priority is not None:
            try:
                self.executor.set_tenant_weight(tenant, float(priority))
            except (TypeError, ValueError):
                priority = None
        if first:
            self.executor.log_record("session", tenant, {
                "quota": t.quota.as_dict(), "priority": priority})
        try:
            _send_frame(sock, pickle.dumps(
                ("welcome", sid,
                 {"gateway": True, "tenant": tenant,
                  "quota": t.quota.as_dict()},
                 None), protocol=5))
        except OSError:
            with self._lock:
                self._sessions.pop(sid, None)
                t.sessions -= 1
            try:
                sock.close()
            except OSError:
                pass
            return
        session.thread.start()

    def _end_session(self, session: _Session) -> None:
        with self._lock:
            self._sessions.pop(session.sid, None)
            t = self._tenant(session.tenant)
            t.sessions -= 1
            last = t.sessions == 0
        if last and not self._stop.is_set():
            self.executor.log_record("sessionend", session.tenant)

    # ---------------------------------------------------------------- state
    def _tenant(self, tenant: str) -> _TenantState:
        """Caller holds ``self._lock``."""
        t = self._tenants.get(tenant)
        if t is None:
            t = _TenantState(self.quotas.get(tenant, self.default_quota))
            self._tenants[tenant] = t
        return t

    def stats(self) -> Dict[str, Any]:
        """Snapshot: per-tenant accounting + SLO percentiles, plus the
        pool's own counters under ``"pool"``."""
        with self._lock:
            out: Dict[str, Any] = {
                t: st.snapshot() for t, st in self._tenants.items()}
        ex = self.executor
        out["pool"] = {
            "n_workers": len(ex.worker_specs) if ex is not None else 0,
            "uptime_s": time.time() - self.started,
            "stats": dict(ex.stats) if ex is not None else {},
        }
        return out
