"""ClusterExecutor — the multi-process / multi-host distributed runtime.

Port of ``repro/cluster/executor.py``.  What the port adds:

* ``stats["first_done_s"]`` and ``stats["last_done_s"]``: seconds from the
  start of ``run`` to the first and to the last completed super-task.  The
  first covers starting the workers (for spawned ones the interpreter, the
  torch import and, for tasks on the card, the CUDA context and the kernel
  library's load); the wall after the last is the final collection of the
  results.
* ``stats["kernel_launches"]``: the kernel launches that the workers report
  with their ``done`` messages, by kernel and by route
  (``repro_torch/cluster/worker.py``); and ``stats["tasks_run"]``: by task
  name, the members of every super-task whose ``done`` the driver read,
  each time it ran.  So the two can be held against each other.  In the
  resident run (the gateway's pool) each ``done`` is also attributed to the
  job whose id range holds its super-task: a job's future carries its own
  ``kernel_launches``, ``tasks_run`` and ``recomputed`` in its ``stats``
  (a cancelled super-task's launches ride on its worker's next ``done``,
  which may be another job's).
* A config that leaves ``start_method`` unset gets
  :func:`default_start_method`: ``"spawn"`` once this process has
  initialised CUDA, else ``"fork"``.  An explicit ``"fork"`` is honoured,
  and a forked worker whose task then touches CUDA fails that task
  (``TaskFailed`` with torch's message).  Forked pipe workers are told they
  were forked (see ``repro_torch/cluster/worker.py``).
* Values cross processes as host bytes (``repro_torch/cluster/serde.py``);
  CUDA IPC is not used.

This is the paper's driver/worker architecture made real: workers are OS
processes on this host (forked or spawned, wired by duplex pipes) or on
*any* host (dialed in over TCP), a driver that schedules ready tasks onto
them, a driver-side :class:`DriverObjectStore` tracking where every result
lives, and lineage-based recovery when a worker dies.  The driver speaks
to every worker through the :class:`~repro_torch.cluster.channel.Channel`
abstraction, so none of the scheduling/recovery logic below knows (or
cares) what wire its messages ride.

Design points (mirroring the Haskell#/Cloud-Haskell driver designs and the
mapping-decision framing of Mapple):

* **Graph compilation before dispatch.**  The purity guarantee lets the
  runtime rewrite the task graph freely, so a plan-time fusion pass
  (:mod:`repro_torch.core.fusion`, knob ``fuse={"off","auto",N}``) clusters the
  DAG into *super-tasks* — linear chains, small same-placement fan-ins,
  and sibling groups below a cost threshold.  The whole driver state
  machine below (plan, dispatch, stealing, speculation, recovery) runs at
  super-task granularity over the plan's cluster-level graph; a
  super-task costs **one** control message, its members execute inside
  one worker frame, and only *cluster outputs* ever touch ``serde`` or
  the object store.  ``fuse="off"`` compiles the identity plan (one
  cluster per task, cluster id == task id), which is bit-for-bit the
  pre-fusion runtime — fused and unfused execution share this one code
  path.  ``stats["n_clusters"]`` / ``stats["tasks_fused"]`` report what
  the pass did.
* **Batched control plane.**  Outgoing control messages (``run`` /
  ``fetch`` / ``drop`` / ``cancel``) are coalesced into a per-worker
  outbox the driver flushes once per event-loop iteration through
  ``Channel.send_many`` — one pickle and one syscall per burst — and the
  worker's sender thread batches its replies the same way.
  ``stats["control_msgs"]`` (logical messages, both directions) vs
  ``stats["control_frames"]`` (driver-side wire writes — the flush
  count) expose the amortization on the dispatch path;
  ``stats["dispatch_overhead_s"]`` is the driver time spent choosing,
  serializing, and writing dispatches, so the fusion win is observable
  directly, not just inferable from wall clock.
* **Static plan, dynamic execution.**  ``scheduler.list_schedule`` produces
  a placement hint over the **fused** graph (critical-path priority,
  earliest-finish-time worker; its comm-cost term sees only cross-cluster
  edges); the driver follows it opportunistically and *steals* — dispatches
  a ready super-task to an idle worker that wasn't its planned home —
  whenever the plan goes stale.  Both the plan (via
  ``data_sizes``/``placed``/``worker_host`` comm costs in the scheduler)
  and the stealing choice (via a transfer-cost score over per-value sizes
  recorded at completion) are **locality-aware** at two radii: same-worker
  beats same-host beats cross-host, so a consumer lands next to its bytes
  and cross-host TCP pulls are a last resort.
* **Zero-copy data plane.**  Cross-worker values move as *handles*
  (:mod:`repro_torch.cluster.serde`): the owner publishes the payload once into
  a ``multiprocessing.shared_memory`` segment (or serves it over its
  unix/TCP socket server — or BOTH, on a TCP data plane where same-host
  consumers then pick the shm side by host id), and the consumer
  maps/pulls it directly.  The control channel carries only messages and
  handles — ``stats["bytes_driver"]`` vs ``stats["bytes_direct"]`` make
  the split observable; ``transport="driver"`` restores the PR-1 relay
  for A/B runs.
* **Channel-based liveness.**  A forked worker's death is OS truth
  (``proc.is_alive``); a TCP worker's death is **missed heartbeats** or a
  socket EOF — and a clean shutdown says an explicit goodbye so it is
  never misread as a crash.  The driver asks each channel, not the
  process table, so SIGKILL on another machine and SIGKILL on this one
  take the same recovery path.
* **Pipelined dispatch.**  Up to ``pipeline_depth`` super-tasks are in a
  worker's channel at once, so the driver overlaps dispatch/transfer with
  execution (the futures-style async core of ``submit``/``gather``).
* **Replicas, not broadcast.**  Results stay in the producing worker's
  local store; a transfer leaves the consumer holding a replica (tracked
  per-value as a *set* of holders, each tagged with its host), so later
  consumers read locally and a value is only lost when its last holder
  dies without a durable handle.
* **Lineage fault tolerance at super-task granularity.**  On worker death
  the lost set is exactly the values with no surviving replica, no
  shm-published handle, and no driver-cached copy;
  ``lineage.recovery_plan_clusters`` gives the minimal recompute set of
  *clusters* (walking past GC'd ancestors in ``outputs_only`` runs — a
  SIGKILL mid-super-task recomputes exactly the lost cluster),
  ``scheduler.replan`` re-places the remaining work on the survivors, and
  ``stats["recomputed"]`` counts exactly ``len(plan)``.  A SIGKILL
  mid-transfer degrades the same way: consumers that already hold a stale
  handle report ``deplost`` and the super-task re-queues behind the
  recovery.
* **Speculative re-execution of stragglers.**  Purity makes duplication
  free, so with ``speculate_after=x`` an *idle* worker (no ready work
  anywhere) duplicates the most-overdue running super-task — one running
  more than ``x×`` its expected duration, where *expected* is the static
  ``list_schedule`` cost-model hint calibrated into seconds by a runtime
  EWMA of actual-vs-planned durations.  The twin placement is
  **locality-aware**: among idle workers the one nearest the task's input
  bytes (same-host copies count half of cross-host ones) runs it.  The
  first completion wins; losers get an idempotent ``cancel`` (honored
  between tasks — a loser already executing finishes and its late
  ``done`` is reconciled: recorded as a legitimate extra replica, or
  swept when the GC already dropped the value).  The *pick* is
  :func:`repro_torch.core.simulator.pick_speculation`, shared with the
  simulator so policy and model provably agree.  ``stats`` reports
  ``n_speculative`` / ``speculative_wins`` / ``speculative_wasted_s``;
  see ``docs/speculation.md``.
* **Elasticity.**  ``add_worker()`` forks a fresh worker mid-run and
  replans onto the grown pool; on a TCP control plane, any
  ``repro-worker`` that dials the driver's address mid-run joins the same
  way.
* **Segment hygiene.**  The driver is the single unlink authority:
  handles are released when the ``consumers_left`` GC drains a value
  (``outputs_only`` runs unlink eagerly), and a run-scoped shutdown sweep
  catches ``/dev/shm`` orphans *and* stale peer-socket files from workers
  killed mid-publish.  No segment or socket file survives executor
  shutdown.

Failure injection for tests/benchmarks: ``fail_worker=(wid, n)`` SIGKILLs
worker ``wid`` after it completes ``n`` super-tasks (a remote worker is
sent a ``die`` message instead — the driver cannot signal a remote pid);
``join_after=(n, k)`` starts ``k`` extra workers once ``n`` super-tasks
have completed cluster-wide.
"""
from __future__ import annotations

import bisect
import multiprocessing as mp
import os
import pickle
import signal
import tempfile
import threading
import time
import uuid
from dataclasses import dataclass, field
from multiprocessing.connection import wait as conn_wait
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.checkpoint.runlog import (RunLog, graph_fingerprint,
                                     plan_fingerprint)
from repro_torch.config import ClusterConfig, resolve_config
from repro_torch.core.collectives import (CollectivesSpec, lower_collectives,
                                    parse_collectives_spec)
from repro_torch.core.executor import MissingInput, TaskFailed
from repro_torch.core.adaptive import (CostModel, RefuseGovernor, RunTrace,
                                 fn_key, refusion_due)
from repro_torch.core.fusion import (DEFAULT_FANIN_COST, DEFAULT_GROUP_COST,
                               DEFAULT_KEEP_PARALLELISM, FusedPlan, FuseSpec,
                               fuse as fuse_graph, offset_plan,
                               parse_fuse_spec, refuse_frontier, splice_plan)
from repro_torch.core.graph import TaskGraph, TaskKind
from repro_torch.core.lineage import outage_recovery, recovery_plan_clusters
from repro_torch.core.scheduler import fair_interleave, list_schedule, replan
from repro_torch.core.tracing import offset_graph
from repro_torch.core.simulator import pick_speculation

from repro_torch.faults import FaultPlan, FaultyChannel, FaultyListener

from . import serde
from .channel import (CHANNELS, ChannelClosed, PipeChannel, SpawnChannel,
                      TcpChannel, TcpListener, _recv_frame, _send_frame,
                      host_id, is_silence, routable_ip)
from .futures import ClusterFuture
from .objectstore import DriverObjectStore
from .worker import pipe_worker_main, tcp_worker_main

PENDING, READY, WAITING, INFLIGHT, DONE = range(5)
# terminal state for clusters of a failed/cancelled resident-mode job:
# never dispatched, never resurrected by recovery, never counted done
CANCELLED = 5

WORKER_SPECS = ("local", "remote")


def default_start_method() -> str:
    """How local workers start when the config does not say: ``"spawn"``
    once this process has initialised CUDA (a forked child cannot use it
    then), else the cheaper ``"fork"``."""
    import torch
    return "spawn" if torch.cuda.is_initialized() else "fork"


class DriverKilled(RuntimeError):
    """Emulated driver SIGKILL (the ``fail_driver`` chaos knob): raised
    mid-run after N cluster completions with every shutdown path skipped —
    worker sockets and the listener are torn down abruptly, no ``stop`` is
    sent, no shm sweep runs — exactly the residue a real ``kill -9`` of
    the driver process leaves.  Carries the run id so a test (or operator)
    can resume: ``ClusterExecutor(..., checkpoint_dir=d, resume=run_id)``.
    """

    def __init__(self, run_id: str) -> None:
        super().__init__(f"driver killed (emulated) during run {run_id}")
        self.run_id = run_id


class JobCancelled(RuntimeError):
    """A resident-mode job was cancelled (client disconnect, quota
    enforcement, or an explicit :meth:`ClusterExecutor.cancel_job`)
    before it completed."""


@dataclass
class _Worker:
    wid: int
    chan: Any                       # driver-side Channel
    host: str                       # machine identity (locality grouping)
    proc: Any = None                # local process handle; None for remote
    alive: bool = True
    inflight: Set[int] = field(default_factory=set)   # run sent, not done
    assigned: Set[int] = field(default_factory=set)   # waiting on transfers
    outbox: List[tuple] = field(default_factory=list)  # coalesced sends
    n_done: int = 0

    def load(self) -> int:
        return len(self.inflight) + len(self.assigned)


@dataclass
class _Job:
    """A tenant submission admitted into the resident run: an offset
    (collision-free) slice of the union graph plus everything needed to
    resolve its future back in the submitter's own id space."""
    job_id: int
    tenant: str
    base: int                       # id range [base, end) in the union
    end: int
    graph: TaskGraph                # offset lowered graph
    plan: FusedPlan                 # offset job-local plan
    required: Set[int]              # offset value tids to collect
    user_required: List[int]        # result keys, submitter id space
    coll_map: Optional[Dict[int, int]]  # user tid -> offset lowered tid
    inputs: Dict[str, Any]          # namespaced ("j<id>/<name>") inputs
    future: ClusterFuture
    cids: frozenset                 # offset cluster ids
    submitted: float = 0.0          # perf_counter at submit_job()
    first_dispatch: Optional[float] = None
    terminal: bool = False          # finished, failed, or cancelled
    # this job's share of the run-wide counters: the launches and member
    # tasks its super-tasks' ``done`` messages reported, and its recomputed
    # super-tasks
    kernel_launches: Dict[str, int] = field(default_factory=dict)
    tasks_run: Dict[str, int] = field(default_factory=dict)
    recomputed: int = 0


class ClusterExecutor:
    """Executes a :class:`TaskGraph` on a pool of worker processes.

    Satisfies the :class:`repro_torch.core.executor.Executor` protocol — results
    are bit-identical to :func:`repro_torch.core.executor.execute_sequential`
    because tasks are pure and the value tables are exact.

    **Graph compilation** (``fuse``): ``"off"`` (the default — one
    dispatch per task, the PR-1..4 behavior), ``"auto"`` (fuse chains /
    small fan-ins / sibling groups with the default cost model), or an
    integer ``N`` (auto rules, clusters capped at ``N`` members).  Fusion
    changes *granularity only*: results, lineage recovery, and the
    ``{tid: value}`` return contract are unchanged — fine-grained graphs
    just stop paying one driver round-trip per node.  See
    ``docs/fusion.md``.

    **Control plane** (``channel``): ``"pipe"`` (forked in-host workers,
    the default), ``"spawn"`` (fresh-interpreter in-host workers; implied
    by ``start_method="spawn"``), or ``"tcp"`` (workers dial the driver's
    listening address — the multi-host channel, with heartbeat liveness).
    With ``channel="tcp"`` the driver binds ``connect`` (default
    ``127.0.0.1:0``; the resolved address is :attr:`address`) and
    ``workers`` describes the pool: ``"local"`` entries are forked dialers
    started by the driver, ``"remote"`` entries are slots filled by
    external ``repro-worker`` processes (``python -m repro_torch.launch.remote
    --connect <address>``) within ``accept_timeout``.  Extra dials during
    a run join elastically.

    **Data plane** (``transport``): ``"shm"`` (zero-copy shared memory),
    ``"sock"`` (direct unix-socket pulls), ``"tcp"`` (direct TCP pulls —
    the only bulk channel that crosses hosts; same-host pairs still ride
    shm via dual-published handles), ``"driver"`` (relay through the
    control channel), or ``"auto"`` (best available; ``tcp`` when the
    pool spans hosts).  ``shm_threshold`` is the payload size at which
    values leave the control channel.  The resolved choice of an ``auto``
    run is exposed as ``transport_used`` after ``run``.

    ``outputs_only=True`` returns just ``{tid: value for tid in outputs}``
    and garbage-collects intermediates once their last consumer finishes —
    the memory-bounded production mode, where shm segments are unlinked
    eagerly and lineage recovery recomputes *dropped* ancestors too.
    (Under fusion, intra-cluster intermediates never exist outside the
    worker's execution frame in the first place.)

    ``speculate_after=x`` enables speculative re-execution of stragglers:
    an idle worker duplicates a super-task running longer than ``x×`` its
    expected duration, first completion wins, the loser is cancelled
    between tasks.  Off (``None``) by default — duplication costs work, so
    it is opt-in for tail-latency-sensitive runs (``docs/speculation.md``).
    """

    def __init__(
        self,
        n_workers: Optional[int] = None,
        *,
        config: Optional[ClusterConfig] = None,
        **legacy: Any,
    ) -> None:
        # All runtime knobs live on one frozen repro_torch.ClusterConfig; the
        # historical keyword arguments keep working for one release via
        # the shim (DeprecationWarning, once per name — repro/config.py).
        cfg = resolve_config(config, legacy)
        if n_workers is not None:
            cfg = cfg.replace(n_workers=n_workers)
        self.config = cfg
        (policy, worker_speed, pipeline_depth, outputs_only, fail_worker,
         join_after, progress_timeout, start_method, seed, transport,
         shm_threshold, bandwidth, channel, connect, workers, token,
         accept_timeout, heartbeat_interval, heartbeat_timeout,
         speculate_after, fuse, collectives, checkpoint_dir,
         checkpoint_interval, resume, rejoin_timeout, rejoin_window,
         fail_driver, fault_plan, suspect_grace, quarantine_after,
         probe_interval, heartbeat_jitter, fetch_retry) = (
            cfg.policy, cfg.worker_speed, cfg.pipeline_depth,
            cfg.outputs_only, cfg.fail_worker, cfg.join_after,
            cfg.progress_timeout, cfg.start_method, cfg.seed,
            cfg.transport,
            cfg.shm_threshold if cfg.shm_threshold is not None
            else serde.SHM_THRESHOLD,
            cfg.bandwidth, cfg.channel, cfg.connect,
            cfg.workers, cfg.token, cfg.accept_timeout,
            cfg.heartbeat_interval, cfg.heartbeat_timeout,
            cfg.speculate_after, cfg.fuse, cfg.collectives,
            cfg.checkpoint_dir, cfg.checkpoint_interval, cfg.resume,
            cfg.rejoin_timeout, cfg.rejoin_window, cfg.fail_driver,
            cfg.fault_plan, cfg.suspect_grace, cfg.quarantine_after,
            cfg.probe_interval, cfg.heartbeat_jitter, cfg.fetch_retry)
        n_workers = cfg.n_workers
        if start_method is None:
            start_method = default_start_method()
        if start_method not in ("fork", "spawn", "forkserver"):
            raise ValueError(f"unknown start_method {start_method!r}")
        if resume is not None:
            if checkpoint_dir is None:
                raise ValueError("resume requires checkpoint_dir")
            from repro_torch.checkpoint.runlog import load_run
            self._resume_state = load_run(
                os.path.join(checkpoint_dir, f"{resume}.log"))
            meta = self._resume_state.meta
            # plan identity: fusion spec / GC mode / resolved transport come
            # from the interrupted run, not from this constructor's defaults
            fuse = meta.get("fuse", fuse)
            collectives = meta.get("collectives", collectives)
            outputs_only = meta.get("outputs_only", outputs_only)
            if connect is None:
                connect = meta.get("address")
            if channel is None:
                channel = meta.get("channel")
            transport = meta.get("transport", transport)
        else:
            self._resume_state = None
        if fail_driver is not None and fail_driver < 1:
            raise ValueError("fail_driver must be a positive completion "
                             "count (or None to disable crash emulation)")
        if workers is not None:
            workers = list(workers)
            bad = [w for w in workers if w not in WORKER_SPECS]
            if bad:
                raise ValueError(f"unknown worker spec(s) {bad!r} "
                                 f"(expected one of {WORKER_SPECS})")
            n_workers = len(workers)
        if n_workers < 1:
            raise ValueError("n_workers >= 1")
        self.worker_specs = workers or ["local"] * n_workers
        self.multihost = "remote" in self.worker_specs
        if channel is None:
            if connect is not None or self.multihost:
                channel = "tcp"
            else:
                channel = "pipe" if start_method == "fork" else "spawn"
        if channel not in CHANNELS:
            raise ValueError(f"unknown channel {channel!r} "
                             f"(expected one of {CHANNELS})")
        if channel == "spawn" and start_method == "fork":
            start_method = "spawn"
        if channel == "pipe" and start_method != "fork":
            channel = "spawn"       # pipe wiring, spawn launch contract
        if self.multihost and channel != "tcp":
            raise ValueError("remote workers require channel='tcp'")
        if transport not in serde.TRANSPORTS:
            raise ValueError(f"unknown transport {transport!r} "
                             f"(expected one of {serde.TRANSPORTS})")
        if self.multihost and transport not in serde.CROSS_HOST_TRANSPORTS:
            raise ValueError(
                f"transport {transport!r} is host-local and the worker pool "
                f"declares remote workers; pick one of "
                f"{serde.CROSS_HOST_TRANSPORTS}")
        self.start_method = start_method
        self.channel = channel
        self.n_workers = n_workers
        self.policy = policy
        self.worker_speed = list(worker_speed) if worker_speed else None
        self.pipeline_depth = max(1, pipeline_depth)
        self.outputs_only = outputs_only
        self.fail_worker = fail_worker
        self.join_after = join_after
        self.progress_timeout = progress_timeout
        self.seed = seed
        self.transport = transport
        self.transport_used: Optional[str] = None
        self.shm_threshold = max(1, shm_threshold)
        self.bandwidth = bandwidth
        self.token = token
        self.accept_timeout = accept_timeout
        self.heartbeat_interval = heartbeat_interval
        self.heartbeat_timeout = heartbeat_timeout
        if speculate_after is not None and speculate_after <= 0:
            raise ValueError("speculate_after must be a positive "
                             "×expected-duration multiple (or None to "
                             "disable speculation)")
        self.speculate_after = speculate_after
        # adaptive replanning policy (docs/adaptive.md): "off" pins every
        # planning decision to plan time; "auto" closes the measurement
        # loop (calibrated scheduling, mid-run re-fusion, derived knobs)
        self.adaptive = cfg.adaptive
        self.keep_parallelism = cfg.keep_parallelism
        self.refuse_skew = cfg.refuse_skew
        self.fuse = parse_fuse_spec(fuse)   # raises on junk, at the flag
        # collective lowering spec ("auto" | "off" | arity int): identity
        # for collective-free graphs, so the default costs nothing
        self.collectives = parse_collectives_spec(collectives)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_interval = checkpoint_interval
        self.resume = resume
        self.rejoin_timeout = rejoin_timeout
        self.rejoin_window = rejoin_window
        self.fail_driver = fail_driver
        # -- failure-handling policy (see docs/faults.md) ---------------
        # fault_plan: seeded injection plan; wraps every channel (and the
        # listener) in Faulty* decorators and ships the plan to workers so
        # their peer fetches are injectable too
        self.fault_plan = fault_plan
        # suspect_grace: seconds a silence-based (heartbeat) death verdict
        # is held as a *suspicion* before lineage recovery runs — a
        # partitioned-but-alive worker whose frames resume inside the
        # window heals with zero recomputation.  0 restores kill-on-silence.
        self.suspect_grace = max(0.0, suspect_grace)
        # flakiness scoring: a worker that goes suspect-then-heals
        # quarantine_after times is quarantined (no new dispatches, existing
        # work drains) and probed: after probe_interval of verified-healthy
        # channel it is re-admitted with its score halved
        self.quarantine_after = max(1, quarantine_after)
        self.probe_interval = max(0.0, probe_interval)
        self.heartbeat_jitter = heartbeat_jitter
        # fetch_retry: RetryPolicy workers apply to peer fetches (None =
        # serde's built-in default)
        self.fetch_retry = fetch_retry
        self.run_id: Optional[str] = None
        self.host = host_id()
        self.seg_prefix: Optional[str] = None    # last run's shm name prefix
        self.stats: Dict[str, Any] = {}
        self.wall_time = 0.0
        self.recovery_events: List[Dict[str, Any]] = []
        # one entry per twin launched: {tid, primary, twin, t} — live during
        # the run (tests/chaos hooks poll it to aim a kill at the primary)
        self.speculation_events: List[Dict[str, Any]] = []
        self._commands: List[Tuple] = []
        self._cmd_lock = threading.Lock()
        # -- resident (gateway) mode: one long-lived run admitting jobs --
        self._next_base = 0              # next free id-range base
        self._job_seq = 0
        self._resident: Optional[threading.Thread] = None
        self._resident_error: Optional[BaseException] = None
        self._shutdown = threading.Event()
        self._tenant_weights: Dict[str, float] = {}
        # stats/recovery_events/wall_time are per-run instance attributes,
        # so one executor runs ONE graph at a time; concurrent submissions
        # queue on this lock (use separate executors for parallel jobs)
        self._run_lock = threading.Lock()
        self._active = False
        # the listener outlives runs: remote workers need a stable address
        # to dial before run() is even called
        self.listener: Optional[TcpListener] = None
        self.address: Optional[str] = None
        if channel == "tcp":
            self.listener = TcpListener(connect or "127.0.0.1:0",
                                        token=token)
            if fault_plan is not None:
                self.listener = FaultyListener(self.listener, fault_plan)
            self.address = self.listener.address

    # ------------------------------------------------------------- frontend
    def run(self, graph: TaskGraph,
            inputs: Optional[Dict[str, Any]] = None) -> Dict[int, Any]:
        return self._execute(graph, inputs)

    def submit(self, graph: TaskGraph,
               inputs: Optional[Dict[str, Any]] = None,
               label: str = "") -> ClusterFuture:
        """Async submission: returns immediately with a future; the run
        executes on a background driver thread with a fresh worker pool.
        Runs on the SAME executor serialize (stats are per-run) — use one
        executor per job for true inter-job concurrency."""
        fut = ClusterFuture(label)

        def drive() -> None:
            try:
                result, stats, wall = self._execute_with_stats(graph, inputs)
                fut._set_result(result, stats=stats, wall_time=wall)
            except BaseException as e:   # noqa: BLE001 — carried by future
                fut._set_error(e)

        threading.Thread(target=drive, daemon=True,
                         name=f"cluster-driver-{label or id(fut)}").start()
        return fut

    def add_worker(self) -> None:
        """Elastic join: grow the pool (mid-run if a run is active)."""
        with self._cmd_lock:
            if self._active:
                self._commands.append(("join",))
            else:
                self.n_workers += 1
                self.worker_specs.append("local")

    def kill_worker(self, wid: int) -> None:
        """Chaos hook: SIGKILL worker ``wid`` of the active run."""
        with self._cmd_lock:
            self._commands.append(("kill", wid))

    # --------------------------------------------------- resident (gateway)
    def start_resident(self) -> None:
        """Start the long-lived resident driver: bring up the worker pool
        on a background thread and keep the run open indefinitely,
        admitting graphs submitted via :meth:`submit_job` into one shared
        union run.  Multiple tenants' jobs execute concurrently on the
        SAME pool (contrast :meth:`submit`, which serializes whole runs on
        the run lock).  The gateway service (:mod:`repro_torch.gateway`) is the
        intended caller; stop with :meth:`shutdown_resident`."""
        if self._resident is not None and self._resident.is_alive():
            return
        self._shutdown.clear()
        self._resident_error = None
        pool_up = threading.Event()

        def drive() -> None:
            try:
                with self._run_lock:
                    self._execute_locked(TaskGraph(), {}, resident=True,
                                         pool_up=pool_up)
            except BaseException as e:  # noqa: BLE001 — surfaced on jobs
                self._resident_error = e
            pool_up.set()
            # jobs queued after the loop died would hang forever: fail
            # them with the cause (admitted jobs were failed in the run)
            exc = self._resident_error or RuntimeError(
                "resident executor shut down")
            with self._cmd_lock:
                cmds, self._commands = self._commands, []
            for cmd in cmds:
                if cmd[0] == "job":
                    cmd[1].future._set_error(exc)

        self._resident = threading.Thread(
            target=drive, daemon=True, name="cluster-resident-driver")
        self._resident.start()
        if self.start_method == "fork":
            # the driver thread forks the pool: return once it has, so no
            # fork overlaps the caller's next imports.  A worker forked
            # while this thread held a module's import lock inherits the
            # lock held by no thread of its own, and its first import of
            # that module (a recipe's config, say) waits for ever
            pool_up.wait()

    def submit_job(self, graph: TaskGraph,
                   inputs: Optional[Dict[str, Any]] = None, *,
                   tenant: str = "default",
                   outputs_only: Optional[bool] = None,
                   label: str = "",
                   admission=None) -> ClusterFuture:
        """Admit ``graph`` into the resident run and return its future.

        ``admission`` is an optional gate called with the job's cluster
        count after fusion but before any id space is consumed or the job
        is queued; raising from it (the gateway raises
        :class:`repro_torch.gateway.QuotaExceeded`) aborts the submission with
        no residue.  The graph is lowered and fused in its own pristine
        id space (the
        deterministic passes every backend shares, so results stay
        bit-identical to ``execute_sequential``), then transplanted into
        a private ``[base, base+n)`` range of the union run — task ids,
        cluster ids, object-store keys, lineage and run-log records are
        all namespaced per job, and placeholder inputs become
        ``"j<id>/<name>"`` so two tenants' ``"x"`` never collide.  The
        future's result dict is keyed by the SUBMITTED graph's own ids.
        """
        if self._resident is None or not self._resident.is_alive():
            if self._resident_error is not None:
                raise RuntimeError("resident executor died") \
                    from self._resident_error
            raise RuntimeError(
                "submit_job requires a resident executor "
                "(call start_resident() first)")
        graph.validate()
        oo = self.outputs_only if outputs_only is None else outputs_only
        user_graph = graph
        lowered, coll_map = lower_collectives(graph, self.collectives)
        jplan = fuse_graph(lowered, self.fuse)
        user_required = (sorted(user_graph.outputs) if oo
                         else sorted(user_graph.nodes))
        if admission is not None:
            admission(len(jplan.cgraph.nodes))
        width = (max(lowered.nodes) + 1) if lowered.nodes else 0
        with self._cmd_lock:
            base = self._next_base
            self._next_base += width
            job_id = self._job_seq
            self._job_seq += 1
        ns = f"j{job_id}/"
        off_graph = offset_graph(lowered, base, input_ns=ns)
        off_plan = offset_plan(jplan, base, off_graph)
        if coll_map is None:
            cmap = None
            req = {t + base for t in user_required}
        else:
            cmap = {t: coll_map[t] + base for t in user_graph.nodes}
            req = {cmap[t] for t in user_required}
        fut = ClusterFuture(label or f"{tenant}/j{job_id}")
        # admission-control hints for the gateway: cluster count and job
        # id are known the moment the job is fused, long before the
        # resident loop admits it (cancel_job takes the job id)
        fut.n_clusters = len(off_plan.cgraph.nodes)
        fut.job_id = job_id
        job = _Job(job_id=job_id, tenant=tenant, base=base,
                   end=base + width, graph=off_graph, plan=off_plan,
                   required=req, user_required=list(user_required),
                   coll_map=cmap,
                   inputs={ns + k: v for k, v in (inputs or {}).items()},
                   future=fut, cids=frozenset(off_plan.cgraph.nodes),
                   submitted=time.perf_counter())
        with self._cmd_lock:
            self._commands.append(("job", job))
        return fut

    def cancel_job(self, job_id: int, reason: str = "cancelled") -> None:
        """Cancel an admitted job (client disconnect, quota enforcement):
        its future fails with :class:`JobCancelled`, its unfinished
        clusters are withdrawn and its values collected — other tenants'
        jobs are untouched."""
        with self._cmd_lock:
            self._commands.append(
                ("canceljob", job_id, JobCancelled(reason)))

    def log_record(self, *record) -> None:
        """Journal an out-of-band record into the resident run's log (a
        no-op when checkpointing is off).  The gateway uses this for its
        ``session``/``sessionend`` records so a resumed gateway can
        re-create tenant sessions; the append happens on the driver
        thread, keeping the run log single-writer."""
        with self._cmd_lock:
            self._commands.append(("logrec", record))

    def set_tenant_weight(self, tenant: str, weight: float) -> None:
        """Fair-share weight for ``tenant`` in the resident dispatch tier
        (default 1.0; higher means more dispatch slots under contention,
        fractions accumulate as deficits)."""
        self._tenant_weights[tenant] = float(weight)

    def shutdown_resident(self, timeout: float = 30.0) -> None:
        """Stop the resident driver and tear down the pool.  Jobs still
        in flight fail with ``"resident executor shut down"`` — the
        gateway drains its sessions before calling this.  Re-raises the
        resident loop's error, if it died of one."""
        if self._resident is None:
            return
        self._shutdown.set()
        self._resident.join(timeout=timeout)
        self._resident = None
        if self._resident_error is not None:
            err, self._resident_error = self._resident_error, None
            raise err

    def close(self) -> None:
        """Release the executor's listening socket (TCP channel only)."""
        if self.listener is not None:
            self.listener.close()
            self.listener = None

    def __del__(self) -> None:      # pragma: no cover — GC timing
        try:
            self.close()
        except Exception:
            pass

    # -------------------------------------------------------------- driver
    def _execute(self, graph: TaskGraph,
                 inputs: Optional[Dict[str, Any]]) -> Dict[int, Any]:
        return self._execute_with_stats(graph, inputs)[0]

    def _execute_with_stats(self, graph: TaskGraph,
                            inputs: Optional[Dict[str, Any]]):
        """Run + a stats/wall_time snapshot taken while the run lock is
        still held — a queued submission on the same executor reassigns
        the per-run fields the moment the lock is released."""
        graph.validate()
        with self._run_lock:
            result = self._execute_locked(graph, inputs)
            return result, dict(self.stats), self.wall_time

    def _execute_locked(self, graph: TaskGraph,
                        inputs: Optional[Dict[str, Any]],
                        resident: bool = False,
                        pool_up: Optional[threading.Event] = None
                        ) -> Dict[int, Any]:
        if resident:
            # the union run admits jobs mid-flight: its graph/inputs are
            # live mutable objects, growing at admission, shrinking at
            # retirement
            inputs = dict(inputs) if inputs else {}
        ctx = mp.get_context(self.start_method)
        transport = self.transport_used = serde.resolve_transport(
            self.transport, multihost=self.multihost)
        seg_prefix = self.seg_prefix = f"rr{os.getpid():x}" \
                                       f"{uuid.uuid4().hex[:8]}"
        peer_dir = (tempfile.mkdtemp(prefix="rrpeer")
                    if transport == "sock" else None)
        driver_namer = serde.SegmentNamer(f"{seg_prefix}d")

        # -- collective lowering: COLLECTIVE nodes become staged tree hops
        # BEFORE fusion/scheduling, so the whole driver below (and every
        # worker, which receives this graph) runs over the lowered DAG.
        # coll_map is None for the identity (no collectives / spec off) —
        # the common case, which stays byte-identical to the old runtime.
        # The run's external contract stays in USER tids: ``required`` is
        # mapped through coll_map and mapped back in the return dict.
        user_graph = graph
        graph, coll_map = lower_collectives(graph, self.collectives)
        user_required = (set(user_graph.outputs) if self.outputs_only
                         else set(user_graph.nodes))

        # -- graph compilation: the driver below runs over the CLUSTER graph
        # (fuse="off" -> identity plan, cg is graph, cluster id == task id).
        # A resident run starts from an explicitly EMPTY non-identity plan:
        # jobs are fused in their own id space at submit time and spliced
        # in at admission — the union must never be the identity plan, or
        # the first fused job would collide the cid and tid namespaces.
        # keep_parallelism for the INITIAL fuse: explicit config wins;
        # adaptive mode derives it from the pool size (never below the
        # static default, so small pools reproduce historical plans); a
        # resumed run replays the interrupted run's pinned value so the
        # plan fingerprint below can match even if the pool changed.
        if self._resume_state is not None:
            kp = self._resume_state.meta.get(
                "keep_par", DEFAULT_KEEP_PARALLELISM)
        elif self.keep_parallelism is not None:
            kp = self.keep_parallelism
        elif self.adaptive != "off":
            kp = max(DEFAULT_KEEP_PARALLELISM, 2 * self.n_workers)
        else:
            kp = DEFAULT_KEEP_PARALLELISM
        if resident:
            plan = FusedPlan(graph=graph, cgraph=TaskGraph(), members={},
                             cluster_of={}, outputs={}, ext_deps={},
                             consumers={}, spec=self.fuse)
        else:
            plan = fuse_graph(graph, self.fuse, keep_parallelism=kp)
        cg = plan.cgraph
        required = (user_required if coll_map is None
                    else {coll_map[t] for t in user_required})
        fusion_view = plan.worker_view(required)

        stats = self.stats = {
            "dispatched": 0, "steals": 0, "transfers": 0, "recomputed": 0,
            "failures": 0, "joins": 0, "dropped": 0,
            "transfers_direct": 0, "transfers_driver": 0,
            "bytes_moved": 0, "bytes_driver": 0, "bytes_direct": 0,
            "n_speculative": 0, "speculative_wins": 0,
            "speculative_swept": 0, "speculative_wasted_s": 0.0,
            "n_clusters": len(cg.nodes), "tasks_fused": plan.n_fused,
            # collective-lowering observability: how many user collective
            # roots the run had, and how many staged hop nodes they became
            "collective_roots": sum(
                1 for n in user_graph.nodes.values()
                if n.kind is TaskKind.COLLECTIVE and "collective" in n.meta),
            "collective_stages": (0 if coll_map is None
                                  else len(graph.nodes)
                                  - len(user_graph.nodes)),
            "control_msgs": 0, "control_frames": 0,
            "dispatch_overhead_s": 0.0, "resumed_clusters": 0,
            # failure-policy observability: suspicion episodes and their
            # outcomes (healed vs escalated to death), driver-relay
            # degradations that saved a recompute, and the quarantine
            # round-trip counters
            "suspected": 0, "healed": 0, "relay_fallbacks": 0,
            "quarantined": 0, "readmitted": 0, "deplosts": 0,
            # adaptive-replanning observability (docs/adaptive.md): the
            # calibrated cost unit (seconds per abstract cost unit), the
            # measured per-dispatch overhead, how many mid-run re-fusions
            # fired (and how many a resume replayed from the journal),
            # calibrated replans triggered, the governor's last observed
            # skew, and the variance-derived speculation threshold
            "cost_unit_s": 0.0, "dispatch_cost_s": 0.0,
            "refusions": 0, "refusions_replayed": 0, "replan_triggers": 0,
            "adaptive_skew": 0.0, "adaptive_speculate_after": 0.0,
            "first_done_s": 0.0, "last_done_s": 0.0,
            # kernel launches the workers reported with their done messages,
            # and the member tasks of those super-tasks by name (a
            # recomputed or duplicated super-task counts each time it ran)
            "kernel_launches": {}, "tasks_run": {},
        }
        if resident:
            stats.update({"jobs_admitted": 0, "jobs_completed": 0,
                          "jobs_failed": 0})
        launched, ran = stats["kernel_launches"], stats["tasks_run"]
        self.recovery_events = []
        self.speculation_events = []
        t0 = time.perf_counter()

        # -- durable control-plane state: one append-only run log per run.
        # A fresh run writes a `begin` record pinning everything plan
        # identity depends on; a resumed run validates those fingerprints
        # (same graph + same fusion => same cluster ids, so the logged
        # frontier is meaningful) and appends a `resume` marker carrying
        # the new shm prefix.
        rs = self._resume_state
        self._resume_state = None
        run_id = self.run_id = self.resume or uuid.uuid4().hex[:12]
        self.resume = None
        graph_fp = graph_fingerprint(graph)
        plan_fp = plan_fingerprint(plan)
        old_prefixes: List[str] = []
        if rs is not None:
            if rs.meta.get("graph_fp") != graph_fp:
                raise ValueError(
                    f"resume {run_id}: graph does not match the "
                    "interrupted run (task ids / deps / kinds differ)")
            if rs.meta.get("plan_fp") != plan_fp:
                raise ValueError(
                    f"resume {run_id}: fusion plan does not match the "
                    "interrupted run (cluster identity differs)")
            old_prefixes = [p for p in rs.seg_prefixes if p != seg_prefix]
            # replay journaled adaptive re-fusions IN ORDER before any
            # resume bookkeeping: the interrupted run's `done` claims for
            # post-refusion cids only make sense against the post-splice
            # plan, and the object store built below must count consumers
            # against that plan too.  plan_fp above pinned the PRE-splice
            # plan, so fingerprints were compared apples-to-apples.
            for retired, clusters in rs.refusions:
                splice_plan(plan, retired, [tuple(c) for c in clusters])
            if rs.refusions:
                fusion_view = plan.worker_view(required)
                stats["n_clusters"] = len(cg.nodes)
                stats["tasks_fused"] = plan.n_fused
                stats["refusions_replayed"] = len(rs.refusions)
        runlog: Optional[RunLog] = None
        if self.checkpoint_dir is not None:
            os.makedirs(self.checkpoint_dir, exist_ok=True)
            runlog = RunLog(
                os.path.join(self.checkpoint_dir, f"{run_id}.log"),
                interval=self.checkpoint_interval)
            if rs is None:
                runlog.append("begin", {
                    "run_id": run_id, "graph_fp": graph_fp,
                    "plan_fp": plan_fp, "fuse": self.fuse,
                    "collectives": self.collectives,
                    "outputs_only": self.outputs_only,
                    "address": self.address, "channel": self.channel,
                    "transport": transport, "seg_prefix": seg_prefix,
                    "n_clusters": len(cg.nodes), "resident": resident,
                    "keep_par": kp, "adaptive": self.adaptive,
                })
            else:
                runlog.append("resume", {"seg_prefix": seg_prefix})
            runlog.flush()
            # resume lease: tells a repro-worker's startup sweep that this
            # run's shm segments are (or may soon be) owned by a live or
            # resumable driver — even when the recorded driver pid is dead
            # (a SIGKILL'd driver inside its rejoin window).  The lease is
            # refreshed from the main loop and cleared on clean shutdown;
            # old incarnations' prefixes are re-leased because their
            # surviving segments are this run's recovery inputs.
            lease_window = (self.rejoin_window
                            if self.rejoin_window is not None
                            else max(60.0, self.progress_timeout))
            for p in [seg_prefix] + old_prefixes:
                serde.write_resume_lease(p, run_id, lease_window)
            last_lease = time.monotonic()

        store = DriverObjectStore(graph, plan=plan)
        workers: Dict[int, _Worker] = {}
        # resumed runs keep the interrupted run's worker-id space: rejoiners
        # reclaim their old wid, fresh spawns start above every recorded one
        next_wid = (max(rs.workers) + 1 if rs is not None and rs.workers
                    else 0)
        listener = self.listener
        # graph shipped once per run to graph-less (remote) dialers
        graph_blob: List[Optional[bytes]] = [None]
        # handshaken dials not yet matched to the local proc that owns them
        dial_stash: List[Tuple[Any, dict]] = []

        def run_config(hello: dict) -> dict:
            # the address OTHER workers use to reach this worker's peer
            # data-plane server.  A local worker dials the driver over
            # loopback, so the IP the driver saw (127.x) is unroutable
            # from remote consumers — advertise this machine's real
            # interface instead when the pool spans hosts.
            # any TCP-listener run can gain cross-host joiners mid-run
            # (not just declared-remote pools), so the rewrite keys on
            # the data plane being TCP, not on self.multihost
            peer_ip = hello.get("peer_ip", "127.0.0.1")
            if listener is not None and transport == "tcp" \
                    and peer_ip.startswith("127."):
                peer_ip = routable_ip()
            return {
                "transport": transport,
                "shm_threshold": self.shm_threshold,
                "seg_prefix": seg_prefix,
                "peer_dir": peer_dir,
                "peer_host": peer_ip,
                "fusion": fusion_view,
                "heartbeat_interval": self.heartbeat_interval,
                # the worker tolerates a longer driver silence than the
                # driver tolerates of it: the driver's loop always has
                # traffic to send, a worker mid-task may not
                "worker_heartbeat_timeout": max(self.heartbeat_timeout * 3,
                                                self.progress_timeout),
                # checkpointed runs arm the worker-side rejoin loop: a
                # dropped driver socket means "re-dial with this run id for
                # up to rejoin_window seconds", not "exit".  Uncheckpointed
                # runs keep the die-on-silence contract — there is nothing
                # to resume into.
                "run_id": run_id if runlog is not None else None,
                "rejoin_window": (self.rejoin_window
                                  if self.rejoin_window is not None
                                  else max(60.0, self.progress_timeout)),
                "heartbeat_jitter": self.heartbeat_jitter,
                # data-plane fault injection + retry policy travel in the
                # welcome so every worker (forked, spawned, remote) applies
                # the same seeded plan to its peer fetches
                "fault_plan": self.fault_plan,
                "fetch_retry": self.fetch_retry,
            }

        def wrap_chan(chan: Any, wid: int) -> Any:
            """Decorate a driver-side channel with the run's fault plan
            (identity when no plan is armed).  The handshake itself stays
            raw — injection begins once the worker is adopted."""
            if self.fault_plan is None:
                return chan
            return FaultyChannel(chan, self.fault_plan, wid,
                                 silence_timeout=self.heartbeat_timeout)

        def ship_graph() -> bytes:
            if graph_blob[0] is None:
                try:
                    graph_blob[0] = pickle.dumps((graph, inputs), protocol=5)
                except Exception as e:
                    raise ValueError(
                        "graph is not picklable, so it cannot be shipped to "
                        "a remote worker that did not inherit it (use "
                        "module-level task functions, as with "
                        f"start_method='spawn'): {e!r}") from e
            return graph_blob[0]

        def adopt(sock, hello: dict, proc=None) -> _Worker:
            """Driver half of the TCP handshake: assign a wid, send the
            welcome (config + graph for graph-less workers), wrap the
            socket in a heartbeat-tracked channel."""
            nonlocal next_wid
            worker_host = hello.get("host", "?")
            if worker_host != self.host \
                    and transport not in serde.CROSS_HOST_TRANSPORTS:
                # a cross-host dial into a host-local data plane can never
                # resolve handles; refuse it with a reason, loudly
                msg = (f"worker on host {worker_host!r} cannot join a "
                       f"transport={transport!r} run (host-local data "
                       f"plane); use transport='tcp' or 'driver'")
                try:
                    from .channel import _send_frame
                    _send_frame(sock, pickle.dumps(("reject", msg),
                                                   protocol=5))
                except OSError:
                    pass
                try:
                    sock.close()
                except OSError:
                    pass
                raise ValueError(msg)
            try:
                blob = None if hello.get("has_graph") else ship_graph()
            except ValueError as e:
                try:
                    from .channel import _send_frame
                    _send_frame(sock, pickle.dumps(("reject", str(e)),
                                                   protocol=5))
                except OSError:
                    pass
                try:
                    sock.close()
                except OSError:
                    pass
                raise
            chan = TcpChannel(sock,
                              heartbeat_interval=self.heartbeat_interval,
                              heartbeat_timeout=self.heartbeat_timeout,
                              heartbeat_jitter=self.heartbeat_jitter,
                              proc=proc)
            wid = next_wid
            next_wid += 1
            try:
                chan.send(("welcome", wid, run_config(hello), blob))
            except ChannelClosed as e:
                chan.close()
                raise TimeoutError(f"worker dial died during welcome: "
                                   f"{e}") from e
            w = _Worker(wid, wrap_chan(chan, wid), worker_host, proc=proc)
            workers[wid] = w
            store.add_worker(wid, host=worker_host)
            if runlog is not None:
                runlog.append("worker", wid, worker_host)
            return w

        def heartbeat_all() -> None:
            """Keep already-adopted workers' driver-silence watchdogs fed
            while the driver is parked in an adoption barrier (the main
            loop isn't running yet, so nobody else sends)."""
            for w in workers.values():
                if w.alive:
                    w.chan.maybe_heartbeat()

        def adopt_dialer_for(proc) -> _Worker:
            """Match a handshaken dial to the local process we just
            started (by pid), stashing unrelated dials (remote workers
            arriving early) for later adoption."""
            assert listener is not None
            for i, (sock, hello) in enumerate(dial_stash):
                if hello.get("pid") == proc.pid:
                    dial_stash.pop(i)
                    return adopt(sock, hello, proc=proc)
            deadline = time.monotonic() + self.accept_timeout
            while True:
                if not proc.is_alive():
                    # a dialer that died at bootstrap (import error, OOM)
                    # will never dial: fail now with the real cause, not
                    # after a silent accept_timeout hang
                    raise RuntimeError(
                        f"local worker (pid {proc.pid}) exited with code "
                        f"{proc.exitcode} before dialing {self.address}")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"local worker pid {proc.pid} never dialed "
                        f"{self.address} within {self.accept_timeout}s")
                heartbeat_all()
                try:
                    sock, hello = listener.get_worker(min(0.5, remaining))
                except TimeoutError:
                    continue        # re-check the dialer's pulse
                if hello.get("pid") == proc.pid:
                    return adopt(sock, hello, proc=proc)
                dial_stash.append((sock, hello))

        def spawn() -> _Worker:
            """Start one local worker on the configured channel family."""
            nonlocal next_wid
            if self.channel == "tcp":
                # fork children must drop every inherited driver-side fd:
                # the listener (else a SIGKILL'd driver's port stays bound
                # by its own workers and the resumed driver can never
                # re-bind it) AND the accepted sockets of already-adopted
                # peers (a child holding a dup keeps that connection alive
                # past the driver's death, so the peer never sees EOF and
                # never starts its rejoin dial)
                inherited = ([listener.fileno()]
                             if listener is not None else [])
                for ow in workers.values():
                    s = getattr(ow.chan, "sock", None)
                    if ow.alive and s is not None:
                        try:
                            inherited.append(s.fileno())
                        except OSError:
                            pass
                proc = ctx.Process(
                    target=tcp_worker_main, args=(self.address,),
                    kwargs=({"token": self.token, "graph": graph,
                             "inputs": inputs,
                             "close_fds": tuple(inherited)}
                            if self.start_method == "fork"
                            else {"token": self.token}),
                    daemon=True, name="cluster-worker-dialer")
                proc.start()
                return adopt_dialer_for(proc)
            wid = next_wid
            next_wid += 1
            parent, child = ctx.Pipe(duplex=True)
            proc = ctx.Process(target=pipe_worker_main,
                               args=(wid, child, graph, inputs, transport,
                                     self.shm_threshold, seg_prefix,
                                     peer_dir, fusion_view,
                                     self.fault_plan, self.fetch_retry),
                               kwargs={"forked": self.start_method == "fork"},
                               daemon=True, name=f"cluster-worker-{wid}")
            proc.start()
            child.close()
            cls = PipeChannel if self.channel == "pipe" else SpawnChannel
            w = _Worker(wid, wrap_chan(cls(parent, proc), wid),
                        self.host, proc=proc)
            workers[wid] = w
            store.add_worker(wid, host=self.host)
            if runlog is not None:
                runlog.append("worker", wid, self.host)
            return w

        def adopt_remote() -> _Worker:
            """Fill one declared ``remote`` slot from the dial queue."""
            assert listener is not None
            if dial_stash:
                sock, hello = dial_stash.pop(0)
                return adopt(sock, hello, proc=None)
            deadline = time.monotonic() + self.accept_timeout
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"no worker dialed {self.address} within "
                        f"{self.accept_timeout}s (start workers with: "
                        f"python -m repro_torch.launch.remote --connect "
                        f"{self.address})")
                heartbeat_all()     # earlier adoptees must not starve
                try:
                    sock, hello = listener.get_worker(min(0.5, remaining))
                except TimeoutError:
                    continue
                return adopt(sock, hello, proc=None)

        rank = cg.critical_path_rank()
        csucc = cg.successors()
        n_total = len(cg.nodes)

        state: Dict[int, int] = {}
        for cid, node in cg.nodes.items():
            state[cid] = READY if not node.all_deps else PENDING
        done: Set[int] = set()
        finish_times: Dict[int, float] = {}
        # cid -> (wid, still-missing input value tids) for transfer-blocked
        waiting: Dict[int, Tuple[int, Set[int]]] = {}
        fetching: Dict[int, int] = {}    # value tid -> wid the fetch went to
        # -- partition-aware liveness (docs/faults.md): a silence verdict
        # is a SUSPICION first, a death only after suspect_grace ---------
        suspects: Dict[int, float] = {}     # wid -> first-suspected time
        flake_score: Dict[int, float] = {}  # wid -> suspect-then-heal count
        quarantined: Dict[int, float] = {}  # wid -> healthy-since (probe t0)
        # value tid -> inline handle: the driver-relay degradation for
        # deps whose direct transfer exhausted its retries with the owner
        # still alive (relayed, never recomputed)
        relay_handles: Dict[int, serde.Handle] = {}
        # -- speculation state: a super-task may run on SEVERAL workers --
        runners: Dict[int, Set[int]] = {}         # cid -> wids running it now
        run_started: Dict[int, Dict[int, float]] = {}  # cid -> wid -> t_start
        spec_twins: Dict[int, Set[int]] = {}      # cid -> speculative wids
        # expected durations: static plan hint (cost units), calibrated to
        # seconds by the cost model's EWMA of actual/planned — the same
        # 0.9/0.1 blend the launchers' straggler detector uses.  The model
        # is always fed (its unit_s subsumes the old bare ewma_ratio);
        # whether its output DRIVES decisions is gated on self.adaptive.
        planned_dur: Dict[int, float] = {
            c: max(n.cost, 1e-6) for c, n in cg.nodes.items()}
        cost_model = CostModel()
        governor = RefuseGovernor(skew_threshold=self.refuse_skew)
        # replayed re-fusions count against the per-run cap: a resumed
        # driver continues the interrupted run's budget, not a fresh one
        governor.fired = stats["refusions_replayed"]
        trace = RunTrace(n_workers=self.n_workers)
        self.last_trace = trace
        error: List[BaseException] = []
        join_after = self.join_after     # consumed per run, not per executor
        last_progress = time.perf_counter()

        # -- resident-mode job state: admitted jobs by id, plus a sorted
        # span index mapping ANY task/cluster id to its owning job (ids of
        # a job live in [base, end), cluster ids included; empty and inert
        # for ordinary single-graph runs) -------------------------------
        jobs: Dict[int, _Job] = {}
        job_spans: List[Tuple[int, int, _Job]] = []
        span_starts: List[int] = []

        def job_of(x: int) -> Optional[_Job]:
            i = bisect.bisect_right(span_starts, x) - 1
            if i >= 0:
                b, e, j = job_spans[i]
                if b <= x < e:
                    return j
            return None

        def alive_ids() -> List[int]:
            return [w.wid for w in workers.values() if w.alive]

        def speeds_for(wids: List[int]) -> Optional[List[float]]:
            if self.worker_speed is None:
                return None
            return [self.worker_speed[w % len(self.worker_speed)]
                    for w in wids]

        def hosts_for(wids: List[int]) -> List[str]:
            return [workers[w].host for w in wids]

        def alive_owner(tid: int) -> Optional[int]:
            return next((x for x in store.locations(tid)
                         if x in workers and workers[x].alive), None)

        def cluster_sizes() -> Dict[int, int]:
            """Per-cluster output bytes for the replan comm-cost term —
            only values that actually cross cluster edges count."""
            out: Dict[int, int] = {}
            for cid, outs in plan.outputs.items():
                s = sum(store.sizes.get(v, 0) for v in outs)
                if s:
                    out[cid] = s
            return out

        # planned placement: schedule slot i -> i-th alive worker id
        plan_worker: Dict[int, int] = {}

        def make_plan(initial: bool) -> None:
            wids = alive_ids()
            if not wids:
                return
            # calibrated scheduling (docs/adaptive.md): once the cost
            # model has a measured seconds-per-unit rate, scale abstract
            # costs into seconds so the scheduler's size/bandwidth comm
            # term competes on the same axis.  planned_dur stays in UNITS
            # (divided back below) — the speculation overdue test
            # multiplies by unit_s itself.
            scale = (cost_model.unit_s
                     if self.adaptive != "off" and cost_model.unit_s
                     else 1.0)
            try:
                if initial:
                    sched = list_schedule(
                        cg, len(wids), policy=self.policy,
                        worker_speed=speeds_for(wids), seed=self.seed,
                        worker_host=hosts_for(wids), cost_scale=scale)
                else:
                    # replanning mid-run knows value sizes and current
                    # placements: make the comm-cost term real so the new
                    # plan keeps consumers next to the bytes they need —
                    # and, via worker_host, on the right machine
                    placed = {}
                    for c in finish_times:
                        for v in plan.outputs[c]:
                            ow = alive_owner(v)
                            if ow is not None:
                                placed[c] = wids.index(ow)
                                break
                    sched = replan(
                        cg, dict(finish_times), len(wids),
                        now=time.perf_counter() - t0, policy=self.policy,
                        worker_speed=speeds_for(wids), seed=self.seed,
                        data_sizes=cluster_sizes(),
                        bandwidth=self.bandwidth, placed=placed,
                        worker_host=hosts_for(wids), cost_scale=scale)
            except Exception:            # plan is advisory; never fatal
                plan_worker.clear()
                return
            plan_worker.clear()
            for cid, p in sched.placements.items():
                plan_worker[cid] = wids[p.worker]
            # cost-model hint for the speculation overdue test, kept in
            # cost units (node.cost is the pre-plan fallback)
            for cid, dur in sched.expected_durations().items():
                planned_dur[cid] = max(dur / scale, 1e-6)
            if not initial:
                stats["replan_triggers"] += 1

        # ---------------------------------------------------------- helpers
        def post(w: _Worker, msg: tuple) -> None:
            """Buffer a control message in the worker's outbox; the pump
            loop flushes every outbox once per iteration through
            ``Channel.send_many`` — one pickle + one syscall per burst.
            A peer that died under the buffer surfaces at flush as a
            failure-handled event, exactly like a failed direct send."""
            w.outbox.append(msg)

        def flush(w: _Worker) -> bool:
            if not w.outbox:
                return True
            msgs, w.outbox = w.outbox, []
            t = time.perf_counter()
            try:
                w.chan.send_many(msgs)
            except ChannelClosed:
                stats["dispatch_overhead_s"] += time.perf_counter() - t
                on_worker_death(w)
                return False
            stats["control_msgs"] += len(msgs)
            stats["control_frames"] += 1
            stats["dispatch_overhead_s"] += time.perf_counter() - t
            return True

        def flush_all() -> None:
            for w in list(workers.values()):
                if w.alive and w.outbox:
                    flush(w)

        def safe_send(w: _Worker, msg: tuple) -> bool:
            """Immediate (unbatched) send for out-of-band messages
            (``die``/``stop``); an already-dead peer becomes a
            failure-handled event, never an exception out of the driver
            loop."""
            try:
                w.chan.send(msg)
                return True
            except ChannelClosed:
                on_worker_death(w)
                return False

        def account_pipe(handle: serde.Handle) -> None:
            n = serde.pipe_nbytes(handle)
            stats["bytes_driver"] += n
            stats["bytes_moved"] += n

        def account_transfer(handle: serde.Handle) -> None:
            p, d = serde.pipe_nbytes(handle), serde.direct_nbytes(handle)
            stats["bytes_driver"] += p
            stats["bytes_direct"] += d
            stats["bytes_moved"] += p + d
            if d > 0:
                stats["transfers_direct"] += 1
            else:
                stats["transfers_driver"] += 1
            stats["transfers"] += 1

        def task_error(tid: int, exc: BaseException) -> None:
            """Route a task-level failure: in a resident run a failure
            belonging to some tenant's job fails ONLY that job's future
            (isolation); everything else — and every single-graph run —
            keeps the fail-the-run contract.  ``error`` stays reserved
            for infrastructure-fatal conditions."""
            j = job_of(tid)
            if j is not None:
                fail_job(j, exc)
            else:
                error.append(exc)

        def publish_cached(d: int) -> Optional[serde.Handle]:
            """Encode a driver-cached value for shipping; a value that
            cannot be serialized is a task error, not a worker death."""
            try:
                h = serde.encode(store.cache[d], transport=transport,
                                 threshold=self.shm_threshold,
                                 namer=driver_namer)
            except Exception as e:      # noqa: BLE001 — surfaced on future
                node = graph.nodes.get(d)
                task_error(d, TaskFailed(
                    d, node.name if node else f"#{d}",
                    RuntimeError(f"SerializationError: result of task {d} "
                                 f"cannot be shipped to a worker: {e!r}")))
                return None
            store.set_handle(d, h)
            if runlog is not None and serde.is_durable(h):
                runlog.append("hnd", d, pickle.dumps(h, protocol=5))
            return h

        def build_extra(cid: int, wid: int
                        ) -> Tuple[Optional[Dict[int, Any]], Set[int]]:
            """Transfer handles for every external input of super-task
            ``cid`` not already replicated on ``wid``; the missing set
            needs fetches first.  Returns (None, _) when a value failed to
            serialize (error set)."""
            extra: Dict[int, Any] = {}
            missing: Set[int] = set()
            for d in plan.ext_deps[cid]:
                if store.has_replica(d, wid):
                    continue                   # already local
                # a relayed value ships inline (driver transport): its
                # direct handle already failed a consumer's full retry run
                h = relay_handles.get(d) or store.handles.get(d)
                if h is None and d in store.cache:
                    h = publish_cached(d)
                    if h is None:
                        return None, missing
                if h is not None:
                    extra[d] = h
                else:
                    missing.add(d)
            return extra, missing

        def move_cost(cid: int, wid: int) -> int:
            """Bytes-weighted cost of running super-task ``cid`` on
            ``wid``.  A published value costs half (one consumer-side
            materialization); an unpublished remote value costs its full
            size (publish + materialize) — and every byte whose nearest
            copy lives on another *host* counts double, so both the
            stealing loop and the speculation twin pick prefer same-host
            shm moves over cross-host TCP pulls."""
            host = workers[wid].host
            cost = 0
            for d in plan.ext_deps[cid]:
                if store.has_replica(d, wid):
                    continue
                size = store.sizes.get(d, 0)
                if d in store.handles or d in store.cache:
                    c = size // 2
                else:
                    c = size
                if not store.on_host(d, host) and d not in store.cache:
                    c *= 2          # nearest copy is on another machine
                cost += c
            return cost

        def try_dispatch(cid: int, w: _Worker) -> bool:
            """Assign READY super-task ``cid`` to worker ``w``; ship
            handles or request publication of whatever remote inputs it
            needs.  Returns False when a recovery ran underneath (caller
            must re-snapshot the ready set)."""
            extra, missing = build_extra(cid, w.wid)
            if extra is None:
                return False                    # serialization task error
            if missing:
                # a "done" dep with no live owner and no durable copy is a
                # lost value the death handler didn't see (e.g. GC raced a
                # transfer): recover it through lineage like any other loss
                unreachable = {
                    d for d in missing
                    if d not in fetching and alive_owner(d) is None}
                if unreachable:
                    state[cid] = READY
                    recompute_lost(unreachable, unreachable, None)
                    return False
                state[cid] = WAITING
                waiting[cid] = (w.wid, missing)
                w.assigned.add(cid)
                for d in missing:
                    if d not in fetching:
                        ow = alive_owner(d)     # non-None: checked above
                        post(workers[ow], ("fetch", d))
                        fetching[d] = ow
                return True
            launch(cid, w, extra)
            return True

        def launch(cid: int, w: _Worker, extra: Dict[int, Any],
                   speculative: bool = False) -> None:
            """Queue the run message (flushed with the iteration's batch).
            If the worker dies before the flush lands, the death handler
            re-queues ``cid`` like any other in-flight loss."""
            state[cid] = INFLIGHT
            if resident:
                j = job_of(cid)
                if j is not None and j.first_dispatch is None:
                    j.first_dispatch = time.perf_counter()  # SLO: queue wait
            w.inflight.add(cid)
            runners.setdefault(cid, set()).add(w.wid)
            run_started.setdefault(cid, {})[w.wid] = time.perf_counter()
            if speculative:
                spec_twins.setdefault(cid, set()).add(w.wid)
                stats["n_speculative"] += 1
            post(w, ("run", cid, extra))
            stats["dispatched"] += 1
            for h in extra.values():
                account_transfer(h)

        def finish_waiting(cid: int) -> None:
            """All transfers for a WAITING super-task arrived — launch."""
            wid, _ = waiting.pop(cid)
            w = workers[wid]
            w.assigned.discard(cid)
            if not w.alive:
                state[cid] = READY
                return
            extra, missing = build_extra(cid, wid)
            if extra is None:
                return                  # serialization task error
            if missing:                 # a handle vanished under us (GC /
                state[cid] = READY      # racing recovery): re-dispatch
                return
            launch(cid, w, extra)

        def stealable(cid: int) -> bool:
            """A super-task may run off-plan only when its planned home
            cannot take it now (dead, or pipeline full) — stealing exists
            for stragglers, not for letting the first worker vacuum the
            whole ready set before its peers get a dispatch turn."""
            ow = plan_worker.get(cid)
            if ow is None or ow not in workers:
                return True
            home = workers[ow]
            return not dispatchable(home) \
                or home.load() >= self.pipeline_depth

        def dispatchable(w: _Worker) -> bool:
            """No NEW work for a worker under suspicion (its channel is
            silent — a dispatch would just park behind the partition) or in
            quarantine (it drains existing work while being probed)."""
            return (w.alive and w.wid not in suspects
                    and w.wid not in quarantined)

        def dispatch() -> None:
            ready = [c for c, s in state.items() if s == READY]
            if not ready:
                return
            if resident and len(jobs) > 1:
                # multi-tenant fairness tier: deficit-weighted round-robin
                # across tenants BEFORE the locality/stealing loop below,
                # so one tenant's wide high-rank graph cannot starve
                # another's short interactive job out of dispatch slots
                ready = fair_interleave(
                    ready,
                    lambda c: (job_of(c).tenant
                               if job_of(c) is not None else ""),
                    key=lambda c: (-rank[c], c),
                    weights=self._tenant_weights or None)
            else:
                ready.sort(key=lambda c: (-rank[c], c))
            for w in list(workers.values()):
                if not dispatchable(w):
                    continue
                while w.load() < self.pipeline_depth and ready:
                    # locality-aware choice: among this worker's planned
                    # tasks (or, stealing, the stealable ready window) run
                    # the one needing the fewest remote input bytes
                    window = ready[:32]
                    planned = [c for c in window
                               if plan_worker.get(c, w.wid) == w.wid]
                    pool = planned or [c for c in window if stealable(c)]
                    if not pool:
                        break       # everything here belongs to live peers
                    mine = min(pool, key=lambda c: (move_cost(c, w.wid),
                                                    -rank[c], c))
                    if not planned:
                        stats["steals"] += 1   # off-plan work
                    ready.remove(mine)
                    if state.get(mine) != READY:
                        continue    # demoted since the snapshot
                    if not try_dispatch(mine, w):
                        return      # recovery invalidated the snapshot

        def maybe_gc(tid: int) -> None:
            # a resident run GCs like outputs_only: every job's required
            # values sit in graph.outputs (collection-protected), so only
            # true intermediates of outputs_only jobs ever drain to zero
            if not (self.outputs_only or resident) \
                    or not store.collectable(tid):
                return
            for wid in list(store.locations(tid)):
                if wid in workers and workers[wid].alive:
                    post(workers[wid], ("drop", [tid]))
            store.invalidate({tid})     # also unlinks its shm segments
            store.mark_dropped(tid)     # late duplicate publishes: sweep
            relay_handles.pop(tid, None)
            stats["dropped"] += 1
            if runlog is not None:
                runlog.append("gc", [tid])

        def runner_gone(cid: int, wid: int) -> Optional[float]:
            """Bookkeeping when ``wid`` stops running ``cid`` (done,
            cancelled, deplost, or death).  Returns its dispatch time."""
            rs = runners.get(cid)
            if rs is not None:
                rs.discard(wid)
                if not rs:
                    runners.pop(cid, None)
            starts = run_started.get(cid)
            st = starts.pop(wid, None) if starts else None
            if starts is not None and not starts:
                run_started.pop(cid, None)
            return st

        def still_running(cid: int) -> bool:
            """True while a live worker is (believed to be) executing
            ``cid`` — dead runners were already discarded by their death
            handler, but guard against re-entrancy mid-handling."""
            return any(x in workers and workers[x].alive
                       for x in runners.get(cid, ()))

        def on_done(w: _Worker, cid: int, wall: float,
                    sizes: Dict[int, int],
                    replicated: Sequence[int]) -> None:
            nonlocal last_progress
            last_progress = time.perf_counter()
            w.inflight.discard(cid)
            runner_gone(cid, w.wid)
            j = job_of(cid)
            if j is not None and j.terminal:
                # the job was already collected/failed and its id range
                # retired: whatever this late run materialized is residue
                # to sweep on the worker, never tracking to resurrect
                sweep = list(sizes) + list(replicated)
                if sweep and w.alive:
                    post(w, ("drop", sweep))
                return
            if state.get(cid) == DONE:
                # late duplicate: a speculation loser that kept executing
                # after the winner, or a replay raced by recovery.  Purity
                # makes the values identical, so each publish (the kept
                # members AND the transfer inputs the loser materialized)
                # either reconciles as a legitimate extra replica or —
                # when the GC already swept that value — is swept on this
                # worker too (it must not hold a value the driver thinks
                # is gone everywhere)
                sweep: List[int] = []
                swept_result = False
                for m in sizes:
                    if store.was_dropped(m):
                        sweep.append(m)
                        swept_result = True
                    else:
                        store.record_replica(m, w.wid)
                if swept_result:
                    stats["speculative_swept"] += 1
                for d in replicated:
                    if state.get(plan.cluster_of[d]) != DONE:
                        continue
                    if store.was_dropped(d):
                        sweep.append(d)
                    else:
                        store.record_replica(d, w.wid)
                if sweep and w.alive:
                    post(w, ("drop", sweep))
                stats["speculative_wasted_s"] += wall
                return
            # record transfer replicas first, so GC drops reach them too;
            # skip deps a racing recovery has invalidated (stale-but-pure
            # copies are harmless, but must not resurrect tracking state)
            for d in replicated:
                if state.get(plan.cluster_of[d]) == DONE:
                    store.record_replica(d, w.wid)
            state[cid] = DONE
            done.add(cid)
            finish_times[cid] = time.perf_counter() - t0
            if not stats["first_done_s"]:
                stats["first_done_s"] = finish_times[cid]
            stats["last_done_s"] = finish_times[cid]
            for m, nb in sizes.items():
                store.record(m, w.wid, nb)
            if runlog is not None:
                # one delta record per completion — the incremental
                # checkpoint: O(cluster outputs), not O(workers) or O(graph)
                runlog.append("done", cid, w.wid, dict(sizes))
                # BARRIER values are the paper's lineage cut: pull them to
                # the driver so the log holds a durable copy even if every
                # replica dies with the outage
                for m in sizes:
                    if graph.nodes[m].kind is TaskKind.BARRIER \
                            and m not in fetching and not store.durable(m):
                        post(w, ("fetch", m))
                        fetching[m] = w.wid
            w.n_done += 1
            # runtime calibration of the static cost model (the launchers'
            # 0.9/0.1 straggler EWMA): seconds of wall per planned cost
            # unit, plus per-fn rates and the replayable run trace
            members = plan.members.get(cid, (cid,))
            cost_model.observe(
                planned_dur.get(cid, 1.0), wall,
                fn_units=[(fn_key(graph.nodes[m]), graph.nodes[m].cost)
                          for m in members if m in graph.nodes])
            trace.record(members, graph.nodes, wall)
            stats["cost_unit_s"] = cost_model.unit_s or 0.0
            maybe_refuse()
            # winner election: this completion wins; every other runner of
            # cid gets an idempotent cancel (honored between tasks — one
            # mid-task keeps going and late-dones into the branch above)
            if cid in spec_twins:
                if w.wid in spec_twins[cid]:
                    stats["speculative_wins"] += 1
                spec_twins.pop(cid, None)
            for owid in sorted(runners.get(cid, ())):
                ow = workers.get(owid)
                if ow is not None and ow.alive:
                    post(ow, ("cancel", cid))
            for d in plan.ext_deps[cid]:
                store.consumed(d)
                maybe_gc(d)
            for s in csucc[cid]:
                if state[s] == PENDING and \
                        all(state[d] == DONE for d in cg.nodes[s].all_deps):
                    state[s] = READY
            if self.fail_worker and w.wid == self.fail_worker[0] \
                    and w.n_done >= self.fail_worker[1] and w.alive:
                kill(w)
            nonlocal join_after
            if join_after and len(done) >= join_after[0]:
                n_new, join_after = join_after[1], None
                for _ in range(n_new):
                    join_one()

        def kill(w: _Worker) -> None:
            """SIGKILL + immediate failure handling (used by injection and
            the kill_worker command; organic deaths arrive via the
            channel).  A remote worker has no local pid to signal, so it
            is told to ``die`` — the executioner's message, then the same
            death handling."""
            if w.proc is not None:
                try:
                    os.kill(w.proc.pid, signal.SIGKILL)
                    w.proc.join(timeout=5.0)
                except (ProcessLookupError, OSError):
                    pass
            else:
                try:
                    w.chan.send(("die",))
                except ChannelClosed:
                    pass
            on_worker_death(w)

        def join_one(adopted: Optional[_Worker] = None) -> _Worker:
            w = adopted if adopted is not None else spawn()
            stats["joins"] += 1
            make_plan(initial=False)
            return w

        def recompute_lost(needed: Set[int], lost: Set[int],
                           cause: Any) -> None:
            """Lineage recovery at super-task granularity: re-run the
            minimal set of *clusters* that rebuilds the ``needed`` lost
            values, then replan onto the live workers."""
            available = store.available(set(alive_ids()))
            cplan = recovery_plan_clusters(plan, needed, available)
            stats["recomputed"] += len(cplan)
            for c in cplan:
                j = job_of(c)
                if j is not None:
                    j.recomputed += 1
            self.recovery_events.append({
                "worker": cause, "lost": set(lost), "needed": set(needed),
                "available": set(available), "plan": set(cplan),
            })
            if runlog is not None and cplan:
                # retract the frontier claims (and any GC marks) the
                # re-runs invalidate, so a later resume sees them as open
                runlog.append("redo", sorted(cplan))
                runlog.append("live", sorted(
                    v for c in cplan for v in plan.members[c]))

            will_run = cplan | {c for c, s in state.items()
                                if s not in (DONE, CANCELLED)}
            vals = {v for c in cplan for v in plan.members[c]}
            store.invalidate(vals)
            for v in vals:      # a recomputed value gets a fresh handle
                relay_handles.pop(v, None)
            store.reset_consumers(cplan, will_run)
            for c in cplan:
                done.discard(c)
                finish_times.pop(c, None)
                # a recomputed incarnation starts fresh: old twin identity
                # must not misattribute its completion as a speculative win
                spec_twins.pop(c, None)
            # WAITING super-tasks elsewhere may block on a lost value:
            # reset them
            for cid in list(waiting):
                wid, need = waiting[cid]
                if need & vals:
                    waiting.pop(cid)
                    workers[wid].assigned.discard(cid)
                    state[cid] = READY
            for c in cplan:
                state[c] = (READY if all(state[d] == DONE
                                         for d in cg.nodes[c].all_deps)
                            else PENDING)
            # demote READY super-tasks whose deps just un-completed
            for cid, s in list(state.items()):
                if s == READY and any(state[d] != DONE
                                      for d in cg.nodes[cid].all_deps):
                    state[cid] = PENDING

            if not alive_ids():
                error.append(RuntimeError(
                    "cluster lost every worker; cannot recover"))
                return
            make_plan(initial=False)       # replan onto the survivors

        def on_worker_death(w: _Worker) -> None:
            nonlocal last_progress
            if not w.alive:
                return
            last_progress = time.perf_counter()
            w.alive = False
            w.chan.close()
            w.outbox.clear()
            suspects.pop(w.wid, None)
            flake_score.pop(w.wid, None)
            quarantined.pop(w.wid, None)
            stats["failures"] += 1
            if runlog is not None:
                runlog.append("dead", w.wid)

            # super-tasks that never completed there simply go back in the
            # pool — with two speculation exceptions: a SIGKILL of the
            # original while a twin still runs must NOT re-queue (the
            # survivor owns the task; re-queueing would be a double
            # recovery), and a loser that died while running an
            # already-DONE task is just wasted work, accounted, forgotten
            death_t = time.perf_counter()
            for cid in list(w.inflight):
                st = runner_gone(cid, w.wid)
                if state.get(cid) in (DONE, CANCELLED):
                    if st is not None:
                        stats["speculative_wasted_s"] += death_t - st
                    continue
                if still_running(cid):
                    continue            # a live twin/original has it
                state[cid] = READY
            w.inflight.clear()
            for cid in list(w.assigned):
                waiting.pop(cid, None)
                if state.get(cid) != CANCELLED:
                    state[cid] = READY
            w.assigned.clear()

            # values whose LAST copy lived in its store are lost -> lineage
            # (replicas / shm-published handles / driver cache survive)
            lost = store.drop_worker(w.wid)
            # fetches sent to the dead worker never reply: re-aim them at a
            # surviving replica, or let the recovery below reset the waiters
            for d, target in list(fetching.items()):
                if target != w.wid:
                    continue
                fetching.pop(d, None)
                if d in lost:
                    continue               # recovery resets its waiters
                ow = alive_owner(d)
                if ow is not None:
                    post(workers[ow], ("fetch", d))
                    fetching[d] = ow
            if self.outputs_only or resident:
                needed = {t for t in lost
                          if t in graph.outputs
                          or store.consumers_left.get(t, 0) > 0}
            else:
                needed = set(lost)
            recompute_lost(needed, lost, w.wid)

        def on_value(w: _Worker, tid: int, found: bool, handle: Any) -> None:
            nonlocal last_progress
            last_progress = time.perf_counter()
            fetching.pop(tid, None)
            j = job_of(tid)
            if j is not None and j.terminal:
                if found:       # retired value: free the stale segments
                    serde.release(handle)
                return
            owner_done = state.get(plan.cluster_of[tid]) == DONE
            if not found:
                # owner dropped/lost it between request and reply; try a
                # surviving replica, else recover like a partial failure
                if owner_done and not store.durable(tid):
                    ow = alive_owner(tid)
                    if ow is not None:
                        post(workers[ow], ("fetch", tid))
                        fetching[tid] = ow
                        return
                    store.invalidate({tid})
                    recompute_lost({tid}, {tid}, None)
                return
            if not owner_done:
                # a recovery invalidated tid while this reply was in flight:
                # the recompute supersedes it; free the stale segments
                serde.release(handle)
                return
            account_pipe(handle)
            store.set_handle(tid, handle)
            if runlog is not None:
                if serde.is_durable(handle):
                    # tmpfs/inline handles survive a driver death in place:
                    # the log only needs the pointer
                    runlog.append("hnd", tid,
                                  pickle.dumps(handle, protocol=5))
                elif graph.nodes[tid].kind is TaskKind.BARRIER:
                    # barrier value behind a worker-lifetime handle: spill
                    # the bytes themselves — the lineage cut must hold even
                    # if the whole pool dies with the driver
                    try:
                        runlog.append("val", tid, pickle.dumps(
                            serde.resolve(handle), protocol=5))
                    except Exception:       # noqa: BLE001 — best-effort
                        pass
            for c in list(waiting):
                entry = waiting.get(c)
                if entry is None:     # popped by a recovery mid-loop
                    continue
                _, need = entry
                need.discard(tid)
                if not need:
                    finish_waiting(c)

        def on_deplost(w: _Worker, cid: int, deps: Sequence[int]) -> None:
            """A dispatched super-task's input handles would not resolve
            (owner died mid-transfer / GC raced): re-queue the super-task
            and recover any input that is genuinely gone."""
            nonlocal last_progress
            last_progress = time.perf_counter()
            stats["deplosts"] += 1
            w.inflight.discard(cid)
            runner_gone(cid, w.wid)
            j = job_of(cid)
            if j is not None and j.terminal:
                return          # retired job: nothing to requeue/recover
            if state.get(cid) == DONE:
                # a speculation loser lost the race to the winner AND its
                # input handles to the winner-triggered GC sweep: nothing
                # is actually lost (a dep a live consumer still needs
                # surfaces through that consumer's own fetch/deplost)
                return
            if state.get(cid) == INFLIGHT and not still_running(cid):
                state[cid] = READY
            bad = {d for d in deps
                   if state.get(plan.cluster_of[d]) == DONE
                   and not store.durable(d)
                   and alive_owner(d) is None}
            # graceful degradation (docs/faults.md): a dep whose owner is
            # STILL ALIVE reached us because the worker's peer-fetch retries
            # exhausted (flaky data plane), not because the value is gone.
            # The driver resolves the handle itself and relays it inline on
            # the next dispatch — recompute stays reserved for real losses.
            for d in deps:
                if d in bad or d in relay_handles \
                        or state.get(plan.cluster_of[d]) != DONE:
                    continue
                if d in store.cache:
                    val = store.cache[d]
                else:
                    h = store.handles.get(d)
                    if h is None:
                        continue    # unpublished: re-dispatch re-fetches
                    try:
                        val = serde.resolve(h)
                    except serde.TransferLost:
                        if not store.durable(d) and alive_owner(d) is None:
                            bad.add(d)      # driver can't reach it either
                        continue
                    store.cache_value(d, val)
                try:
                    relay_handles[d] = serde.encode(
                        val, transport="driver",
                        threshold=self.shm_threshold)
                except Exception:   # noqa: BLE001 — unshippable inline:
                    continue        # leave the direct path in place
                stats["relay_fallbacks"] += 1
            if bad:
                store.invalidate(bad)
                recompute_lost(bad, bad, None)
            # inputs may themselves be mid-recompute (an earlier recovery):
            # wait for them instead of re-triggering loss detection
            if state.get(cid) == READY and any(
                    state.get(d) != DONE
                    for d in cg.nodes[cid].all_deps):
                state[cid] = PENDING

        def on_cancelled(w: _Worker, cid: int,
                         replicated: Sequence[int] = (),
                         wall: float = 0.0) -> None:
            """The worker honored a cancel mark on ``cid`` — either before
            starting (3-tuple ack) or cooperatively at a member boundary
            mid-super-task (extended ack, carrying the transfer inputs it
            had already materialized and the partial wall it burned).
            Normally the winner already completed (nothing to do); if the
            mark was stale — a lineage-recovery re-dispatch raced a cancel
            from a previous incarnation — the run was still wanted, so the
            super-task goes back in the pool."""
            nonlocal last_progress
            last_progress = time.perf_counter()
            w.inflight.discard(cid)
            runner_gone(cid, w.wid)
            j = job_of(cid)
            if j is not None and j.terminal:
                return      # cancelled-job ack: bookkeeping already gone
            # inputs an aborted run stored are real replicas (or, already
            # GC-swept, residue to sweep on this worker too) — same
            # reconciliation as a late duplicate done
            sweep: List[int] = []
            for d in replicated:
                if state.get(plan.cluster_of[d]) != DONE:
                    continue
                if store.was_dropped(d):
                    sweep.append(d)
                else:
                    store.record_replica(d, w.wid)
            if sweep and w.alive:
                post(w, ("drop", sweep))
            if state.get(cid) == DONE:
                # a mid-task abort of a speculation loser: the partial wall
                # is the true waste (the pre-abort fix charged the FULL
                # super-task duration, because the loser ran to completion)
                stats["speculative_wasted_s"] += wall
                return
            if state.get(cid) == INFLIGHT and not still_running(cid):
                state[cid] = READY

        def effective_speculate_after() -> Optional[float]:
            """Static ``speculate_after`` always wins; under adaptive
            mode an unset threshold is derived from the observed duration
            variance (docs/adaptive.md) — tight when durations are
            predictable, loose when natural spread is high."""
            if self.speculate_after is not None:
                return self.speculate_after
            if self.adaptive == "off":
                return None
            d = cost_model.derived_speculate_after()
            if d is not None:
                stats["adaptive_speculate_after"] = d
            return d

        def maybe_refuse() -> None:
            """Mid-run re-fusion (docs/adaptive.md): when measured
            durations are skewed enough that the static plan's grouping
            is evidently mis-costed, regroup the not-yet-dispatched
            frontier under profile-corrected costs.  Completed and
            in-flight clusters are pinned (they are simply not in the
            frontier); the decision is journaled so a resumed driver
            replays it bit-identically.  Disabled for resident (gateway)
            runs — job id spans pin cluster ids — and after any
            recovery: a post-outage run values plan stability over
            regrouping."""
            nonlocal n_total, rank, csucc
            if (self.adaptive == "off" or resident or plan.identity
                    or error or self.recovery_events
                    or stats["recomputed"]):
                return
            cost_model.observe_dispatch(
                stats["dispatch_overhead_s"], stats["dispatched"])
            stats["dispatch_cost_s"] = cost_model.dispatch_s
            frontier = [c for c, s in state.items()
                        if s in (PENDING, READY)]
            if not refusion_due(cost_model, governor, len(frontier)):
                return
            stats["adaptive_skew"] = governor.last_skew
            gates = cost_model.fuse_gates(DEFAULT_FANIN_COST,
                                          DEFAULT_GROUP_COST)
            kp_live = self.keep_parallelism or max(
                DEFAULT_KEEP_PARALLELISM, 2 * len(alive_ids()))
            res = refuse_frontier(
                plan, frontier, spec=self.fuse,
                cost_of=cost_model.corrected_units,
                fanin_cost=gates[0], group_cost=gates[1],
                keep_parallelism=kp_live)
            if res is None:
                governor.note_no_change(cost_model)
                return
            retired, new_clusters = res
            delta = splice_plan(plan, retired, new_clusters)
            # store refcounts follow the consumer-set delta (frontier
            # consumers never ran, so no completed decrement is disturbed
            # and no count can reach zero here)
            for v, d in delta.items():
                store.consumers_left[v] = \
                    store.consumers_left.get(v, 0) + d
            for c in retired:
                state.pop(c, None)
                planned_dur.pop(c, None)
                plan_worker.pop(c, None)
                fusion_view.members.pop(c, None)
                fusion_view.keep.pop(c, None)
            # new_clusters is topo-ordered, so a new cluster's new-cluster
            # deps are already in ``state`` when it is seeded
            view_delta: Dict[str, Dict] = {"members": {}, "keep": {}}
            for cid, ms in new_clusters:
                node = cg.nodes[cid]
                state[cid] = (READY if all(state[d] == DONE
                                           for d in node.all_deps)
                              else PENDING)
                planned_dur[cid] = max(node.cost, 1e-6)
                # keep rule mirrors FusedPlan.worker_view
                keep = tuple(m for m in ms
                             if m in required or m in plan._outset[cid])
                fusion_view.members[cid] = tuple(ms)
                fusion_view.keep[cid] = keep
                view_delta["members"][cid] = tuple(ms)
                view_delta["keep"][cid] = keep
            n_total += len(new_clusters) - len(retired)
            rank = cg.critical_path_rank()
            csucc = cg.successors()
            # live workers learn the new memberships before any dispatch
            # of a new cid can reach them (same FIFO outbox); retired ids
            # are never dispatched again, so their stale entries on the
            # worker are inert.  Late joiners get the mutated fusion_view
            # in their welcome config.
            blob = pickle.dumps(view_delta,
                                protocol=pickle.HIGHEST_PROTOCOL)
            for lw in workers.values():
                if lw.alive:
                    post(lw, ("graph", blob))
            if runlog is not None:
                runlog.append("refuse", tuple(retired),
                              tuple((cid, tuple(ms))
                                    for cid, ms in new_clusters))
            governor.note_fired(cost_model)
            stats["refusions"] += 1
            stats["n_clusters"] = len(cg.nodes)
            stats["tasks_fused"] = plan.n_fused
            make_plan(initial=False)

        def maybe_speculate() -> None:
            """Speculative re-execution of stragglers: duplicate the
            most-overdue running super-task onto an idle worker.  Runs
            only when no READY work exists anywhere (twins never displace
            first executions) and only after the first completion
            calibrated the cost model into seconds.  The *pick* is
            :func:`repro_torch.core.simulator.pick_speculation` — the
            simulator's policy, verbatim; the *placement* is
            locality-aware: among idle workers, the twin runs where its
            input bytes are cheapest (``move_cost`` doubles bytes whose
            nearest copy is on another host, so an idle same-host worker
            beats a cross-host one)."""
            spec_after = effective_speculate_after()
            if spec_after is None or cost_model.unit_s is None:
                return
            if any(s == READY for s in state.values()):
                return
            idle = [w for w in workers.values()
                    if dispatchable(w) and w.load() == 0]
            if not idle:
                return
            now = time.perf_counter()
            overdue_view: Dict[int, Tuple[float, float]] = {}
            for cid, wids in runners.items():
                if state.get(cid) != INFLIGHT or len(wids) != 1:
                    continue                # done, or already twinned
                (rw,) = tuple(wids)
                st = run_started.get(cid, {}).get(rw)
                if st is None:
                    continue
                expected = planned_dur.get(cid, 1.0) * cost_model.unit_s
                overdue_view[cid] = (now - st, max(expected, 1e-9))
            while idle and overdue_view:
                cid = pick_speculation(overdue_view, spec_after)
                if cid is None:
                    return
                elapsed, _ = overdue_view.pop(cid)
                w = min(idle, key=lambda iw: (move_cost(cid, iw.wid),
                                              iw.wid))
                extra, missing = build_extra(cid, w.wid)
                if extra is None:
                    return              # serialization error surfaced
                if missing:
                    continue            # inputs not shippable now; a
                    # twin is opportunistic — never fetch-block for one
                primary = next(iter(runners.get(cid, {-1})))
                self.speculation_events.append(
                    {"tid": cid, "primary": primary, "twin": w.wid,
                     "t": now - t0, "elapsed": elapsed})
                launch(cid, w, extra, speculative=True)
                idle.remove(w)

        def handle_msg(w: _Worker, msg: tuple) -> None:
            verb = msg[0]
            if verb == "done":
                j = job_of(msg[2])
                mine = j is not None and not j.terminal
                for k, n in msg[6].items():
                    launched[k] = launched.get(k, 0) + n
                    if mine:
                        j.kernel_launches[k] = j.kernel_launches.get(k, 0) + n
                for m in plan.members.get(msg[2], ()):
                    node = graph.nodes.get(m)
                    if node is not None:
                        ran[node.name] = ran.get(node.name, 0) + 1
                        if mine:
                            j.tasks_run[node.name] = \
                                j.tasks_run.get(node.name, 0) + 1
                on_done(w, msg[2], msg[3], msg[4], msg[5])
            elif verb == "value":
                on_value(w, msg[2], msg[3], msg[4])
            elif verb == "value_many":
                for tid, found, handle in msg[2]:
                    if not w.alive:
                        break   # death handler ran under an earlier entry
                    on_value(w, tid, found, handle)
            elif verb == "deplost":
                on_deplost(w, msg[2], msg[3])
            elif verb == "cancelled":
                # 3-tuple: skipped while queued; 5-tuple: aborted at a
                # member boundary mid-run (replicated inputs + partial wall)
                on_cancelled(w, msg[2], *(msg[3:5] if len(msg) > 3 else ()))
            elif verb == "fetch_error":
                # a fetch reply that could not be serialized names a VALUE
                # tid, not a super-task: the value cannot be collected, so
                # the run fails — but no cluster bookkeeping may run on an
                # id from the wrong namespace
                tid = msg[2]
                fetching.pop(tid, None)
                node = graph.nodes.get(tid)
                task_error(tid, TaskFailed(
                    tid, node.name if node else f"#{tid}",
                    RuntimeError(f"{msg[3]}: {msg[4]}")))
            elif verb == "error":
                cid = msg[2]
                w.inflight.discard(cid)
                was_runner = w.wid in runners.get(cid, ())
                runner_gone(cid, w.wid)
                j = job_of(cid)
                if msg[3] == "MissingInput":
                    # caller-error contract: never wrapped in TaskFailed.
                    # A job's message carries its namespaced placeholder
                    # ("j3/x"): report it in the submitter's vocabulary
                    if j is not None:
                        fail_job(j, MissingInput(
                            msg[4].replace(f"j{j.job_id}/", "")))
                    else:
                        error.append(MissingInput(msg[4]))
                elif state.get(cid) in (DONE, CANCELLED) and was_runner:
                    # a speculation loser failing AFTER the winner (e.g.
                    # its inputs were GC-swept under the race) must not
                    # abort a run whose result already exists.  Only
                    # *execution* duplicates reach here — fetch-reply
                    # failures arrive as fetch_error and stay fatal
                    pass
                else:
                    node = cg.nodes.get(cid)
                    task_error(cid, TaskFailed(
                        cid, node.name if node else f"#{cid}",
                        RuntimeError(f"{msg[3]}: {msg[4]}")))
            elif verb in ("hb", "bye"):
                pass        # liveness bookkeeping happens in the channel

        def pump(timeout: float) -> None:
            flush_all()     # batched sends hit the wire before we sleep
            chans = {w.chan.selectable(): w
                     for w in workers.values() if w.alive}
            if not chans:
                return
            drained: Set[int] = set()
            for sel in conn_wait(list(chans), timeout=timeout):
                w = chans[sel]
                drained.add(w.wid)
                try:
                    msgs = w.chan.recv_available()
                except ChannelClosed:
                    on_worker_death(w)
                    continue
                stats["control_msgs"] += len(msgs)
                for msg in msgs:
                    if not w.alive:
                        break       # death handler ran under an earlier msg
                    handle_msg(w, msg)
            # a fault wrapper may hold parked frames whose release time
            # passed with NO new wire bytes — conn_wait never reports those
            # channels readable, so drain them explicitly
            for w in list(workers.values()):
                if not w.alive or w.wid in drained:
                    continue
                if not getattr(w.chan, "has_ready", lambda: False)():
                    continue
                msgs = w.chan.drain_ready()
                stats["control_msgs"] += len(msgs)
                for msg in msgs:
                    if not w.alive:
                        break
                    handle_msg(w, msg)

        def collect_values(req: Set[int]) -> bool:
            """Materialize ``req`` values into the driver cache — decoding
            published handles directly (no control traffic), fetching
            handles for the rest.  Returns True when everything in ``req``
            is cached.  Used for a single-graph run's finals AND for each
            resident-mode job's independent gather."""
            nonlocal last_progress
            missing = [t for t in req if t not in store.cache]
            if not missing:
                return True
            # one bulk fetch per owner: the per-value fetch/value ping-pong
            # collapses into a fetch_many/value_many round-trip per worker
            by_owner: Dict[int, List[int]] = {}
            for t in missing:
                h = store.handles.get(t)
                if h is not None:
                    try:
                        value = serde.resolve(h)
                    except serde.TransferLost:
                        store.invalidate({t})
                        recompute_lost({t}, {t}, None)
                        return False
                    store.cache_value(t, value)
                    d = serde.direct_nbytes(h)
                    if d > 0:
                        stats["bytes_direct"] += d
                        stats["bytes_moved"] += d
                        stats["transfers_direct"] += 1
                    last_progress = time.perf_counter()
                    continue
                if t in fetching:
                    continue
                ow = alive_owner(t)
                if ow is None:
                    store.invalidate({t})
                    recompute_lost({t}, {t}, None)
                    return False
                by_owner.setdefault(ow, []).append(t)
                fetching[t] = ow
            for ow, tids in by_owner.items():
                post(workers[ow], ("fetch_many", tids))
            return not [t for t in req if t not in store.cache]

        def collect_finals() -> bool:
            return collect_values(required)

        # ------------------------------------------------ resident-mode jobs
        def admit_job(job: _Job) -> None:
            """Splice an offset job into the live union run: graph nodes,
            plan maps, fusion view, refcount universe, scheduler state —
            then fan the delta out to every adopted worker (the outbox is
            FIFO, so the delta lands before any run that needs it; later
            joiners receive the merged graph in their welcome/fork)."""
            nonlocal n_total
            jp = job.plan
            jview = jp.worker_view(job.required)
            try:
                delta = pickle.dumps(
                    {"nodes": jp.graph.nodes, "inputs": job.inputs,
                     "members": jview.members, "keep": jview.keep},
                    protocol=5)
            except Exception as e:      # noqa: BLE001 — job-fatal only
                job.terminal = True
                job.future._set_error(ValueError(
                    "job graph is not picklable, so it cannot be shipped "
                    "to the pool's workers (use module-level task "
                    f"functions): {e!r}"))
                return
            graph.nodes.update(jp.graph.nodes)
            # required values are collection-protected from the GC the
            # same way a single-graph run protects its outputs
            graph.outputs.extend(sorted(job.required))
            inputs.update(job.inputs)
            cg.nodes.update(jp.cgraph.nodes)
            plan.members.update(jp.members)
            plan.cluster_of.update(jp.cluster_of)
            plan.outputs.update(jp.outputs)
            plan.ext_deps.update(jp.ext_deps)
            plan.consumers.update(jp.consumers)
            plan._outset.update(
                {c: set(vs) for c, vs in jp.outputs.items()})
            fusion_view.members.update(jview.members)
            fusion_view.keep.update(jview.keep)
            store.admit(jp.graph.nodes)
            rank.update(jp.cgraph.critical_path_rank())
            csucc.update(jp.cgraph.successors())
            for cid, node in jp.cgraph.nodes.items():
                state[cid] = READY if not node.all_deps else PENDING
                planned_dur[cid] = max(node.cost, 1e-6)
            n_total += len(jp.cgraph.nodes)
            stats["n_clusters"] += len(jp.cgraph.nodes)
            stats["tasks_fused"] += jp.n_fused
            stats["jobs_admitted"] += 1
            jobs[job.job_id] = job
            # two submitters can queue their jobs in the other order than
            # they took their id ranges: keep the span index sorted
            i = bisect.bisect_left(span_starts, job.base)
            job_spans.insert(i, (job.base, job.end, job))
            span_starts.insert(i, job.base)
            graph_blob[0] = None    # graph-less dialers need the union
            for w in workers.values():
                if w.alive:
                    post(w, ("graph", delta))
            if runlog is not None:
                runlog.append("job", job.job_id, {
                    "tenant": job.tenant, "base": job.base,
                    "end": job.end, "n_clusters": len(job.cids)})
            make_plan(initial=False)

        def retire_job(job: _Job) -> None:
            """Forget a finished/failed job everywhere, so a long-lived
            resident run's state does not grow with every job ever
            admitted.  Tombstones stay in ``state``/``plan.cluster_of``
            and the span index (small ints), so late worker messages
            about retired ids stay identifiable and inert."""
            jobs.pop(job.job_id, None)
            span = range(job.base, job.end)
            store.retire(span)
            for t in span:
                graph.nodes.pop(t, None)
                cg.nodes.pop(t, None)
                plan.members.pop(t, None)
                plan.outputs.pop(t, None)
                plan.ext_deps.pop(t, None)
                plan.consumers.pop(t, None)
                plan._outset.pop(t, None)
                fusion_view.members.pop(t, None)
                fusion_view.keep.pop(t, None)
                rank.pop(t, None)
                csucc.pop(t, None)
                planned_dur.pop(t, None)
                finish_times.pop(t, None)
                plan_worker.pop(t, None)
                done.discard(t)
                fetching.pop(t, None)
                relay_handles.pop(t, None)
                spec_twins.pop(t, None)
                entry = waiting.pop(t, None)
                if entry is not None:
                    ow = workers.get(entry[0])
                    if ow is not None:
                        ow.assigned.discard(t)
            graph.outputs = [o for o in graph.outputs
                             if not (job.base <= o < job.end)]
            for name in job.inputs:
                inputs.pop(name, None)
            graph_blob[0] = None
            delta = pickle.dumps(
                {"retire": tuple(span),
                 "retire_inputs": tuple(job.inputs)}, protocol=5)
            for w in workers.values():
                if w.alive:
                    post(w, ("graph", delta))

        def finish_job(job: _Job) -> None:
            """Every cluster of ``job`` is DONE and its required values
            are cached: resolve the future (keys in the SUBMITTER's id
            space), journal, and retire the id range."""
            job.terminal = True
            now = time.perf_counter()
            if job.coll_map is None:
                results = {t: store.cache[t + job.base]
                           for t in job.user_required}
            else:
                results = {t: store.cache[job.coll_map[t]]
                           for t in job.user_required}
            latency = now - job.submitted
            first = (job.first_dispatch - job.submitted
                     if job.first_dispatch is not None else latency)
            stats["jobs_completed"] += 1
            if runlog is not None:
                runlog.append("jobdone", job.job_id)
            job.future._set_result(
                results, wall_time=latency,
                stats={"tenant": job.tenant, "job_id": job.job_id,
                       "n_clusters": len(job.cids),
                       "submit_to_first_dispatch_s": first,
                       "submit_to_gather_s": latency,
                       "kernel_launches": dict(job.kernel_launches),
                       "tasks_run": dict(job.tasks_run),
                       "recomputed": job.recomputed,
                       # adaptive observability: the run-wide calibrated
                       # rates this job executed under (re-fusion itself
                       # is disabled for resident runs)
                       "cost_unit_s": cost_model.unit_s or 0.0,
                       "dispatch_cost_s": cost_model.dispatch_s,
                       "adaptive_speculate_after":
                           stats["adaptive_speculate_after"]})
            retire_job(job)

        def fail_job(job: _Job, exc: BaseException) -> None:
            """Tenant isolation: one job's task failure (or cancellation)
            fails ONLY that job's future.  Its unfinished clusters become
            CANCELLED (terminal — dispatch skips them, recovery never
            resurrects them), in-flight runs get idempotent cancel marks,
            and the id range is retired.  Every other tenant's work is
            untouched; ``error`` stays reserved for infrastructure-fatal
            conditions (pool lost, progress timeout)."""
            if job.terminal:
                return
            job.terminal = True
            stats["jobs_failed"] += 1
            for cid in job.cids:
                s = state.get(cid)
                if s == DONE:
                    continue
                state[cid] = CANCELLED
                if s == INFLIGHT:
                    for owid in sorted(runners.get(cid, ())):
                        ow = workers.get(owid)
                        if ow is not None and ow.alive:
                            post(ow, ("cancel", cid))
                elif s == WAITING:
                    entry = waiting.pop(cid, None)
                    if entry is not None:
                        ow = workers.get(entry[0])
                        if ow is not None:
                            ow.assigned.discard(cid)
            if runlog is not None:
                runlog.append("jobdone", job.job_id)
            job.future._set_error(exc)
            retire_job(job)

        def service_jobs() -> None:
            """Resident-mode completion scan: collect and resolve every
            job whose clusters are all DONE.  Each job gathers
            independently — one tenant's transfer stall never blocks
            another tenant's result."""
            for job in list(jobs.values()):
                if job.terminal or error:
                    continue
                if all(state.get(c) == DONE for c in job.cids):
                    if collect_values(job.required):
                        finish_job(job)

        def check_commands() -> None:
            with self._cmd_lock:
                cmds, self._commands = self._commands, []
            for cmd in cmds:
                if cmd[0] == "join":
                    join_one()
                elif cmd[0] == "kill" and cmd[1] in workers \
                        and workers[cmd[1]].alive:
                    kill(workers[cmd[1]])
                elif cmd[0] == "job":
                    if resident:
                        admit_job(cmd[1])
                    else:
                        cmd[1].future._set_error(RuntimeError(
                            "job submission requires a resident "
                            "executor (start_resident())"))
                elif cmd[0] == "canceljob" and resident:
                    cj = jobs.get(cmd[1])
                    if cj is not None:
                        fail_job(cj, cmd[2])
                elif cmd[0] == "logrec":
                    if runlog is not None:
                        runlog.append(*cmd[1])
            # a repro-worker dialing a live TCP run is an elastic join —
            # including dials parked in the stash while adopt_dialer_for
            # was pid-matching a local spawn (they would otherwise hang
            # unanswered until their handshake timeout)
            if listener is not None:
                while True:
                    pair = dial_stash.pop(0) if dial_stash \
                        else listener.poll_worker()
                    if pair is None:
                        break
                    if pair[1].get("rejoin") is not None:
                        # a surviving worker re-dialing after a driver
                        # socket drop (outage, partition heal): re-adopt
                        # in place, never as a fresh join
                        if adopt_rejoin(pair[0], pair[1]) is not None:
                            make_plan(initial=False)
                        continue
                    try:
                        join_one(adopt(pair[0], pair[1], proc=None))
                    except (ValueError, TimeoutError):
                        pass    # cross-host dial into a host-local
                        # transport, or the dialer died mid-welcome:
                        # a bad joiner must never take down the run

        def check_deaths() -> None:
            """Channel-based liveness, partition-aware (docs/faults.md).

            A *definitive* verdict (process exit, EOF, send failure) is a
            death, immediately.  A *silence* verdict (missed heartbeats)
            is first a SUSPICION: the worker is taken out of the dispatch
            rotation for up to ``suspect_grace`` seconds; if its frames
            return inside the window it heals — its in-flight bookkeeping
            was never torn down, so reconciliation is free and
            ``recomputed`` stays 0.  Only an expired grace escalates to
            the lineage-recovery death path.

            Healing is scored: ``quarantine_after`` suspect-then-heal
            episodes quarantine the worker (drain, no new dispatches), and
            ``probe_interval`` of verified-healthy channel re-admits it
            with its flakiness score halved."""
            now = time.perf_counter()
            for w in list(workers.values()):
                if not w.alive:
                    continue
                wid = w.wid
                verdict = w.chan.dead()
                if verdict is None:
                    if wid in suspects:
                        suspects.pop(wid)
                        stats["healed"] += 1
                        flake_score[wid] = flake_score.get(wid, 0.0) + 1.0
                        if wid in quarantined:
                            quarantined[wid] = now  # probe restarts
                        elif flake_score[wid] >= self.quarantine_after \
                                and any(x.alive and x.wid != wid
                                        and x.wid not in quarantined
                                        for x in workers.values()):
                            # never quarantine the last usable worker
                            quarantined[wid] = now
                            stats["quarantined"] += 1
                    elif wid in quarantined and \
                            now - quarantined[wid] >= self.probe_interval:
                        quarantined.pop(wid)
                        flake_score[wid] = flake_score.get(wid, 0.0) / 2.0
                        stats["readmitted"] += 1
                    continue
                if is_silence(verdict) and self.suspect_grace > 0:
                    first = suspects.get(wid)
                    if first is None:
                        suspects[wid] = now
                        stats["suspected"] += 1
                        continue
                    if now - first < self.suspect_grace:
                        continue        # still inside the grace window
                on_worker_death(w)

        # ------------------------------------------------------ driver resume
        # worker inventories reported at rejoin, parked until the frontier
        # is seeded (a rejoiner can't be reconciled against state that
        # doesn't exist yet); late rejoiners record directly
        inventories: Dict[int, List[Tuple[int, int]]] = {}
        resume_seeded = [rs is None]

        def adopt_rejoin(sock, hello: dict) -> Optional[_Worker]:
            """Re-adopt a surviving worker of THIS run: it keeps its old
            worker id and its object store; its inventory (first frame
            after the welcome) tells the driver what actually survived."""
            nonlocal next_wid
            wid = hello.get("wid")

            def refuse(reason: str) -> None:
                try:
                    _send_frame(sock, pickle.dumps(("reject", reason),
                                                   protocol=5))
                except OSError:
                    pass
                try:
                    sock.close()
                except OSError:
                    pass

            if hello.get("rejoin") != run_id:
                refuse(f"unknown run {hello.get('rejoin')!r}")
                return None
            if not isinstance(wid, int) or wid < 0:
                refuse(f"malformed rejoin wid {wid!r}")
                return None
            worker_host = hello.get("host", "?")
            try:
                _send_frame(sock, pickle.dumps(
                    ("welcome", wid, run_config(hello), None), protocol=5))
                sock.settimeout(10.0)
                first = _recv_frame(sock)
                sock.settimeout(None)
            except (OSError, EOFError, pickle.UnpicklingError,
                    ChannelClosed):
                try:
                    sock.close()
                except OSError:
                    pass
                return None
            if not (isinstance(first, tuple) and len(first) == 3
                    and first[0] == "inv"):
                try:
                    sock.close()
                except OSError:
                    pass
                return None
            inv = [(t, nb) for t, nb in first[2] if t in graph.nodes]
            chan = wrap_chan(
                TcpChannel(sock,
                           heartbeat_interval=self.heartbeat_interval,
                           heartbeat_timeout=self.heartbeat_timeout,
                           heartbeat_jitter=self.heartbeat_jitter),
                wid)
            old = workers.get(wid)
            if old is not None and old.alive:
                # same worker process re-dialed under a live driver (socket
                # bounce / healed partition): swap the transport, keep the
                # in-flight bookkeeping — its queued work continues there.
                # NOT a death: close must not trip the death handler
                old.chan.close()
                old.chan = chan
                w = old
                if wid in suspects:     # the re-dial IS the heal signal
                    suspects.pop(wid)
                    stats["healed"] += 1
                    flake_score[wid] = flake_score.get(wid, 0.0) + 1.0
            else:
                # driver-restart rejoin (or a worker whose heartbeat loss
                # was already recovered — its values are extra replicas
                # now, never a second recovery plan)
                w = _Worker(wid, chan, worker_host, proc=None)
                workers[wid] = w
                store.add_worker(wid, host=worker_host)
                next_wid = max(next_wid, wid + 1)
            if runlog is not None:
                runlog.append("worker", wid, worker_host)
            if not resume_seeded[0]:
                inventories[wid] = inv
            else:
                for t, nb in inv:
                    if state.get(plan.cluster_of[t]) == DONE \
                            and not store.was_dropped(t):
                        store.record(t, w.wid, nb)
            return w

        def rejoin_barrier() -> None:
            """Bounded wait for the interrupted run's surviving workers to
            re-dial the freshly rebound listener.  Workers that never show
            are simply absent — their values count as outage losses and
            lineage recovers them; nothing blocks on a corpse."""
            expected = set(rs.live_workers) - set(workers)
            deadline = time.monotonic() + self.rejoin_timeout
            while expected:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                heartbeat_all()
                try:
                    sock, hello = listener.get_worker(min(0.5, remaining))
                except TimeoutError:
                    continue
                if hello.get("rejoin") is not None:
                    w = adopt_rejoin(sock, hello)
                    if w is not None:
                        expected.discard(w.wid)
                else:
                    dial_stash.append((sock, hello))    # fresh dial: joins
                    # elastically once the run is seeded and live

        def seed_from_checkpoint() -> None:
            """Rebuild the execution frontier from the run log plus what
            rejoined workers actually report holding, then reconcile: every
            claimed-done value that truly survived stays done; everything
            else becomes ONE recovery plan (bounded recomputation)."""
            # durable copies the log recorded, existence-verified — a
            # checkpoint never outranks the filesystem
            live_handles: Dict[int, Any] = {}
            for tid, hb in rs.handles.items():
                if tid not in graph.nodes:
                    continue
                try:
                    h = pickle.loads(hb)
                except Exception:       # noqa: BLE001 — stale/foreign blob
                    continue
                if not serde.is_durable(h):
                    continue
                refs = getattr(h, "shm_refs", lambda: ())()
                if all(os.path.exists(os.path.join(serde._SHM_DIR, r.name))
                       for r in refs):
                    live_handles[tid] = h
            values: Dict[int, Any] = {}
            for tid, vb in rs.values.items():
                if tid not in graph.nodes:
                    continue
                try:
                    values[tid] = pickle.loads(vb)
                except Exception:       # noqa: BLE001
                    continue
            inv_tids = {t for inv in inventories.values() for t, _ in inv}
            survived = inv_tids | set(live_handles) | set(values)
            # the frontier: checkpoint claims, plus promotion of clusters
            # that finished during the outage window (claim lost with the
            # unflushed tail) but whose entire externally-visible keep set
            # demonstrably survived
            done0 = {cid for cid in rs.done if cid in cg.nodes}
            for cid in cg.nodes:
                if cid in done0:
                    continue
                ks = fusion_view.keep.get(cid) or plan.members[cid]
                if all(t in survived for t in ks):
                    done0.add(cid)
            store.seed_after_outage(done0, inventories, live_handles,
                                    values, rs.dropped)
            for cid, (_, sizes_) in rs.done.items():
                if cid in done0:
                    for t, nb in sizes_.items():
                        if nb:
                            store.sizes.setdefault(t, nb)
            for cid in done0:
                state[cid] = DONE
                done.add(cid)
                finish_times[cid] = 0.0     # completed in a past life
            for cid in cg.nodes:
                if cid in done0:
                    continue
                state[cid] = (READY if all(state.get(d) == DONE
                                           for d in cg.nodes[cid].all_deps)
                              else PENDING)
            resume_seeded[0] = True
            stats["resumed_clusters"] = len(done0)
            # reconcile claims against reality: all outage losses fold into
            # exactly ONE recovery plan — a worker whose heartbeat died
            # with the driver is part of this plan, never a second one
            available = store.available(set(alive_ids()))
            lost, needed, _ = outage_recovery(plan, graph, done0, available,
                                              self.outputs_only)
            if lost or needed:
                recompute_lost(needed, lost, "driver-outage")

        # ------------------------------------------------------- main loop
        self._active = True
        crashed = False
        try:
            if rs is not None:
                if listener is not None:
                    rejoin_barrier()
                n_live = len([w for w in workers.values() if w.alive])
                for _ in range(max(0, len(self.worker_specs) - n_live)):
                    spawn()
                seed_from_checkpoint()
                if not error:
                    make_plan(initial=False)
            else:
                for spec in self.worker_specs:
                    if spec == "remote":
                        adopt_remote()
                    else:
                        spawn()
                make_plan(initial=True)
            if pool_up is not None:
                pool_up.set()           # the pool's first workers are up
            while not error:
                check_commands()
                if resident:
                    # the resident loop never "finishes": it services job
                    # completions and keeps dispatching until shut down
                    if self._shutdown.is_set():
                        break
                    service_jobs()
                    t_d = time.perf_counter()
                    dispatch()
                    maybe_speculate()
                    stats["dispatch_overhead_s"] += \
                        time.perf_counter() - t_d
                elif len(done) >= n_total:
                    if collect_finals():
                        break
                else:
                    t_d = time.perf_counter()
                    dispatch()
                    maybe_speculate()
                    stats["dispatch_overhead_s"] += \
                        time.perf_counter() - t_d
                pump(timeout=0.02)
                if runlog is not None:
                    runlog.maybe_flush()
                    if time.monotonic() - last_lease > 5.0:
                        for p in [seg_prefix] + old_prefixes:
                            serde.refresh_resume_lease(p)
                        last_lease = time.monotonic()
                if self.fail_driver is not None and not crashed \
                        and len(done) >= self.fail_driver:
                    # emulated kill -9: sockets and listener torn down raw,
                    # every shutdown nicety (stop/join/flush/sweep) skipped.
                    # Buffered log records since the last timed flush are
                    # LOST — exactly what a real SIGKILL loses
                    crashed = True
                    for w in workers.values():
                        if not w.alive:
                            continue
                        raw = getattr(w.chan, "sock", None) \
                            or getattr(w.chan, "conn", None)
                        try:
                            raw.close() if raw is not None \
                                else w.chan.close()
                        except OSError:
                            pass
                    if listener is not None:
                        listener.close()
                        self.listener = None
                    raise DriverKilled(run_id)
                check_deaths()
                for w in workers.values():
                    if w.alive:
                        w.chan.maybe_heartbeat()
                if resident and not jobs:
                    # an idle resident service is healthy, not hung: the
                    # progress watchdog only arms while jobs are admitted
                    last_progress = time.perf_counter()
                if time.perf_counter() - last_progress > self.progress_timeout:
                    by_state: Dict[int, List[int]] = {}
                    for c, s in state.items():
                        by_state.setdefault(s, []).append(c)
                    error.append(RuntimeError(
                        f"cluster made no progress for "
                        f"{self.progress_timeout}s "
                        f"(done {len(done)}/{n_total}, states "
                        f"{ {s: sorted(ts)[:8] for s, ts in by_state.items() if s != DONE} }, "
                        f"waiting {dict(list(waiting.items())[:4])}, "
                        f"fetching {dict(list(fetching.items())[:8])}, "
                        f"inflight {[sorted(w.inflight) for w in workers.values()]})"))
        finally:
            self._active = False
            if resident:
                # jobs the loop never resolved (shutdown mid-run, infra
                # error, pool bring-up failure) must not hang clients —
                # including submissions still parked in the command queue
                rexc = (error[0] if error
                        else RuntimeError("resident executor shut down"))
                for job in list(jobs.values()):
                    if not job.terminal:
                        job.terminal = True
                        job.future._set_error(rexc)
                with self._cmd_lock:
                    cmds, self._commands = self._commands, []
                for cmd in cmds:
                    if cmd[0] == "job":
                        cmd[1].future._set_error(rexc)
            if crashed:
                # emulated SIGKILL: leave everything exactly as a dead
                # driver would — workers alive (rejoin loops armed), shm
                # segments in place, run log unflushed past its last timed
                # fsync.  The resumed incarnation (and the repro-worker
                # startup sweep) own the cleanup.
                pass
            else:
                # speculation losers still executing at shutdown burned
                # their time just the same — charge what the run observed
                end_t = time.perf_counter()
                for cid, starts in run_started.items():
                    if state.get(cid) == DONE:
                        for st in starts.values():
                            stats["speculative_wasted_s"] += end_t - st
                for w in workers.values():
                    if w.alive:
                        try:
                            w.chan.send(("stop",))
                        except ChannelClosed:
                            pass
                for w in workers.values():
                    if w.proc is not None:
                        w.proc.join(timeout=5.0)
                        if w.proc.is_alive():
                            w.proc.terminate()
                            w.proc.join(timeout=5.0)
                    w.chan.close()
                for sock, _ in dial_stash:      # dials we never adopted
                    try:
                        sock.close()
                    except OSError:
                        pass
                # hygiene sweep: free tracked handles, then clear the run's
                # /dev/shm prefix AND its peer-socket tmpdir — orphans from
                # workers killed mid-publish never cleaned up after
                # themselves.  A resumed run also sweeps every PRIOR
                # incarnation's prefix: their surviving segments were the
                # recovery inputs and are dead weight now the run is over
                if runlog is not None:
                    runlog.close()
                    for p in [seg_prefix] + old_prefixes:
                        serde.clear_resume_lease(p)
                store.release_all()
                serde.sweep_segments(seg_prefix)
                for p in old_prefixes:
                    serde.sweep_segments(p)
                serde.sweep_peer_sockets(peer_dir)
            self.wall_time = time.perf_counter() - t0
            # finalize the replayable trace (benchmarks/hillclimb feed it
            # into the simulator's offline policy search)
            trace.n_workers = len(workers) or self.n_workers
            cost_model.observe_dispatch(
                stats["dispatch_overhead_s"], stats["dispatched"])
            trace.unit_s = cost_model.unit_s or 0.0
            trace.dispatch_s = cost_model.dispatch_s
            stats["cost_unit_s"] = trace.unit_s
            stats["dispatch_cost_s"] = cost_model.dispatch_s

        if error:
            raise error[0]
        if resident:
            return {}       # results flow through each job's future
        if coll_map is None:
            return {t: store.cache[t] for t in required}
        # map lowered values back to the user's tid space (stage nodes are
        # runtime detail; the contract is the traced graph's ids)
        return {t: store.cache[coll_map[t]] for t in user_required}
