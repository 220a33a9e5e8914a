"""Executors that really run a TaskGraph.

Port of ``repro/core/executor.py``.  ``run_graph(connect=)`` on the thread
backend submits to the port's gateway (:mod:`repro_torch.gateway`).

* :class:`Executor` — the protocol every runtime backend satisfies:
  ``run(graph, inputs) -> {tid: value}`` plus ``stats``/``wall_time``
  introspection.  Backends must be *oracle-faithful*: tasks are pure, so
  results have to be bit-identical to :func:`execute_sequential`.
* :func:`execute_sequential` — single-thread topo-order oracle (the paper's
  "single-thread baseline"); every parallel executor must match it exactly
  because tasks are pure.
* :class:`ThreadedExecutor` — worker threads with per-worker deques and work
  stealing (the paper's runtime, on one host).  Python threads give real
  overlap because a task's payload spends its time outside the interpreter
  lock: a torch launch on the GPU is asynchronous (the host returns once the
  kernel is queued), the port's hand-written kernels are called through
  ``ctypes``, which releases the lock for the call, and numpy's bulk random
  generators release it while they fill.
* :class:`repro_torch.cluster.ClusterExecutor` — the multi-process backend
  (OS process workers, driver-side object store, lineage recovery); select
  it with ``run_graph(..., backend="process")``.  Once this process has
  initialised CUDA its workers spawn unless the config names a start
  method (a forked child cannot initialise CUDA once the parent has), and
  values cross processes as host bytes (``repro_torch/cluster/serde.py``).
* Failure injection hooks drive the lineage-recovery tests.

Streams: every worker thread launches on PyTorch's current stream, which is
the device's default stream in each thread.  Work is therefore ordered on
the device in launch order, and a tensor made by one worker can be read by
another with no event.  Per-worker streams are later work.
"""
from __future__ import annotations

import threading
import time as _time
from typing import (Any, Callable, Dict, List, Optional, Protocol, Set,
                    runtime_checkable)

from .graph import TaskGraph
from .tracing import substitute_refs
from .lineage import recovery_plan


@runtime_checkable
class Executor(Protocol):
    """What the launchers/benchmarks require of a runtime backend.

    ``stats`` holds backend-specific counters (every backend reports at
    least ``recomputed``); ``wall_time`` is the last run's duration.
    """

    stats: Dict[str, int]
    wall_time: float

    def run(self, graph: TaskGraph,
            inputs: Optional[Dict[str, Any]] = None) -> Dict[int, Any]:
        ...


class TaskFailed(RuntimeError):
    def __init__(self, tid: int, name: str, cause: BaseException):
        super().__init__(f"task {name}#{tid} failed: {cause!r}")
        self.tid = tid
        self.cause = cause


class MissingInput(KeyError):
    """A ``placeholder`` input was not provided — a caller error, raised
    as-is (never wrapped in TaskFailed)."""


def _run_node(graph: TaskGraph, tid: int, results: Dict[int, Any],
              inputs: Optional[Dict[str, Any]] = None) -> Any:
    node = graph.nodes[tid]
    if "input" in node.meta:
        if inputs is None or node.meta["input"] not in inputs:
            raise MissingInput(
                f"graph input {node.meta['input']!r} not provided")
        return inputs[node.meta["input"]]
    args = substitute_refs(node.args, results)
    kwargs = substitute_refs(node.kwargs, results)
    return node.fn(*args, **kwargs)


def execute_sequential(graph: TaskGraph,
                       inputs: Optional[Dict[str, Any]] = None) -> Dict[int, Any]:
    """Oracle executor: topo order, one thread. Returns {tid: value}."""
    graph.validate()
    results: Dict[int, Any] = {}
    for tid in graph.topo_order():
        try:
            results[tid] = _run_node(graph, tid, results, inputs)
        except MissingInput:
            raise
        except Exception as e:
            raise TaskFailed(tid, graph.nodes[tid].name, e) from e
    return results


# threads share one address space, so the data-plane counters every backend
# reports (see ClusterExecutor) are structurally zero here — "zero-copy"
# is the hardware default in-process
_THREAD_STATS = {"steals": 0, "recomputed": 0, "bytes_moved": 0,
                 "transfers_direct": 0, "transfers_driver": 0}


class ThreadedExecutor:
    """Work-stealing thread-pool executor.

    Scheduling follows the paper: a task becomes *ready* the moment its last
    input materializes; the finishing worker pushes it onto its own deque
    (locality), idle workers steal from the most-loaded victim.  Effect
    (token) edges are ordinary dependencies, so ``IO`` tasks execute in
    program order.

    ``fail_task(worker, tid) -> bool`` optionally simulates losing the result
    of an execution (at most once per task) to exercise lineage recovery.
    """

    def __init__(self, n_workers: int = 4,
                 fail_task: Optional[Callable[[int, int], bool]] = None):
        if n_workers < 1:
            raise ValueError("n_workers >= 1")
        self.n_workers = n_workers
        self.fail_task = fail_task
        self.stats = dict(_THREAD_STATS)
        self.wall_time = 0.0

    def run(self, graph: TaskGraph,
            inputs: Optional[Dict[str, Any]] = None) -> Dict[int, Any]:
        graph.validate()
        succ = graph.successors()
        n_total = len(graph.nodes)
        rank = graph.critical_path_rank()

        lock = threading.Lock()
        cv = threading.Condition(lock)
        results: Dict[int, Any] = {}
        deques: List[List[int]] = [[] for _ in range(self.n_workers)]
        queued: Set[int] = set()      # in some deque
        inflight: Set[int] = set()
        lost: Set[int] = set()        # tids already failure-injected once
        errors: List[BaseException] = []
        stats = self.stats = dict(_THREAD_STATS)

        def ready_p(tid: int) -> bool:
            return (tid not in results and tid not in inflight
                    and tid not in queued
                    and all(d in results for d in graph.nodes[tid].all_deps))

        def enqueue(w: int, tid: int) -> None:
            queued.add(tid)
            deques[w].append(tid)

        sources = sorted((t for t in graph.nodes
                          if not graph.nodes[t].all_deps),
                         key=lambda t: -rank[t])
        for i, t in enumerate(sources):
            enqueue(i % self.n_workers, t)

        def grab(w: int) -> Optional[int]:
            """Pop own deque (LIFO) else steal (FIFO from most-loaded)."""
            if deques[w]:
                tid = deques[w].pop()
            else:
                victim = max((v for v in range(self.n_workers)
                              if v != w and deques[v]),
                             key=lambda v: len(deques[v]), default=None)
                if victim is None:
                    return None
                stats["steals"] += 1
                tid = deques[victim].pop(0)
            queued.discard(tid)
            return tid

        def worker(w: int) -> None:
            while True:
                with cv:
                    while True:
                        if errors or len(results) >= n_total:
                            return
                        tid = grab(w)
                        if tid is not None:
                            break
                        cv.wait(timeout=0.02)
                    inflight.add(tid)
                    res_view = dict(results)
                try:
                    value = _run_node(graph, tid, res_view, inputs)
                    failed = bool(self.fail_task and tid not in lost
                                  and self.fail_task(w, tid))
                except BaseException as e:
                    with cv:
                        errors.append(TaskFailed(tid, graph.nodes[tid].name, e))
                        cv.notify_all()
                    return
                with cv:
                    inflight.discard(tid)
                    if failed:
                        lost.add(tid)
                        # the worker "lost" this result (and conceptually the
                        # ones it held); recompute the minimal lineage set
                        plan = recovery_plan(graph, {tid}, set(results))
                        stats["recomputed"] += len(plan)
                        for t in plan:
                            results.pop(t, None)
                            queued.discard(t)
                        for t in sorted(plan, key=lambda t: -rank[t]):
                            if ready_p(t):
                                enqueue(w, t)
                    else:
                        results[tid] = value
                        for s in sorted(succ[tid], key=lambda t: -rank[t]):
                            if ready_p(s):
                                enqueue(w, s)   # locality: run where produced
                    cv.notify_all()
                    if len(results) >= n_total:
                        return

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(self.n_workers)]
        t0 = _time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self.wall_time = _time.perf_counter() - t0
        if errors:
            raise errors[0]
        if len(results) != n_total:
            raise RuntimeError(
                f"executor finished with {n_total - len(results)} tasks missing")
        return results


def make_executor(backend: str, n_workers: int, config=None,
                  **kw) -> Executor:
    """Factory over runtime backends: ``thread`` | ``process``.

    ``config`` is a :class:`repro_torch.ClusterConfig` — the one object
    carrying every process-backend knob; the loose keyword arguments are
    the deprecated legacy spelling (see ``repro_torch/config.py``).
    Cluster-only options (``transport``, ``channel``, ``connect``, ... —
    or a ``config`` at all) passed to the thread backend are named errors
    here, not ``TypeError`` shrapnel from ``ThreadedExecutor.__init__``:
    the thread backend runs in one address space and has no data or
    control plane to select.
    """
    if backend == "thread":
        cluster_only = sorted(
            k for k in ("transport", "channel", "connect", "workers",
                        "start_method", "shm_threshold", "token",
                        "speculate_after", "fuse", "collectives",
                        "checkpoint_dir",
                        "checkpoint_interval", "resume", "rejoin_timeout",
                        "rejoin_window", "fail_driver")
            if k in kw)
        if config is not None:
            cluster_only = ["config"] + cluster_only
        if cluster_only:
            raise ValueError(
                f"option(s) {cluster_only} apply only to the process "
                f"backend (backend='process'); the thread backend shares "
                f"one address space")
        return ThreadedExecutor(n_workers, **kw)
    if backend == "process":
        from ..cluster import ClusterExecutor   # deferred: no cycle
        return ClusterExecutor(n_workers, config=config, **kw)
    raise ValueError(f"unknown backend {backend!r} "
                     "(expected 'thread' or 'process')")


def run_graph(graph: TaskGraph, n_workers: int = 1,
              inputs: Optional[Dict[str, Any]] = None,
              backend: str = "thread", with_report: bool = False,
              config=None, connect: Optional[str] = None,
              token: Optional[str] = None, **kw):
    """Run ``graph`` on the selected backend.

    ``n_workers=1`` on the thread backend runs the sequential oracle.
    ``connect="host:port"`` (with the default backend) submits the graph
    to a resident multi-tenant gateway at that address instead of running
    locally: the graph is traced here, runs on the gateway's shared pool
    through one client session (:mod:`repro_torch.gateway`), and the
    report's backend is ``"gateway"``.  With ``backend="process"`` it
    keeps its other meaning: the address the driver *binds* for dialing
    workers (``python -m repro_torch.launch.remote``).  ``config`` is a
    :class:`repro_torch.ClusterConfig` for the process backend; sent to a
    gateway, only its ``outputs_only`` travels.

    ``with_report=True`` returns ``(results, report)`` where ``report``
    carries the backend, worker count, wall time, the backend's stats
    counters (``steals``, ``recomputed`` and the data-plane fields
    ``bytes_moved`` / ``transfers_direct`` / ``transfers_driver``, which
    are structurally zero in one address space; the process backend adds
    the fusion and control-plane fields ``n_clusters`` / ``tasks_fused`` /
    ``control_msgs`` / ``control_frames``, ``first_done_s`` /
    ``last_done_s`` and the rest of ``ClusterExecutor.stats``) and, for
    the process backend, the data plane's ``transport``, the workers'
    ``start_method`` and the lineage ``recovery_events``.
    """
    if connect is not None and backend != "process":
        # gateway session: trace locally, execute on the shared pool
        from ..gateway.client import connect as _gw_connect
        with _gw_connect(connect, token=token) as client:
            fut = client.submit(graph, inputs, config=config)
            results = fut.result()
        if with_report:
            return results, {"backend": "gateway", "n_workers": n_workers,
                             "wall_time": fut.wall_time,
                             "stats": dict(fut.stats or {})}
        return results
    if token is not None:
        kw["token"] = token
    if n_workers == 1 and backend == "thread":
        t0 = _time.perf_counter()
        results = execute_sequential(graph, inputs)
        if with_report:
            return results, {"backend": "sequential", "n_workers": 1,
                             "wall_time": _time.perf_counter() - t0,
                             "stats": {}}
        return results
    if connect is not None:
        kw["connect"] = connect
    ex = make_executor(backend, n_workers, config=config, **kw)
    results = ex.run(graph, inputs)
    if with_report:
        report = {"backend": backend, "n_workers": n_workers,
                  "wall_time": ex.wall_time, "stats": dict(ex.stats)}
        if backend == "process":
            report.update(transport=ex.transport_used,
                          start_method=ex.start_method,
                          recovery_events=list(ex.recovery_events))
        return results, report
    return results


def output_values(graph: TaskGraph, results: Dict[int, Any]) -> List[Any]:
    return [results[t] for t in graph.outputs]
