"""Driver-side object store: replica tracking + handles + value cache + GC.

Port of ``repro/cluster/objectstore.py``, unchanged.

The driver does not hold every value — workers do (see
:mod:`repro_torch.cluster.worker`).  What the driver tracks is *where* each
task's result lives, and since the zero-copy data plane a value can live in
several places at once:

* ``replicas[tid]`` — the set of workers holding the decoded value in
  their local stores (the producer, plus every consumer a transfer landed
  on).  A value is only *lost* when its **last** live replica dies and no
  durable copy exists — the post-transfer replica bug class the PR-1
  single-``owner`` field had.
* ``handles[tid]`` — the published transfer handle
  (:class:`~repro_torch.cluster.serde.Encoded` or ``PeerRef``).  Shm/inline
  handles are **durable**: the payload lives in tmpfs or driver memory and
  survives the producing worker's death.  Peer handles die with their
  worker and are dropped in :meth:`drop_worker`.
* ``cache[tid]`` — values the driver has materialized (final collection);
  always durable.
* ``sizes[tid]`` — payload bytes reported at completion, feeding the
  locality-aware placement score in the executor's dispatch loop and the
  ``data_sizes`` comm-cost in :func:`repro_torch.core.scheduler.list_schedule`.

Fault-tolerance contract (unchanged from PR-1 in spirit): a value with no
live replica, no durable handle, and no cached copy must be recomputed via
:func:`repro_torch.core.lineage.recovery_plan`; a value dropped by GC is gone
*everywhere* and recovery walks past it.  The store is also the segment
refcount authority: :meth:`invalidate` releases a handle's shared-memory
segments, so the ``consumers_left`` GC unlinks ``/dev/shm`` entries the
moment the last consumer finishes.
"""
from __future__ import annotations

from typing import Any, Dict, Set

from repro_torch.core.graph import TaskGraph

from . import serde


class DriverObjectStore:
    """Value-granular tracking, super-task-aware accounting.

    Since the fusion pass (``repro_torch.core.fusion``) the driver dispatches
    *clusters* but values keep member-task identity: ``replicas`` /
    ``handles`` / ``cache`` / ``sizes`` are all keyed by member tid.  What
    changes with a non-identity ``plan`` is the **refcount universe**:
    intra-cluster reads happen inside one worker's execution frame and
    never touch the store, so ``consumers_left`` counts *consuming
    clusters* of each externally visible value — the identity plan makes
    that exactly the old per-task successor count.
    """

    def __init__(self, graph: TaskGraph, plan=None) -> None:
        if plan is None:
            from repro_torch.core.fusion import identity_plan
            plan = identity_plan(graph)
        self.graph = graph
        self.plan = plan
        self.cache: Dict[int, Any] = {}          # driver-held decoded values
        self.replicas: Dict[int, Set[int]] = {}  # tid -> worker ids holding it
        self.handles: Dict[int, serde.Handle] = {}   # tid -> published handle
        self.sizes: Dict[int, int] = {}          # tid -> payload bytes
        self.known: Dict[int, Set[int]] = {}     # worker id -> {tid} it holds
        self.worker_host: Dict[int, Any] = {}    # worker id -> machine id
        self.dropped: Set[int] = set()           # tids swept by the GC
        self.successors = graph.successors()
        self.consumers_left: Dict[int, int] = {
            tid: len(plan.consumers.get(tid, ())) for tid in graph.nodes}

    # ------------------------------------------------------------ admission
    def admit(self, tids) -> None:
        """A resident-mode job was admitted: extend the refcount universe
        to its member tids.  ``self.plan``/``self.graph`` are the live
        (already merged) union objects, so the consumer counts come from
        the same source the initial constructor snapshot did.  Existing
        entries are never touched — earlier jobs' in-flight refcounts must
        not be reset by a newcomer."""
        for tid in tids:
            if tid not in self.consumers_left:
                self.consumers_left[tid] = \
                    len(self.plan.consumers.get(tid, ()))

    def retire(self, tids) -> None:
        """A resident-mode job was collected (or failed): drop its values
        everywhere and forget its refcounts, so a long-lived gateway run's
        store does not grow with every job ever submitted."""
        self.invalidate(set(tids))
        for tid in tids:
            self.consumers_left.pop(tid, None)
            self.sizes.pop(tid, None)
            self.dropped.discard(tid)

    # ------------------------------------------------------------ ownership
    def add_worker(self, wid: int, host: Any = "local") -> None:
        self.known.setdefault(wid, set())
        self.worker_host[wid] = host

    def on_host(self, tid: int, host: Any) -> bool:
        """True when some replica of ``tid`` lives on machine ``host`` —
        the per-host locality grouping: a same-host copy is reachable over
        shm/unix-socket (near), a cross-host one only over TCP (far)."""
        return any(self.worker_host.get(w) == host
                   for w in self.replicas.get(tid, ()))

    def record(self, tid: int, wid: int, nbytes: int = 0) -> None:
        """Task ``tid`` completed on worker ``wid``; value lives there."""
        self.replicas.setdefault(tid, set()).add(wid)
        self.known.setdefault(wid, set()).add(tid)
        if nbytes:
            self.sizes[tid] = nbytes

    def record_replica(self, tid: int, wid: int) -> None:
        """A transfer landed the (pure, hence identical) value of ``tid``
        in ``wid``'s local store too — a real copy, usable for future
        locality and surviving the original owner's death."""
        self.replicas.setdefault(tid, set()).add(wid)
        self.known.setdefault(wid, set()).add(tid)

    def has_replica(self, tid: int, wid: int) -> bool:
        return wid in self.replicas.get(tid, ())

    def locations(self, tid: int) -> Set[int]:
        return self.replicas.get(tid, set())

    def set_handle(self, tid: int, handle: serde.Handle) -> None:
        old = self.handles.get(tid)
        if old is not None and old is not handle:
            serde.release(old)
        self.handles[tid] = handle

    def durable(self, tid: int) -> bool:
        h = self.handles.get(tid)
        return tid in self.cache or (h is not None and serde.is_durable(h))

    def cache_value(self, tid: int, value: Any) -> None:
        self.cache[tid] = value

    def available(self, alive: Set[int]) -> Set[int]:
        """Tids whose values still exist somewhere: driver cache, a durable
        published handle (tmpfs / driver memory), or a live replica."""
        out = set(self.cache)
        out |= {t for t, h in self.handles.items() if serde.is_durable(h)}
        for wid in alive:
            out |= self.known.get(wid, set())
        return out

    # --------------------------------------------------------------- resume
    def seed_after_outage(self, done_clusters: Set[int],
                          inventories: Dict[int, Any],
                          handles: Dict[int, serde.Handle],
                          values: Dict[int, Any],
                          dropped: Set[int]) -> None:
        """Rebuild a fresh store from a checkpoint plus rejoined-worker
        inventory after a driver outage.  ``inventories`` maps worker id
        (already registered via :meth:`add_worker`) to ``(tid, nbytes)``
        pairs the worker still holds; ``handles``/``values`` are the
        durable copies the run log recorded (existence-verified by the
        caller); ``dropped`` is the GC frontier the log claims.  Inventory
        wins over a ``dropped`` claim — a worker that still holds a value
        makes it live again (worst case the refcount GC re-sweeps it).
        Handles are assigned directly, never through :meth:`set_handle`:
        there is no prior handle to release in a store this young, and a
        release here would unlink the very tmpfs segment that survived
        the outage."""
        inv_tids: Set[int] = set()
        for wid, inv in inventories.items():
            for tid, nbytes in inv:
                inv_tids.add(tid)
                if self.plan.cluster_of.get(tid) in done_clusters:
                    self.record(tid, wid, nbytes)
        self.handles.update(handles)
        self.cache.update(values)
        self.dropped = set(dropped) - inv_tids - set(self.cache) \
            - set(self.handles)
        # refcount universe: consumers that already completed never re-read
        self.consumers_left = {
            tid: sum(1 for c in self.plan.consumers.get(tid, ())
                     if c not in done_clusters)
            for tid in self.graph.nodes}

    # -------------------------------------------------------------- failure
    def drop_worker(self, wid: int) -> Set[int]:
        """Worker died: forget its store.  Returns the tids whose values are
        now *lost* — no surviving replica AND no durable copy.  A value
        replicated by an earlier transfer, published to shared memory, or
        cached on the driver is NOT lost (the replica-set fix: PR-1's single
        ``owner`` field reported any multiply-held value as lost)."""
        held = self.known.pop(wid, set())
        self.worker_host.pop(wid, None)
        lost: Set[int] = set()
        for t in held:
            reps = self.replicas.get(t)
            if reps is not None:
                reps.discard(wid)
                if not reps:
                    del self.replicas[t]
            h = self.handles.get(t)
            if isinstance(h, serde.PeerRef) and h.wid == wid:
                del self.handles[t]          # peer handle died with it
            elif isinstance(h, serde.DualRef) and h.peer.wid == wid:
                # the TCP half died with the worker and the shm half is
                # host-scoped (unreachable from other machines), so the
                # handle goes.  The release only reaches segments on the
                # DRIVER's host (a same-host worker's crash); a remote
                # crash leaves its segments to that host's own hygiene —
                # the documented repro-worker-sweep open item
                serde.release(h)
                del self.handles[t]
            if not self.replicas.get(t) and not self.durable(t):
                lost.add(t)
        return lost

    def invalidate(self, tids: Set[int]) -> None:
        """Remove every trace of ``tids`` (they will be recomputed or have
        been GC'd), and unlink any shared-memory segments their handles
        held.  Clears any GC ``dropped`` mark: a recomputed value is live
        again (the ``mark_dropped`` caller re-marks after a GC sweep)."""
        for t in tids:
            self.cache.pop(t, None)
            self.dropped.discard(t)
            serde.release(self.handles.pop(t, None))
            for wid in self.replicas.pop(t, set()):
                self.known.get(wid, set()).discard(t)

    # -------------------------------------------------- duplicate publishes
    def mark_dropped(self, tid: int) -> None:
        """The ``consumers_left`` GC swept ``tid`` everywhere.  A *late*
        duplicate publish of it (a speculation loser finishing after the
        winner AND after the sweep) must be swept too, not resurrected as
        a replica — :meth:`was_dropped` is how the executor tells the two
        apart when the late ``done`` arrives."""
        self.dropped.add(tid)

    def was_dropped(self, tid: int) -> bool:
        return tid in self.dropped

    def release_all(self) -> None:
        """End of run: free every outstanding handle's segments."""
        for h in self.handles.values():
            serde.release(h)
        self.handles.clear()

    # ------------------------------------------------------------------- GC
    def consumed(self, tid: int) -> None:
        """A consumer of ``tid`` completed."""
        if tid in self.consumers_left:
            self.consumers_left[tid] -= 1

    def collectable(self, tid: int) -> bool:
        return (self.consumers_left.get(tid, 1) <= 0
                and tid not in self.graph.outputs)

    def reset_consumers(self, recomputed: Set[int],
                        will_run: Set[int]) -> None:
        """After scheduling a recovery plan (``recomputed`` cluster ids),
        a recomputed cluster's externally visible values are needed once
        per consuming cluster that will still execute (``will_run`` =
        recovery plan ∪ not-yet-done clusters; consumers that stayed
        completed never re-read).  External inputs a re-run cluster will
        read — values that stayed available outside the plan — gain one
        pending read each, so the GC cannot sweep them out from under the
        recovery."""
        plan = self.plan
        for c in recomputed:
            for v in plan.outputs[c]:
                self.consumers_left[v] = sum(
                    1 for cc in plan.consumers.get(v, ())
                    if cc in will_run)
            for v in plan.ext_deps[c]:
                if plan.cluster_of[v] not in recomputed:
                    self.consumers_left[v] = \
                        self.consumers_left.get(v, 0) + 1
