"""Worker-process side of the cluster runtime.

Port of ``repro/cluster/worker.py``.  Two things are the port's own:

* **A forked worker computes on one CPU thread** (:func:`_single_thread`).
  Torch's CPU build runs its ops on GNU OpenMP, whose thread pool does not
  survive ``fork``: a child whose parent has already run a parallel region
  hangs in its first one.  Spawned and remote workers start a fresh
  interpreter and keep torch's default.
* **Kernel launches travel with ``done``.**  The kernel wrappers count
  their launches in the process that makes them
  (:func:`repro_torch.kernels.launch_counts`); each ``done`` carries this
  worker's launches since its previous ``done`` (a forked worker's counts
  start from its parent's, so the first delta is taken against them).  The
  driver sums them into ``stats["kernel_launches"]``, so a run shows which
  kernels its workers launched, by route.  Launches of a super-task that
  failed or was cancelled ride on the next ``done``; those of a worker that
  dies before its next ``done`` are lost with it.  A run stopped at a
  member boundary (a speculation loser) reports the members it ran and
  their launches in its ``cancelled`` ack.  Each of these reports carries
  its number among this worker's reports, so that the driver counts a
  frame the channel delivered twice once.
* **No CUDA in a forked child** (Pitfall (b) of ROADMAP §1 item 3).  Once
  the driver has touched CUDA, a forked worker whose task touches it gets
  torch's "Cannot re-initialize CUDA in forked subprocess"; that is a task
  error like any other (an ``error`` reply, so the driver raises
  ``TaskFailed`` with torch's message), never a hang.  So once the driver
  has initialised CUDA, a config that names no start method spawns its
  workers (``repro_torch/cluster/executor.py``).

A worker is one OS process connected to the driver by a control-plane
*channel* (:mod:`repro_torch.cluster.channel`): a duplex pipe for forked/spawned
in-host workers, or a framed TCP stream for workers dialed in from other
hosts.  The worker body below is channel-agnostic — it sees only blocking
``recv()``/``send()`` with :class:`~repro_torch.cluster.channel.ChannelClosed`
as the "driver gone" signal.

Since the fusion pass (:mod:`repro_torch.core.fusion`) the unit of dispatch is a
**super-task**: one ``run`` message names a cluster id and the worker
executes every member task locally, in topo order, inside one Python
frame.  Intermediate member values never touch ``serde`` or the control
channel — only *kept* values (cluster outputs another cluster or the
driver will read) land in the local store.  With fusion off every cluster
is a single task and the behavior is exactly the pre-fusion worker.

It owns a *local object store* (``{tid: value}``) holding the kept results
of every cluster it has executed — plus, since the zero-copy data plane, a
replica of every transferred input it has resolved (reported back to the
driver in the ``done`` message so replica sets stay exact).  Bulk values do
not cross the control channel: a ``fetch`` is answered with a small
*handle* (:class:`~repro_torch.cluster.serde.Encoded` shared-memory refs, a
``PeerRef`` to this worker's unix/TCP socket server, or — on a TCP data
plane with same-host peers — a ``DualRef`` publishing both, letting each
consumer pick shm or socket by host id), and the consumer maps/pulls the
payload directly — worker-to-worker, driver untouched.

Message protocol (tuples; first element is the verb; ``cid`` is a cluster
id from the run's fusion plan — equal to the task id when fusion is off):

  driver -> worker
    ("run",   cid, extra)   execute super-task ``cid``; ``extra`` maps
                            input value tid -> transfer handle for external
                            inputs not already in this worker's store
    ("fetch", tid)          publish value ``tid`` and reply with its handle
    ("fetch_many", tids)    publish a batch (final collection): one
                            ``value_many`` reply carries every handle
    ("drop",  tids)         free stored values (driver-coordinated GC)
    ("cancel", cid)         a speculative twin of ``cid`` won elsewhere:
                            best-effort abort.  Idempotent — a queued run
                            of ``cid`` is skipped (acked ``cancelled``); a
                            run already executing completes and reports a
                            late ``done`` the driver reconciles; a cid
                            this worker never sees again is a no-op (the
                            mark is consumed by the next run or by the
                            super-task's own completion)
    ("batch", msgs)         a coalesced burst of the above (one frame /
                            syscall; unwrapped here, order preserved)
    ("hb",)                 keepalive (TCP channels; refreshes liveness)
    ("die",)                chaos hook: SIGKILL self (the driver cannot
                            signal a remote pid directly)
    ("stop",)               drain and exit

  worker -> driver
    ("done",    wid, cid, wall, sizes, replicated, launches, seq)
                            super-task finished; kept values stay local.
                            ``sizes`` maps kept member tid -> payload
                            bytes (locality-aware placement); ``replicated``
                            lists input value tids this worker now also
                            holds; ``launches`` maps kernel (and
                            kernel/route) -> launches since this worker's
                            previous report; ``seq`` numbers this
                            worker's reports of a run (``done`` and a
                            mid-run ``cancelled``: 0, 1, ...), so the
                            driver counts a frame that the channel
                            delivered twice once.
    ("error",   wid, cid, name, repr)    a member raised — surfaced as a
                            task error, never a worker death
    ("fetch_error", wid, tid, name, repr)  a fetch reply's VALUE could not
                            be serialized; a separate verb because value
                            tids and super-task ids are different
                            namespaces under fusion
    ("value",   wid, tid, found, handle) fetch reply (handle, not payload)
    ("value_many", wid, entries)         fetch_many reply: a list of
                            ``(tid, found, handle)`` triples in one frame
    ("deplost", wid, cid, deps)          transfer handles in a ``run`` could
                            not be resolved (owner died mid-transfer);
                            driver re-queues the super-task, recovers deps
    ("cancelled", wid, cid)              a queued run of ``cid`` was skipped
                            because a ``cancel`` (possibly stale) covered
                            it; the driver re-queues it if still wanted
    ("cancelled", wid, cid, replicated, wall, ran, launches, seq)
                            a run of ``cid`` stopped at a member boundary:
                            the inputs it materialized, the partial wall,
                            the member tids it ran and their launches
                            (numbered with the ``done`` frames)
    ("batch",   msgs)                    coalesced burst of the above (the
                            sender thread drains its outbox greedily)
    ("hb",)                              heartbeat (TCP channels)
    ("bye",     wid)                     explicit goodbye: clean shutdown,
                            never to be mistaken for a missed-heartbeat
                            death

Fork-started workers inherit the (closure-bearing, generally unpicklable)
:class:`~repro_torch.core.graph.TaskGraph` and the run's ``inputs`` dict by
memory copy; spawn-started and remote TCP workers receive them pickled
(via process args or the handshake's welcome frame) — the paper's "ship
the program to every node" step either way.  The run's
:class:`~repro_torch.core.fusion.WorkerFusionView` (cluster member lists + keep
sets, a few bytes per task) travels the same way, after which per-cluster
messages carry only ids and handles, independent of payload size.
"""
from __future__ import annotations

import itertools
import os
import pickle
import signal
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.core.executor import _run_node as run_node   # noqa: F401 — the
# worker executes nodes with the EXACT core implementation so both backends
# share semantics (including the MissingInput contract; the driver re-raises
# it by name on its side)
from repro_torch.core.fusion import WorkerFusionView
from repro_torch.core.graph import TaskGraph
from repro_torch.kernels import launch_counts

from . import serde
from .channel import (ChannelClosed, WorkerPipeEndpoint, host_id,
                      wrap_batch)

#: how many queued replies the sender thread folds into one batch frame
_SEND_BATCH = 64


def pipe_worker_main(wid: int, conn, graph: TaskGraph,
                     inputs: Optional[Dict[str, Any]],
                     transport: str = "driver",
                     shm_threshold: int = serde.SHM_THRESHOLD,
                     seg_prefix: str = "",
                     peer_dir: Optional[str] = None,
                     fusion: Optional[WorkerFusionView] = None,
                     fault_plan: Any = None,
                     fetch_retry: Any = None, *,
                     forked: bool = False) -> None:
    """Process entrypoint for pipe/spawn channel workers: wrap the raw
    duplex-pipe connection in the channel-agnostic endpoint and run.
    ``forked``: this process was started by ``fork``."""
    if forked:
        _single_thread()
    worker_main(wid, WorkerPipeEndpoint(conn), graph, inputs, transport,
                shm_threshold, seg_prefix, peer_dir, fusion=fusion,
                fault_plan=fault_plan, fetch_retry=fetch_retry)


def _single_thread() -> None:
    """Run torch's CPU ops on one thread in a forked worker (see the
    module docstring): OpenMP's pool is not usable after ``fork``."""
    import torch
    torch.set_num_threads(1)


def worker_main(wid: int, chan, graph: TaskGraph,
                inputs: Optional[Dict[str, Any]],
                transport: str = "driver",
                shm_threshold: int = serde.SHM_THRESHOLD,
                seg_prefix: str = "",
                peer_dir: Optional[str] = None,
                peer_host: str = "127.0.0.1",
                fusion: Optional[WorkerFusionView] = None,
                fault_plan: Any = None,
                fetch_retry: Any = None) -> None:
    """Worker body: reader thread + sender thread + compute loop, over any
    control channel ``chan`` (blocking ``recv``/``send`` endpoint).

    Deadlock-freedom argument (handles are small, but driver-transport
    payloads can still exceed the kernel pipe/socket buffer): the reader
    thread does *nothing but recv*, so the driver's blocking
    dispatch-sends always drain; the sender thread does *nothing but send*
    from an outbox queue, so neither the reader nor a long-running task can
    ever stall an outgoing reply; the driver's pump loop drains worker
    output whenever it isn't mid-send.  Any single blocked channel
    therefore unblocks without waiting on this process's compute.

    The reader answers ``fetch``/``drop`` directly (peers' input transfers
    are served while a task is running); ``run``/``stop`` are queued for
    the compute loop.  ``store`` accesses are single-op (GIL-atomic) dict
    operations.
    """
    import queue
    import threading
    import time

    # data-plane fault injection + retry policy for THIS process's peer
    # fetches (docs/faults.md).  Installed unconditionally: a forked worker
    # inherits the parent's process-global serde state, so a run without a
    # plan must actively clear whatever an earlier run installed.
    serde.set_fetch_fault(fault_plan.fetch_hook(wid)
                          if fault_plan is not None else None)
    serde.set_default_retry(fetch_retry)

    # resident-mode "graph" deltas mutate the inputs table in place, so a
    # None (no inputs) run still needs one real dict shared by the reader
    # closure and the compute loop
    inputs = dict(inputs) if inputs else {}

    store: Dict[int, Any] = {}
    published: Dict[int, serde.Handle] = {}     # memoized publish per tid
    cancelled: set = set()      # cids whose next queued run is to be skipped
    # (set add/discard are GIL-atomic: reader marks, compute loop consumes)
    keeper = serde.SegmentKeeper()      # pins zero-copy decoded mappings
    runq: "queue.SimpleQueue[tuple]" = queue.SimpleQueue()
    outq: "queue.SimpleQueue[Optional[tuple]]" = queue.SimpleQueue()
    namer = serde.SegmentNamer(f"{seg_prefix}w{wid}") if seg_prefix else None
    my_host = host_id()
    reported = launch_counts()      # a forked worker's start: its parent's

    def new_launches() -> Dict[str, int]:
        """Kernel launches since the last call (only the counts that moved)."""
        now = launch_counts()
        delta = {k: n - reported.get(k, 0) for k, n in now.items()
                 if n != reported.get(k, 0)}
        reported.update(now)
        return delta

    n_reports = itertools.count()   # the seq of this worker's next report

    if getattr(chan, "supports_rejoin", False):
        # Driver-restart re-adoption: the first frame on a rejoined socket
        # is this worker's object-store inventory, which the resumed
        # driver reconciles against its checkpoint.  The compute loop may
        # mutate the store mid-snapshot, hence the retry.
        def _inventory():
            snap: List[tuple] = []
            for _ in range(8):
                try:
                    snap = list(store.items())
                    break
                except RuntimeError:
                    continue
            return [(tid, serde.payload_nbytes(v)) for tid, v in snap]

        chan.inventory_fn = _inventory

    peer_server: Optional[serde.PeerServer] = None
    if transport == "sock" and peer_dir:
        try:
            peer_server = serde.PeerServer(
                os.path.join(peer_dir, f"w{wid}.sock"), store)
        except OSError:
            peer_server = None      # degrade to inline (driver) publishes
    elif transport == "tcp":
        try:
            peer_server = serde.PeerServer(None, store,
                                           advertise_host=peer_host)
        except OSError:
            peer_server = None

    # A DualRef's shm half lives on THIS machine, which the driver — the
    # usual unlink authority — cannot reach when this worker is on
    # another host, so the worker cleans up its own dual-published
    # segments: a driver-coordinated "drop" unlinks immediately (the
    # driver released its reference before sending the drop; idempotent
    # if it already unlinked on a single-host run, and a same-host
    # consumer caught mid-resolve falls back to the peer half), while a
    # mid-run re-publish merely *retires* the old handle — the driver may
    # still be shipping it — for the shutdown sweep.
    retired: List[serde.Handle] = []

    def unpublish(tid: int, now: bool) -> None:
        handle = published.pop(tid, None)
        if isinstance(handle, serde.DualRef):
            if now:
                serde.release(handle)
            else:
                retired.append(handle)

    def members_of(cid: int):
        if fusion is None:
            return (cid,)
        return fusion.members.get(cid, (cid,))

    def keep_of(cid: int):
        if fusion is None:
            return (cid,)
        return fusion.keep.get(cid, members_of(cid))

    def publish(tid: int) -> serde.Handle:
        """Produce (and memoize) the transfer handle for a stored value:
        shm-backed Encoded, a PeerRef to this worker's socket server, a
        DualRef publishing both (TCP data plane with shm available — the
        same-host fast path in mixed-host pools), or inline bytes for
        small values / driver transport."""
        handle = published.get(tid)
        if handle is not None:
            return handle
        value = store[tid]
        nbytes = serde.payload_nbytes(value)
        if peer_server is not None and nbytes >= shm_threshold:
            peer = serde.PeerRef(peer_server.path, tid, nbytes, wid,
                                 secret=peer_server.secret)
            handle = peer
            if (transport == "tcp" and namer is not None
                    and serde.shm_available()):
                # mixed-host tcp run: publish BOTH ways, consumers pick
                # by host id (same-host -> mmap, cross-host -> TCP pull)
                try:
                    handle = serde.DualRef(
                        serde.encode(value, transport="shm",
                                     threshold=shm_threshold, namer=namer),
                        peer, my_host)
                except Exception:   # shm full / shm_open denied for THIS
                    pass            # size: the peer half alone is the
                    # PR-3 behavior and always works — a fast path must
                    # never turn a publishable value into a run abort
        else:
            handle = serde.encode(
                value, transport="driver" if transport in ("sock", "tcp")
                else transport, threshold=shm_threshold, namer=namer)
        published[tid] = handle
        return handle

    def sender() -> None:
        """Drain the outbox; coalesce bursts into one batch frame (one
        pickle + one syscall) so a super-task finishing while fetch
        replies queue behind it costs a single write."""
        while True:
            msg = outq.get()
            if msg is None:
                return
            batch: List[tuple] = [msg]
            while len(batch) < _SEND_BATCH:
                try:
                    nxt = outq.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    _send_batch(batch)
                    return
                batch.append(nxt)
            _send_batch(batch)

    def _send_batch(batch: List[tuple]) -> None:
        try:
            wrapped = wrap_batch(batch)
            if wrapped is not None:
                chan.send(wrapped)
            return
        except ChannelClosed:
            return
        except Exception:
            pass        # fall through: isolate the poisoned message
        flat: List[tuple] = []  # unpicklable/oversized payload in a reply:
        for msg in batch:       # report it as a task error instead of
            # wedging the outbox (which would read as a dead worker).  A
            # value_many frame decomposes to per-value replies first, so
            # the fatal report names the exact poisoned value, not the
            # whole bulk reply
            if msg[0] == "value_many":
                flat.extend(("value", msg[1], t, found, handle)
                            for t, found, handle in msg[2])
            else:
                flat.append(msg)
        for msg in flat:
            try:
                chan.send(msg)
            except ChannelClosed:
                return
            except Exception as e:
                tid = msg[2] if len(msg) > 2 and isinstance(msg[2], int) \
                    else -1
                # a poisoned fetch reply carries a VALUE id; everything
                # else (done/deplost/...) names its super-task
                verb = "fetch_error" if msg[0] == "value" else "error"
                try:
                    chan.send((verb, wid, tid,
                               "SerializationError", repr(e)))
                except ChannelClosed:
                    return
                except Exception:
                    pass

    def handle_ctrl(msg: tuple) -> bool:
        """Reader-thread dispatch of one control message.  Returns False
        once the compute loop owns shutdown (``stop`` queued)."""
        verb = msg[0]
        if verb == "batch":
            for m in msg[1]:
                if not handle_ctrl(m):
                    return False
            return True
        if verb == "fetch":
            tid = msg[1]
            if tid not in store:
                outq.put(("value", wid, tid, False, None))
            else:
                try:
                    outq.put(("value", wid, tid, True, publish(tid)))
                except Exception as e:  # noqa: BLE001 — a value that
                    # cannot be serialized must surface on the consumer's
                    # future as a task error, not kill this worker.
                    # fetch_error, NOT error: this tid is a VALUE id, and
                    # under fusion the driver's error handler would read
                    # it as a cluster id and corrupt an unrelated
                    # super-task's runner bookkeeping
                    outq.put(("fetch_error", wid, tid,
                              "SerializationError", repr(e)))
        elif verb == "fetch_many":
            # bulk publication (final collection): one request, one reply
            # carrying every handle — the driver's per-value fetch loop
            # collapsed into a single round-trip per worker
            entries: List[tuple] = []
            for tid in msg[1]:
                if tid not in store:
                    entries.append((tid, False, None))
                    continue
                try:
                    entries.append((tid, True, publish(tid)))
                except Exception as e:  # noqa: BLE001 — same contract as
                    outq.put(("fetch_error", wid, tid,      # single fetch
                              "SerializationError", repr(e)))
            outq.put(("value_many", wid, entries))
        elif verb == "drop":
            for t in msg[1]:
                store.pop(t, None)
                unpublish(t, now=True)
        elif verb == "graph":
            # resident-mode job delta: the driver admitted (or retired) a
            # tenant job mid-run.  Admitted ids are disjoint from every id
            # already known (each job owns a private range) and retired
            # ids belong to terminal jobs whose runs were cancelled first,
            # so the compute loop can keep executing while these dicts
            # change — every mutation is a GIL-atomic dict op on keys the
            # loop is not touching.  The payload is pre-pickled once on
            # the driver and fanned out as bytes to every worker.
            delta = pickle.loads(msg[1])
            graph.nodes.update(delta.get("nodes", {}))
            inputs.update(delta.get("inputs", {}))
            if fusion is not None:
                fusion.members.update(delta.get("members", {}))
                fusion.keep.update(delta.get("keep", {}))
            for t in delta.get("retire", ()):
                graph.nodes.pop(t, None)
                store.pop(t, None)
                unpublish(t, now=True)
                cancelled.discard(t)
                if fusion is not None:
                    fusion.members.pop(t, None)
                    fusion.keep.pop(t, None)
            for name in delta.get("retire_inputs", ()):
                inputs.pop(name, None)
        elif verb == "cancel":
            # best-effort, between super-tasks: mark the cid; the compute
            # loop skips a queued run of it (a run already executing
            # finishes and the driver reconciles the late done)
            cancelled.add(msg[1])
        elif verb == "hb":
            pass                     # endpoint already refreshed liveness
        elif verb == "die":          # chaos hook for remote workers
            os.kill(os.getpid(), signal.SIGKILL)
        else:                        # "run" / "stop"
            runq.put(msg)
            if verb == "stop":
                return False
        return True

    def reader() -> None:
        while True:
            try:
                msg = chan.recv()
            except ChannelClosed:
                runq.put(("stop",))      # driver went away
                return
            if not handle_ctrl(msg):
                return

    send_thread = threading.Thread(target=sender, daemon=True,
                                   name=f"worker-{wid}-sender")
    send_thread.start()
    threading.Thread(target=reader, daemon=True,
                     name=f"worker-{wid}-reader").start()
    while True:
        msg = runq.get()
        verb = msg[0]
        if verb == "stop":
            if peer_server is not None:
                peer_server.close()
            # shutdown sweep for THIS host's dual-published segments: the
            # driver's run-prefix sweep only reaches its own /dev/shm
            for handle in retired:
                serde.release(handle)
            for handle in published.values():
                if isinstance(handle, serde.DualRef):
                    serde.release(handle)
            outq.put(("bye", wid))
            outq.put(None)
            send_thread.join(timeout=5.0)
            keeper.close()       # last mappings: safe, nothing runs after
            chan.close()
            return
        if verb != "run":                # pragma: no cover — protocol bug
            raise RuntimeError(f"worker {wid}: unknown message {verb!r}")
        _, cid, extra = msg
        if cid in cancelled:
            # the winner already finished elsewhere; the mark is consumed
            # so a FUTURE legitimate dispatch of the same cid (lineage
            # recovery after a GC) runs normally — and the ack lets the
            # driver re-queue if this run was in fact still wanted
            cancelled.discard(cid)
            outq.put(("cancelled", wid, cid))
            continue
        t0 = time.perf_counter()
        cur = None      # member being executed, for the error report —
        # bound BEFORE the resolve loop: a failure there must still reach
        # the except arm below, not die on an unbound name
        try:
            frame: Dict[int, Any] = {}   # this super-task's value table
            lost: List[int] = []
            replicated: List[int] = []
            for d, handle in extra.items():
                try:        # zero-copy: arrays view the mapped segment
                    frame[d] = serde.resolve(handle, keeper)
                except serde.TransferLost:
                    lost.append(d)
            if lost:
                # owner died (or GC raced) between dispatch and resolve:
                # hand the super-task back; the driver recovers the inputs
                outq.put(("deplost", wid, cid, lost))
                continue
            for d, v in frame.items():   # keep transferred inputs: replicas
                store[d] = v
                unpublish(d, now=False)
                replicated.append(d)
            # run every member locally, in topo order, in ONE frame:
            # intermediates live and die here — no store write, no
            # publish, no control message (the fusion win)
            aborted = False
            ran: List[int] = []
            for m in members_of(cid):
                if cid in cancelled:
                    # cooperative mid-task cancel: a speculation loser
                    # stops at the next member boundary instead of running
                    # the whole frame to completion.  Nothing from the
                    # aborted frame reaches the store; the ack carries the
                    # partial wall so the driver can account true waste.
                    aborted = True
                    break
                cur = m
                for d in graph.nodes[m].all_deps:
                    if d not in frame:
                        frame[d] = store[d]
                frame[m] = run_node(graph, m, frame, inputs)
                ran.append(m)
            cur = None
            if aborted:
                cancelled.discard(cid)
                outq.put(("cancelled", wid, cid, replicated,
                          time.perf_counter() - t0, ran, new_launches(),
                          next(n_reports)))
                continue
            sizes: Dict[int, int] = {}
            for m in keep_of(cid):
                store[m] = frame[m]
                unpublish(m, now=False)  # recompute invalidates old handle
                sizes[m] = serde.payload_nbytes(frame[m])
            # a cancel that raced the execution is moot now — consume the
            # mark so it cannot eat a future re-dispatch of this cid
            cancelled.discard(cid)
            outq.put(("done", wid, cid, time.perf_counter() - t0,
                      sizes, replicated, new_launches(), next(n_reports)))
        except BaseException as e:       # noqa: BLE001 — shipped to driver
            cancelled.discard(cid)
            detail = repr(e)
            if cur is not None and cur != cid:
                # a fused super-task failed: name the MEMBER that raised,
                # so the error reads the same as an unfused run's would
                detail += (f" (in member task "
                           f"{graph.nodes[cur].name}#{cur})")
            outq.put(("error", wid, cid, type(e).__name__, detail))


def tcp_worker_main(address: str, *,
                    token: Optional[str] = None,
                    graph: Optional[TaskGraph] = None,
                    inputs: Optional[Dict[str, Any]] = None,
                    timeout: float = 30.0,
                    close_fds: Sequence[int] = ()) -> int:
    """Process entrypoint for TCP-channel workers (local forked dialers and
    the ``repro-worker`` CLI alike): dial the driver at ``address``,
    handshake, and run :func:`worker_main` with the negotiated identity and
    run config.

    A worker launched with ``graph`` already in hand (forked locally, graph
    inherited) advertises ``has_graph=True`` and the driver skips shipping
    it; a bare remote worker receives the pickled ``(graph, inputs)`` pair
    in the welcome frame.  The run's fusion view rides the welcome config
    either way.  Returns the assigned worker id.
    """
    import pickle

    from .channel import dial_driver

    # a fork-started dialer inherits the DRIVER's open fds — most fatally
    # its listening socket, which would keep the port bound after a driver
    # SIGKILL and block the restarted driver's re-bind.  The driver names
    # the fds the child must not hold; close them before anything else.
    for fd in close_fds:
        try:
            os.close(fd)
        except OSError:
            pass
    if graph is not None:        # only a forked dialer inherits the graph
        _single_thread()
    endpoint, wid, config, graph_blob = dial_driver(
        address, token=token, has_graph=graph is not None, timeout=timeout)
    if graph is None:
        if graph_blob is None:
            raise ChannelClosed(
                "driver sent no graph to a worker that has none")
        graph, inputs = pickle.loads(graph_blob)
    worker_main(wid, endpoint, graph, inputs,
                transport=config.get("transport", "driver"),
                shm_threshold=config.get("shm_threshold",
                                         serde.SHM_THRESHOLD),
                seg_prefix=config.get("seg_prefix", ""),
                peer_dir=config.get("peer_dir"),
                peer_host=config.get("peer_host", "127.0.0.1"),
                fusion=config.get("fusion"),
                fault_plan=config.get("fault_plan"),
                fetch_retry=config.get("fetch_retry"))
    return wid
