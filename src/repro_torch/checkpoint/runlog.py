"""Append-only run log: the driver's durable control-plane state.

Port of ``repro/checkpoint/runlog.py``, unchanged: the run log is plain Python.

The :class:`ClusterExecutor` driver keeps all ownership metadata — which
worker holds which value, per-value sizes, refcounts, the execution
frontier — in its own heap.  PRs 1-5 made *worker* death survivable via
lineage; this module makes *driver* death survivable by journaling that
metadata as it changes.

Design constraints, in order:

1. **Hot-path cost must be flat in worker count.**  Records are deltas
   keyed by *events* (a cluster completed, a handle became durable), not
   snapshots of per-worker state.  A 64-worker run writes the same number
   of bytes per completion as a 2-worker run.
2. **SIGKILL-safe.**  The log is append-only, length-prefixed, and
   fsync'd on a timer.  A driver killed mid-write leaves at most one
   *torn tail* record, which the loader detects and truncates; a driver
   killed between flushes loses at most ``interval`` seconds of claims.
   Claims are monotone over a *pure* graph — a stale claim is reconciled
   against worker inventory at resume and replayed via lineage, never
   trusted blindly — so losing the tail is a performance cost, not a
   correctness one.
3. **No heavyweight deps.**  Unlike the reference's array-tree store
   (``repro/checkpoint/store.py``), the run log is pickled control
   metadata only; workers and the resume path must be able to import it
   without pulling in an accelerator runtime.

Record kinds (a tuple per record, first element the kind tag):

=========  ===============================================================
``begin``  ``(meta,)`` — run identity: graph/plan fingerprints, fuse
           spec, listener address, channel, seg prefix.  Always first.
``resume`` ``(meta,)`` — a new driver incarnation appended to the log;
           carries its fresh ``seg_prefix`` so every incarnation's shm
           segments can be swept at final shutdown.
``worker`` ``(wid, host)`` — a worker was adopted (or re-adopted).
``dead``   ``(wid,)`` — a worker's loss was confirmed and recovered.
``done``   ``(cid, wid, sizes)`` — cluster ``cid`` completed on ``wid``
           producing ``{tid: nbytes}``.  The hot-path record.
``redo``   ``(cids,)`` — recovery demoted these clusters; their ``done``
           claims are retracted.
``refuse`` ``(retired, clusters)`` — adaptive re-fusion replaced the
           not-yet-dispatched ``retired`` cluster ids with ``clusters``
           (``(cid, member_tids)`` pairs).  Replayed in order on resume
           so journaled ``done`` claims of post-refusion cids resolve
           against the same plan that produced them (docs/adaptive.md).
``gc``     ``(tids,)`` — values dropped by the consumed-refcount GC.
``live``   ``(tids,)`` — recovery retracted GC marks; the values are
           being recomputed and are no longer "gone everywhere".
``hnd``    ``(tid, handle_bytes)`` — a *durable* handle (inline bytes or
           an shm segment that outlives the driver) for ``tid``.
``val``    ``(tid, value_bytes)`` — a driver-cached value (barrier
           results, collected finals) spilled into the log itself.
``session``  ``(tenant, info)`` — a gateway tenant session opened (or its
           quotas changed); ``info`` carries the quota/config dict.  A
           resumed gateway re-creates these sessions so clients reconnect
           into their old identity.
``sessionend``  ``(tenant,)`` — the session was closed by the client.
``job``    ``(job_id, info)`` — a tenant job was admitted into the
           resident run; ``info`` records tenant, id base and size.
``jobdone``  ``(job_id,)`` — the job finished (collected or failed) and
           its id range was retired.
=========  ===============================================================

Loaders skip unknown kinds (forward compatibility), so logs carrying the
gateway records stay readable by older tooling.
"""
from __future__ import annotations

import hashlib
import io
import os
import pickle
import struct
import time
from typing import Any, Dict, List, Optional, Set, Tuple

_LEN = struct.Struct(">I")

__all__ = ["RunLog", "RunState", "load_run", "latest_run",
           "graph_fingerprint", "plan_fingerprint"]


# --------------------------------------------------------------- identity

def graph_fingerprint(graph) -> str:
    """Stable digest of the task graph's *shape* (names + dependency
    structure + kinds).  Function bodies are deliberately excluded: a
    resumed driver re-imports the same code, and pickling closures here
    would make fingerprints fragile across interpreter runs."""
    h = hashlib.sha1()
    for tid in sorted(graph.nodes):
        n = graph.nodes[tid]
        h.update(repr((tid, n.name, tuple(n.all_deps),
                       getattr(n.kind, "name", str(n.kind)))).encode())
    h.update(repr(sorted(graph.outputs)).encode())
    return h.hexdigest()


def plan_fingerprint(plan) -> str:
    """Digest of the fused plan: cluster membership and the cluster DAG.
    Fusion is deterministic, so a resumed driver with the same graph and
    fuse spec reproduces this exactly — a mismatch means the checkpoint's
    cluster ids don't mean what we think they mean."""
    h = hashlib.sha1()
    for cid in sorted(plan.members):
        deps = tuple(sorted(plan.cgraph.nodes[cid].all_deps))
        h.update(repr((cid, tuple(plan.members[cid]), deps)).encode())
    return h.hexdigest()


# ------------------------------------------------------------------ writer

class RunLog:
    """Buffered append-only writer with timed fsync.

    ``append()`` is called from the driver's dispatch hot path and only
    pickles into an in-memory buffer; ``maybe_flush()`` is called from
    the pump loop and pays the write+fsync at most once per
    ``interval`` seconds (or when the buffer grows past ``max_buffer``).
    """

    def __init__(self, path: str, interval: float = 0.25,
                 max_buffer: int = 1 << 20):
        self.path = path
        self.interval = interval
        self.max_buffer = max_buffer
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "ab")
        self._buf = io.BytesIO()
        self._last_flush = time.monotonic()
        self.bytes_written = 0
        self.n_records = 0

    def append(self, *record: Any) -> None:
        payload = pickle.dumps(record, protocol=pickle.HIGHEST_PROTOCOL)
        self._buf.write(_LEN.pack(len(payload)))
        self._buf.write(payload)
        self.n_records += 1

    def maybe_flush(self, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        if self._buf.tell() == 0:
            return False
        if (now - self._last_flush < self.interval
                and self._buf.tell() < self.max_buffer):
            return False
        self.flush()
        return True

    def flush(self) -> None:
        data = self._buf.getvalue()
        if data:
            self._f.write(data)
            self._f.flush()
            os.fsync(self._f.fileno())
            self.bytes_written += len(data)
            self._buf = io.BytesIO()
        self._last_flush = time.monotonic()

    def close(self) -> None:
        try:
            self.flush()
        finally:
            self._f.close()


# ------------------------------------------------------------------ loader

class RunState:
    """Replayed view of a run log: the last-known control-plane state."""

    def __init__(self) -> None:
        self.meta: Dict[str, Any] = {}
        self.seg_prefixes: List[str] = []
        self.workers: Dict[int, str] = {}          # wid -> host
        self.dead: Set[int] = set()
        self.done: Dict[int, Tuple[int, Dict[int, int]]] = {}
        self.dropped: Set[int] = set()
        self.handles: Dict[int, bytes] = {}        # tid -> pickled handle
        self.values: Dict[int, bytes] = {}         # tid -> pickled value
        self.sessions: Dict[str, Dict[str, Any]] = {}   # tenant -> quotas
        self.jobs: Dict[int, Dict[str, Any]] = {}  # in-flight admitted jobs
        # adaptive re-fusion decisions, in journal order: each entry is
        # (retired_cids, ((cid, member_tids), ...)) — replayed through
        # fusion.splice_plan before the resume frontier is seeded
        self.refusions: List[Tuple[Tuple[int, ...], Tuple]] = []
        self.truncated = False                     # torn tail was cut
        self.n_records = 0

    @property
    def live_workers(self) -> Dict[int, str]:
        return {w: h for w, h in self.workers.items() if w not in self.dead}

    def apply(self, record: Tuple[Any, ...]) -> None:
        kind = record[0]
        if kind == "begin":
            self.meta = dict(record[1])
            self.seg_prefixes.append(self.meta["seg_prefix"])
        elif kind == "resume":
            self.seg_prefixes.append(record[1]["seg_prefix"])
        elif kind == "worker":
            self.workers[record[1]] = record[2]
            self.dead.discard(record[1])
        elif kind == "dead":
            self.dead.add(record[1])
        elif kind == "done":
            self.done[record[1]] = (record[2], dict(record[3]))
        elif kind == "redo":
            for cid in record[1]:
                self.done.pop(cid, None)
        elif kind == "refuse":
            self.refusions.append((tuple(record[1]), tuple(record[2])))
        elif kind == "gc":
            self.dropped.update(record[1])
        elif kind == "live":
            # recovery retracted GC marks: these values are being
            # recomputed, so a resume must not treat them as swept
            self.dropped.difference_update(record[1])
        elif kind == "hnd":
            self.handles[record[1]] = record[2]
        elif kind == "val":
            self.values[record[1]] = record[2]
        elif kind == "session":
            self.sessions[record[1]] = dict(record[2])
        elif kind == "sessionend":
            self.sessions.pop(record[1], None)
        elif kind == "job":
            self.jobs[record[1]] = dict(record[2])
        elif kind == "jobdone":
            self.jobs.pop(record[1], None)
        # unknown kinds are skipped: forward compatibility
        self.n_records += 1


def load_run(path: str, repair: bool = True) -> RunState:
    """Replay ``path`` into a :class:`RunState`, truncating a torn tail.

    A driver SIGKILL'd mid-``flush`` can leave a partial final record
    (short length prefix, short payload, or an unpicklable payload).
    Everything before the tear is intact — the file is append-only — so
    the loader keeps the longest clean prefix and (when ``repair``)
    truncates the file to it, making the next append well-formed.
    """
    state = RunState()
    good = 0
    with open(path, "rb") as f:
        while True:
            head = f.read(_LEN.size)
            if len(head) < _LEN.size:
                state.truncated = bool(head)
                break
            (n,) = _LEN.unpack(head)
            payload = f.read(n)
            if len(payload) < n:
                state.truncated = True
                break
            try:
                record = pickle.loads(payload)
            except Exception:
                state.truncated = True
                break
            state.apply(record)
            good = f.tell()
    if state.truncated and repair:
        with open(path, "r+b") as f:
            f.truncate(good)
    if not state.meta:
        raise ValueError(f"run log {path!r} has no intact 'begin' record")
    return state


def latest_run(checkpoint_dir: str) -> Optional[str]:
    """Most recently modified run id under ``checkpoint_dir``."""
    best, best_t = None, -1.0
    try:
        names = os.listdir(checkpoint_dir)
    except FileNotFoundError:
        return None
    for name in names:
        if not name.endswith(".log"):
            continue
        t = os.path.getmtime(os.path.join(checkpoint_dir, name))
        if t > best_t:
            best, best_t = name[:-4], t
    return best
