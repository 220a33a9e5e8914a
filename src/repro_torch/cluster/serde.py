"""Zero-copy serde for the cluster data plane.

Port of ``repro/cluster/serde.py``.  What is the port's own is how torch
tensors cross (Pitfall (a) of ROADMAP §1 item 3):

* **Torch tensors skip pickle-5's out-of-band path on their own**: torch
  pickles a tensor's storage in-band, so a 4 MiB tensor would travel as a
  4 MiB pickle stream.  :func:`encode` therefore pickles with
  :class:`_Pickler`, whose ``reducer_override`` turns every strided tensor
  into a ``PickleBuffer`` of its host bytes plus dtype, shape and device
  (:func:`_reduce_tensor`), so the body takes the same out-of-band,
  shared-memory path as a numpy array's and the stream stays a few hundred
  bytes.  Every dtype crosses as its raw bytes, so bf16 arrives bit for
  bit (the bits interop.py carries through a ``uint16`` view).
* **Values cross processes as host bytes; CUDA IPC is not used.**  A CUDA
  tensor is copied to the host inside :func:`encode` (that copy is part of
  the bytes the ``bytes_*`` stats count) and :func:`_rebuild_tensor`
  copies it back onto the device it came from.
* **A decoded CPU tensor keeps its bytes alive.**  ``torch.frombuffer``
  holds a reference to the buffer it views: a copying decode hands it a
  private ``bytearray``, and a zero-copy decode a mapping that the
  :class:`SegmentKeeper` pins for the life of the process, so a tensor
  never outlives the memory under it.

PR-1 moved every cross-worker value through the driver as a double-pickled
pipe payload (worker → driver pipe → driver → consumer pipe): four
serialization copies plus two kernel pipe traversals per transfer.  This
module replaces the *payload* path with handle passing:

* :func:`encode` serializes a task value with **pickle protocol 5** and
  captures its out-of-band buffers (numpy array and tensor bodies).
  Buffers at or above ``threshold`` are written once into a
  :mod:`multiprocessing.shared_memory` segment; the returned
  :class:`Encoded` carries only the pickle *stream* and
  :class:`ShmRef` handles, so what crosses the driver pipe is a few hundred
  bytes regardless of payload size.  Large non-array payloads (big
  ``bytes``, deeply pickled objects) are covered too: when the pickle
  stream itself exceeds the threshold it is spilled to a segment as well.
* :func:`decode` attaches the named segments, materializes a
  process-private copy, and unmaps.  Consumers therefore never hold a
  mapping after decode, which is what lets the driver unlink segments the
  moment refcounts drain (``consumers_left`` GC) without use-after-unmap
  hazards — the crash-safety property the kill-mid-transfer tests pin.
* :class:`PeerRef` + :class:`PeerServer` are the fallback channel when
  POSIX shared memory is unavailable: every worker binds a unix-domain
  socket and serves its local store; a consumer resolves a ``PeerRef`` by
  connecting to the owner directly.  Bytes still bypass the driver pipe.

Ownership/lifecycle contract: the **driver is the single unlink
authority**.  Creating or attaching a segment immediately unregisters it
from this process's ``resource_tracker`` (which would otherwise unlink
segments at the *creator's* exit — exactly wrong when a worker produces a
segment the driver must outlive).  The driver unlinks via
:func:`release` when a value's refcount drains, and sweeps any orphans by
run-scoped name prefix (:func:`sweep_segments`) on exit, so a SIGKILL'd
worker can never leak ``/dev/shm`` entries past the run.
"""
from __future__ import annotations

import glob
import io
import os
import pickle
import socket
import struct
import sys
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Union

import torch

SHM_THRESHOLD = 1 << 16     # buffers >= 64 KiB go out-of-band to /dev/shm
_SHM_DIR = "/dev/shm"       # POSIX shm backing dir (Linux); probed, not assumed

TRANSPORTS = ("auto", "shm", "sock", "tcp", "driver")

#: transports whose handles resolve across host boundaries.  Shm segments
#: and unix sockets are host-local; TCP peer pulls and driver-relayed
#: inline bytes work anywhere the control plane reaches.
CROSS_HOST_TRANSPORTS = ("auto", "tcp", "driver")


class TransferLost(RuntimeError):
    """A handle could not be resolved (segment unlinked / peer gone).

    This is a *recoverable* data-plane failure: the caller treats the value
    as lost and falls back to lineage recovery, exactly like a worker death.

    ``retryable`` distinguishes transient failures (connect refused,
    timeout, truncated stream — the owner may just be busy or the network
    flaky) from definitive ones (the owner answered and said it no longer
    holds the value): :func:`peer_fetch` retries only the former.
    """

    retryable = True


# --------------------------------------------------------------------- refs
@dataclass(frozen=True)
class ShmRef:
    """Name + length of one shared-memory segment (picklable, ~100 B)."""
    name: str
    nbytes: int


@dataclass(frozen=True)
class PeerRef:
    """Handle to a value held in a peer worker's store, reachable over that
    worker's socket server: ``addr`` is a unix-socket path, or
    ``tcp://host:port`` for the multi-host data plane.  NOT durable —
    dies with the owning process.

    ``secret`` is a per-server capability for the TCP family: the server
    only answers requests that present it, and the only way to learn it is
    to receive a PeerRef over the (token-gated) control channel — so an
    open network port does not expose task values to port scanners.  Unix
    servers rely on filesystem permissions instead and leave it empty."""
    addr: str
    tid: int
    nbytes: int
    wid: int
    secret: str = ""


@dataclass
class Encoded:
    """A serialized value: pickle stream + out-of-band buffers, each either
    inline ``bytes`` (small) or a :class:`ShmRef` (large, zero-copy path).
    Durable: inline parts live wherever the object lives; shm parts live in
    tmpfs and survive the death of the process that wrote them."""
    data: Union[bytes, ShmRef]
    buffers: List[Union[bytes, ShmRef]] = field(default_factory=list)
    nbytes: int = 0             # total payload size (for stats/placement)

    def pipe_nbytes(self) -> int:
        """Bytes this object adds to a driver-pipe message."""
        n = 64 if isinstance(self.data, ShmRef) else len(self.data)
        for b in self.buffers:
            n += 64 if isinstance(b, ShmRef) else len(b)
        return n

    def direct_nbytes(self) -> int:
        """Bytes moved out-of-band through shared memory."""
        n = self.data.nbytes if isinstance(self.data, ShmRef) else 0
        for b in self.buffers:
            if isinstance(b, ShmRef):
                n += b.nbytes
        return n

    def shm_refs(self) -> List[ShmRef]:
        refs = [self.data] if isinstance(self.data, ShmRef) else []
        refs.extend(b for b in self.buffers if isinstance(b, ShmRef))
        return refs


@dataclass(frozen=True)
class DualRef:
    """Same-host shm fast path inside a mixed-host ``transport="tcp"``
    run: the owner publishes the value BOTH ways — a shared-memory
    :class:`Encoded` (zero-copy for consumers on the owner's machine) and
    a :class:`PeerRef` (TCP pull for everyone else) — and the *consumer*
    picks by host id.  Without this, two workers sharing a machine in a
    multi-host pool would move bytes through the TCP loopback even though
    tmpfs is a ``mmap`` away (the open item from PR 3).

    NOT durable for loss accounting: the shm half outlives the owner, but
    only on ``host`` — a cross-host consumer cannot reach it once the
    peer server is gone, and host-scoped durability would poison the
    driver's "durable ⇒ recoverable from anywhere" recovery contract.
    Treating it like a :class:`PeerRef` is conservative (same-host
    survivors merely recompute a value they could have mapped)."""
    shm: Encoded
    peer: PeerRef
    host: str           # machine id (channel.host_id) holding the segment


Handle = Union[Encoded, PeerRef, DualRef]


def is_durable(handle: Handle) -> bool:
    """Durable handles survive the owning worker's death (driver memory or
    tmpfs); a PeerRef is only as alive as its worker, and a DualRef's shm
    half is host-scoped (see :class:`DualRef`)."""
    return isinstance(handle, Encoded)


def pipe_nbytes(handle: Handle) -> int:
    if isinstance(handle, Encoded):
        return handle.pipe_nbytes()
    if isinstance(handle, DualRef):
        return handle.shm.pipe_nbytes() + 64
    return 64


def direct_nbytes(handle: Handle) -> int:
    if isinstance(handle, Encoded):
        return handle.direct_nbytes()
    if isinstance(handle, DualRef):
        return handle.peer.nbytes
    return handle.nbytes


# ------------------------------------------------------------ shm plumbing
def _untrack(seg) -> None:
    """Remove ``seg`` from this process's resource_tracker: lifecycle is
    driver-owned, and the tracker would otherwise unlink at *this*
    process's exit (CPython registers on both create and attach)."""
    try:
        from multiprocessing import resource_tracker
        resource_tracker.unregister(getattr(seg, "_name", seg.name),
                                    "shared_memory")
    except Exception:
        pass


_SHM_OK: Optional[bool] = None


def shm_available() -> bool:
    """Probe (once) whether POSIX shared memory works in this environment
    (containers sometimes mount no /dev/shm, or deny shm_open)."""
    global _SHM_OK
    if _SHM_OK is None:
        try:
            from multiprocessing.shared_memory import SharedMemory
            probe = SharedMemory(create=True, size=1,
                                 name=f"rrprobe{os.getpid():x}"
                                      f"{uuid.uuid4().hex[:6]}")
            probe.unlink()      # unlink() also unregisters from the tracker
            probe.close()
            _SHM_OK = True
        except Exception:
            _SHM_OK = False
    return _SHM_OK


def resolve_transport(transport: str, multihost: bool = False) -> str:
    """Map ``auto`` to the best channel this deployment supports.

    ``multihost=True`` means at least one worker may live on another
    machine: shm segments and unix sockets do not exist over there, so
    ``auto`` resolves to ``tcp`` and explicitly asking for a host-local
    transport is a clear error instead of a cross-host resolve failure.
    """
    if transport not in TRANSPORTS:
        raise ValueError(f"unknown transport {transport!r} "
                         f"(expected one of {TRANSPORTS})")
    if multihost and transport not in CROSS_HOST_TRANSPORTS:
        raise ValueError(
            f"transport {transport!r} is host-local (shm segments / unix "
            f"sockets cannot cross machines); multi-host runs support "
            f"{CROSS_HOST_TRANSPORTS}")
    if transport != "auto":
        return transport
    if multihost:
        return "tcp"
    if shm_available():
        return "shm"
    if hasattr(socket, "AF_UNIX"):
        return "sock"
    return "driver"


class SegmentNamer:
    """Generates unique, run-scoped segment names (``<prefix>_<n>``) so the
    driver can sweep every segment of a run by glob, even orphans whose
    creating worker was SIGKILL'd before reporting the handle."""

    def __init__(self, prefix: str) -> None:
        self.prefix = prefix
        self._n = 0
        self._lock = threading.Lock()

    def __call__(self) -> str:
        with self._lock:
            self._n += 1
            return f"{self.prefix}_{self._n}"


def _write_segment(mv: memoryview, name: str) -> ShmRef:
    from multiprocessing.shared_memory import SharedMemory
    seg = SharedMemory(create=True, size=max(1, mv.nbytes), name=name)
    _untrack(seg)
    seg.buf[:mv.nbytes] = mv
    seg.close()
    return ShmRef(name, mv.nbytes)


def _read_segment(ref: ShmRef) -> bytearray:
    from multiprocessing.shared_memory import SharedMemory
    try:
        seg = SharedMemory(name=ref.name)
    except (FileNotFoundError, OSError) as e:
        raise TransferLost(f"shm segment {ref.name} gone: {e!r}") from e
    _untrack(seg)
    try:
        # bytearray keeps copy-decoded arrays writable (backend parity)
        return bytearray(seg.buf[:ref.nbytes])
    finally:
        seg.close()


def _unlink_ref(ref: ShmRef) -> None:
    path = os.path.join(_SHM_DIR, ref.name)
    try:
        os.unlink(path)
        return
    except FileNotFoundError:
        return
    except OSError:
        pass
    try:            # non-Linux fallback: attach + unlink through the API
        from multiprocessing.shared_memory import SharedMemory
        seg = SharedMemory(name=ref.name)   # attach registers; unlink()
        seg.unlink()                        # unregisters — tracker balanced
        seg.close()
    except Exception:
        pass


def release(handle: Optional[Handle]) -> None:
    """Driver-side: free a handle's shared-memory segments (idempotent)."""
    if isinstance(handle, DualRef):
        handle = handle.shm
    if isinstance(handle, Encoded):
        for ref in handle.shm_refs():
            _unlink_ref(ref)


def sweep_segments(prefix: str) -> int:
    """Unlink every ``/dev/shm`` segment of a run (by name prefix).  Run at
    driver exit: catches orphans from workers killed mid-publish, whose
    handles never reached the driver.  Returns the number unlinked."""
    if not prefix or not os.path.isdir(_SHM_DIR):
        return 0
    n = 0
    for path in glob.glob(os.path.join(_SHM_DIR, glob.escape(prefix) + "*")):
        try:
            os.unlink(path)
            n += 1
        except OSError:
            pass
    return n


def _segment_owner_pid(name: str) -> Optional[int]:
    """Parse the *driver* pid embedded in a run-scoped segment name.

    Run prefixes are ``rr{driver_pid:x}{8 uuid hex}`` (see the executor's
    ``seg_prefix``); namers append ``d``/``w<wid>`` and a ``_<n>``
    counter, bare :func:`encode` calls append nothing.  The pid and uuid
    halves are both hex, so the split anchors on structure: ``w`` is not
    a hex digit, ``d``-suffixed names always carry a ``_<n>`` counter,
    and the uuid half is exactly 8 chars.  Unparseable names return
    ``None`` — the sweep must never guess.
    """
    if not name.startswith("rr"):
        return None
    rest = name[2:]
    if "w" in rest:                     # rr<pid><uuid8>w<wid>_<n>
        head = rest.split("w", 1)[0]
    elif "_" in rest:                   # rr<pid><uuid8>d_<n>
        head = rest.split("_", 1)[0]
        if not head.endswith("d"):
            return None
        head = head[:-1]
    else:                               # rr<pid><uuid8>  (bare encode)
        head = rest
    if len(head) <= 8:
        return None
    try:
        pid = int(head[:-8], 16)
    except ValueError:
        return None
    # kernel pid_max tops out at 2**22; anything bigger is a foreign file
    # whose name happens to be hex, and os.kill(huge, 0) would raise
    # OverflowError instead of answering the liveness question
    return pid if 0 < pid < (1 << 22) else None


# ------------------------------------------------------------ resume leases
# A checkpointed run's segments must survive the driver's death for the
# rejoin window — they are the resume's recovery inputs.  A dead driver
# pid alone is therefore NOT license to sweep: the driver leaves a lease
# file next to the segments (refreshed while it runs) and the startup
# sweep honors any lease still inside its window.  Lease names start with
# a dot so the run-prefix globs (``rr*``) never see them.
_LEASE_PREFIX = ".rrlease-"
#: slack added to a lease's window: covers the gap between the driver's
#: last refresh and its death, plus resume/rejoin handshake time
LEASE_MARGIN = 30.0


def _lease_path(seg_prefix: str, shm_dir: Optional[str] = None) -> str:
    return os.path.join(_SHM_DIR if shm_dir is None else shm_dir,
                        _LEASE_PREFIX + seg_prefix)


def write_resume_lease(seg_prefix: str, run_id: str, window: float,
                       shm_dir: Optional[str] = None) -> Optional[str]:
    """Declare ``seg_prefix`` resumable: segments under it stay protected
    from the startup sweep until ``window + LEASE_MARGIN`` seconds after
    the lease's last refresh.  Returns the lease path (None if the shm
    dir does not exist — nothing to protect there)."""
    path = _lease_path(seg_prefix, shm_dir)
    try:
        with open(path, "w") as f:
            f.write(f"{run_id} {window:.1f}\n")
        return path
    except OSError:
        return None


def refresh_resume_lease(seg_prefix: str,
                         shm_dir: Optional[str] = None) -> None:
    """Bump the lease's clock (its mtime): the rejoin window counts from
    the driver's *death*, which is unknowable in advance, so the live
    driver keeps the lease fresh and the window effectively measures
    silence since the last refresh."""
    try:
        os.utime(_lease_path(seg_prefix, shm_dir))
    except OSError:
        pass


def clear_resume_lease(seg_prefix: str,
                       shm_dir: Optional[str] = None) -> None:
    """Clean shutdown: the run is over, its segments are swept, the lease
    goes with them (idempotent)."""
    try:
        os.unlink(_lease_path(seg_prefix, shm_dir))
    except OSError:
        pass


def _live_leases(shm_dir: str) -> List[str]:
    """Prefixes under an unexpired lease; expired lease files are reaped
    in passing."""
    now = time.time()
    live: List[str] = []
    for path in glob.glob(os.path.join(shm_dir, _LEASE_PREFIX + "*")):
        prefix = os.path.basename(path)[len(_LEASE_PREFIX):]
        window = 60.0
        try:
            with open(path) as f:
                parts = f.read().split()
            if len(parts) >= 2:
                window = float(parts[1])
            mtime = os.stat(path).st_mtime
        except (OSError, ValueError):
            continue                    # unreadable: keep it, protect it
        if now - mtime <= window + LEASE_MARGIN:
            live.append(prefix)
        else:
            try:
                os.unlink(path)         # expired: the run is not coming back
            except OSError:
                pass
    return live


def sweep_stale_segments(shm_dir: Optional[str] = None) -> int:
    """Startup sweep of ``rr*`` segments whose owning run is dead.

    A SIGKILL'd worker (or an emulated-crash driver) never runs its
    shutdown sweep, so its run's segments leak in ``/dev/shm`` until the
    *next* ``repro-worker`` on the host starts and calls this.  Scoped
    strictly to dead, non-resumable runs, on two independent tests:

    * **pid** — a segment is removed only when its name parses to a run
      prefix whose embedded driver pid no longer exists (an unparseable
      name or a live, even recycled, pid keeps the segment);
    * **lease** — a dead pid whose run left an unexpired resume lease
      (:func:`write_resume_lease`) is a *resumable* run inside its rejoin
      window: its segments are the resume's recovery inputs and are kept.
      This closes the race where a ``repro-worker`` starting on the
      driver's host swept a just-killed checkpointed run's segments
      moments before the resumed driver re-adopted them.

    Returns the number of segments unlinked.
    """
    shm_dir = _SHM_DIR if shm_dir is None else shm_dir
    if not os.path.isdir(shm_dir):
        return 0
    leased = _live_leases(shm_dir)
    n = 0
    for path in glob.glob(os.path.join(shm_dir, "rr*")):
        name = os.path.basename(path)
        pid = _segment_owner_pid(name)
        if pid is None or pid <= 0:
            continue
        if any(name.startswith(p) for p in leased):
            continue                    # resumable run inside its window
        try:
            os.kill(pid, 0)
            continue                    # owner alive: not ours to touch
        except ProcessLookupError:
            pass                        # owner dead: stale residue
        except OSError:
            continue                    # EPERM etc: owner exists, skip
        try:
            os.unlink(path)
            n += 1
        except OSError:
            pass
    return n


def sweep_peer_sockets(peer_dir: Optional[str]) -> int:
    """Remove a run's :class:`PeerServer` unix-socket files and their
    tmpdir.  Part of the same shutdown sweep as :func:`sweep_segments`: a
    SIGKILL'd worker never runs ``PeerServer.close``, so its ``w<id>.sock``
    would otherwise outlive the run in the tmpdir.  Returns the number of
    socket files removed (idempotent; a missing dir is fine)."""
    if not peer_dir or not os.path.isdir(peer_dir):
        return 0
    n = 0
    for name in os.listdir(peer_dir):
        if not name.endswith(".sock"):
            continue
        try:
            os.unlink(os.path.join(peer_dir, name))
            n += 1
        except OSError:
            pass
    try:
        os.rmdir(peer_dir)
    except OSError:          # non-socket stragglers: take the dir anyway
        import shutil
        shutil.rmtree(peer_dir, ignore_errors=True)
    return n


# ------------------------------------------------------------ encode/decode
def _reduce_tensor(t: torch.Tensor) -> tuple:
    """Reduce a strided tensor to its host bytes (one ``PickleBuffer``,
    out-of-band under protocol 5) plus dtype, shape and device.  A CUDA
    tensor is copied to the host here."""
    host = t.detach().to("cpu").resolve_conj().resolve_neg().contiguous()
    body = host.reshape(-1).view(torch.uint8).numpy()
    return (_rebuild_tensor, (pickle.PickleBuffer(body),
                              str(t.dtype).removeprefix("torch."),
                              tuple(t.shape), str(t.device)))


def _rebuild_tensor(buf: Any, dtype: str, shape: tuple,
                    device: str) -> torch.Tensor:
    """Inverse of :func:`_reduce_tensor`: a tensor viewing ``buf`` (which
    it keeps alive), copied onto ``device`` when that is not the CPU."""
    dt = getattr(torch, dtype)
    mv = memoryview(buf)
    if mv.nbytes == 0:
        t = torch.empty(shape, dtype=dt)
    else:
        if mv.readonly:          # frombuffer wants writable memory
            mv = memoryview(bytearray(mv))
        t = torch.frombuffer(mv, dtype=torch.uint8).view(dt).reshape(shape)
    return t if device == "cpu" else t.to(device)


class _Pickler(pickle.Pickler):
    """Protocol-5 pickler that sends tensors through :func:`_reduce_tensor`
    (sparse and other non-strided layouts keep torch's own reduction)."""

    def reducer_override(self, obj: Any) -> Any:
        if isinstance(obj, torch.Tensor) and obj.layout == torch.strided:
            return _reduce_tensor(obj)
        return NotImplemented


def dumps(value: Any, buffer_callback: Optional[Callable] = None) -> bytes:
    """``pickle.dumps(value, protocol=5, buffer_callback=...)`` with tensors
    reduced to their host bytes (see the module docstring)."""
    f = io.BytesIO()
    _Pickler(f, protocol=5, buffer_callback=buffer_callback).dump(value)
    return f.getvalue()


def encode(value: Any, *, transport: str = "shm",
           threshold: int = SHM_THRESHOLD,
           namer: Optional[Callable[[], str]] = None) -> Encoded:
    """Serialize ``value`` with pickle protocol 5; spill large buffers (and
    a large pickle stream) to shared memory when ``transport == 'shm'``.
    Raises whatever pickle raises for unserializable values — callers turn
    that into a task error, never a worker death."""
    threshold = max(1, threshold)
    raw: List[pickle.PickleBuffer] = []
    data = dumps(value, buffer_callback=raw.append)
    use_shm = transport == "shm" and shm_available()
    gen = namer or (lambda: f"rr{os.getpid():x}{uuid.uuid4().hex[:8]}")
    total = len(data)
    buffers: List[Union[bytes, ShmRef]] = []
    for pb in raw:
        mv = pb.raw()
        total += mv.nbytes
        if use_shm and mv.nbytes >= threshold:
            buffers.append(_write_segment(mv, gen()))
        else:
            # bytearray, not bytes: reconstructed arrays stay writable,
            # matching what the thread/sequential backends hand back
            buffers.append(bytearray(mv))
        pb.release()
    stream: Union[bytes, ShmRef] = data
    if use_shm and len(data) >= threshold:
        stream = _write_segment(memoryview(data), gen())
    return Encoded(stream, buffers, total)


class SegmentKeeper:
    """Pins shared-memory attachments alive for zero-copy decoded values.

    A zero-copy decode reconstructs arrays *viewing* the mapped segment, and
    a pure task's output may alias its input (identity, slicing), so a held
    mapping can never be safely unmapped — it is pinned for the life of the
    process and reclaimed by the OS at exit (``seg.close`` is disarmed so
    ``SharedMemory.__del__`` doesn't raise ``BufferError`` over the live
    array views at interpreter shutdown).  Unlinking (the driver's job) is
    safe while held: POSIX keeps the pages until the last mapping dies.
    Workers use a keeper; the driver, which outlives runs, always takes the
    copying path instead.
    """

    def __init__(self) -> None:
        self._segs: List[Any] = []

    def hold(self, seg: Any) -> None:
        seg.close = lambda: None     # pinned: only process exit unmaps
        self._segs.append(seg)

    def close(self) -> None:
        """Drop the pin bookkeeping (mappings live until process exit)."""
        self._segs.clear()


def _attach_view(ref: ShmRef, keeper: SegmentKeeper) -> memoryview:
    from multiprocessing.shared_memory import SharedMemory
    try:
        seg = SharedMemory(name=ref.name)
    except (FileNotFoundError, OSError) as e:
        raise TransferLost(f"shm segment {ref.name} gone: {e!r}") from e
    _untrack(seg)
    keeper.hold(seg)
    return seg.buf[:ref.nbytes]


def decode(enc: Encoded, keeper: Optional[SegmentKeeper] = None) -> Any:
    """Reconstruct the value from an :class:`Encoded`.

    Without a ``keeper`` shared-memory parts are copied out and unmapped
    immediately — the safe mode for the long-lived driver, where eager
    unlink must never race a held mapping.  With a ``keeper`` the decode is
    **zero-copy**: array buffers alias the mapping (exactly the object
    sharing the thread backend gets for free), and the keeper pins the
    attachment until process exit.  Raises :class:`TransferLost` if a
    segment was already unlinked."""
    if keeper is None:
        data: Any = _read_segment(enc.data) \
            if isinstance(enc.data, ShmRef) else enc.data
        buffers = [_read_segment(b) if isinstance(b, ShmRef) else b
                   for b in enc.buffers]
    else:
        data = _attach_view(enc.data, keeper) \
            if isinstance(enc.data, ShmRef) else enc.data
        buffers = [_attach_view(b, keeper) if isinstance(b, ShmRef) else b
                   for b in enc.buffers]
    return pickle.loads(data, buffers=buffers)


def resolve(handle: Handle,
            keeper: Optional[SegmentKeeper] = None) -> Any:
    """Materialize any handle: decode shm/inline, or pull from a peer.

    A :class:`DualRef` resolves by **host identity**: a consumer on the
    owner's machine maps the shared-memory half (zero-copy, no sockets),
    anyone else — or a same-host consumer racing a GC unlink — pulls over
    the TCP peer server."""
    if isinstance(handle, Encoded):
        return decode(handle, keeper)
    if isinstance(handle, DualRef):
        if handle.host == _this_host():
            try:
                return decode(handle.shm, keeper)
            except TransferLost:
                pass        # segment swept under us: the peer may live on
        return peer_fetch(handle.peer)
    if isinstance(handle, PeerRef):
        return peer_fetch(handle)
    raise TypeError(f"not a transfer handle: {type(handle).__name__}")


_HOST_ID: Optional[str] = None


def _this_host() -> str:
    global _HOST_ID
    if _HOST_ID is None:
        from .channel import host_id
        _HOST_ID = host_id()
    return _HOST_ID


# ------------------------------------------------------------- peer channel
_LEN = struct.Struct("<q")
_SECRET_LEN = 32            # uuid4().hex — fixed-width capability token

# exact-read is shared with the control channel's framing (ChannelClosed
# subclasses ConnectionError, so existing handlers here keep working)
from .channel import _recv_exact        # noqa: E402


class PeerServer:
    """Worker-side socket server: peers (and the driver, for final
    collection) pull values straight from this worker's local store,
    bypassing the driver control channel entirely.  One request per
    connection: ``<tid:int64>`` in, ``<len:int64><pickled Encoded>`` out
    (len == -1 when the value is not in the store).

    Two address families share the protocol: a unix-domain socket at
    ``path`` (the single-host ``sock`` transport), or — when ``path`` is
    ``None`` — a TCP socket bound to an ephemeral port and advertised as
    ``tcp://<advertise_host>:<port>`` (the multi-host ``tcp`` transport,
    where a consumer on another machine dials the producer directly).
    :attr:`path` is the advertised address either way, and is what goes
    into every :class:`PeerRef` this worker hands out.
    """

    def __init__(self, path: Optional[str], store: Dict[int, Any], *,
                 advertise_host: str = "127.0.0.1") -> None:
        self._store = store
        self._unix_path: Optional[str] = path
        if path is not None:
            self.secret = ""        # unix: filesystem perms are the gate
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                os.unlink(path)      # stale file from a recycled wid/run
            except OSError:
                pass
            self._sock.bind(path)
            self.path = path
        else:
            # TCP: an open port on 0.0.0.0 — requests must present the
            # per-server capability secret, which travels only inside
            # PeerRefs on the authenticated control channel
            self.secret = uuid.uuid4().hex
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._sock.bind(("0.0.0.0", 0))
            self.path = f"tcp://{advertise_host}:{self._sock.getsockname()[1]}"
        self._sock.listen(16)
        self._closed = False
        threading.Thread(target=self._accept_loop, daemon=True,
                         name=f"peer-server-{os.path.basename(self.path)}"
                         ).start()

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_one, args=(conn,),
                             daemon=True).start()

    def _serve_one(self, conn: socket.socket) -> None:
        try:
            with conn:
                # a client that connects and goes silent (port scanner on
                # the open TCP family) must not pin this thread forever
                conn.settimeout(60.0)
                (tid,) = _LEN.unpack(_recv_exact(conn, _LEN.size))
                if self.secret:
                    import hmac
                    got = _recv_exact(conn, _SECRET_LEN)
                    if not hmac.compare_digest(got, self.secret.encode()):
                        return      # unauthorized: drop the connection
                if tid not in self._store:
                    conn.sendall(_LEN.pack(-1))
                    return
                enc = encode(self._store[tid], transport="driver")
                blob = pickle.dumps(enc, protocol=5)
                conn.sendall(_LEN.pack(len(blob)) + blob)
        except Exception:
            pass        # consumer sees a broken stream -> TransferLost

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass
        if self._unix_path is not None:
            try:
                os.unlink(self._unix_path)
            except OSError:
                pass


def _peer_connect(addr: str, timeout: float) -> socket.socket:
    """Dial a peer address: ``tcp://host:port`` or a unix-socket path."""
    if addr.startswith("tcp://"):
        host, _, port = addr[len("tcp://"):].rpartition(":")
        return socket.create_connection((host, int(port)), timeout=timeout)
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.settimeout(timeout)
    sock.connect(addr)
    return sock


# Process-local fault/retry configuration for the data plane.  Workers
# install these from their run config (every worker process sets them at
# startup — fork children must not inherit a stale hook from a previous
# in-process run); the driver keeps the defaults unless a caller passes
# an explicit policy.
_FETCH_FAULT_HOOK: Optional[Callable[[PeerRef, int], None]] = None
_DEFAULT_RETRY: Optional[Any] = None


def set_fetch_fault(hook: Optional[Callable[[PeerRef, int], None]]) -> None:
    """Install (or clear, with ``None``) the per-process fault-injection
    hook: called as ``hook(ref, attempt)`` at the top of every peer-fetch
    attempt.  May sleep (delay faults) or raise :class:`TransferLost`
    (transfer failures) — see :meth:`repro_torch.faults.FaultPlan.fetch_hook`."""
    global _FETCH_FAULT_HOOK
    _FETCH_FAULT_HOOK = hook


def set_default_retry(policy: Optional[Any]) -> None:
    """Set this process's default :class:`repro_torch.faults.RetryPolicy` for
    peer fetches (``None`` restores the built-in default)."""
    global _DEFAULT_RETRY
    _DEFAULT_RETRY = policy


def default_retry() -> Any:
    if _DEFAULT_RETRY is not None:
        return _DEFAULT_RETRY
    from repro_torch.faults.retry import RetryPolicy
    return RetryPolicy(attempts=3, base_delay=0.05, factor=2.0,
                       max_delay=1.0)


def _peer_fetch_once(ref: PeerRef, timeout: float) -> Any:
    try:
        with _peer_connect(ref.addr, timeout) as sock:
            sock.settimeout(timeout)
            request = _LEN.pack(ref.tid)
            if ref.addr.startswith("tcp://"):
                secret = ref.secret.encode()
                if len(secret) != _SECRET_LEN:
                    e = TransferLost(
                        f"peer ref for task {ref.tid} carries no valid "
                        f"capability secret")
                    e.retryable = False     # malformed ref: retry is futile
                    raise e
                request += secret
            sock.sendall(request)
            (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
            if n < 0:
                e = TransferLost(
                    f"peer {ref.addr} no longer holds task {ref.tid}")
                e.retryable = False     # a definitive answer, not a flake
                raise e
            blob = _recv_exact(sock, n)
    except TransferLost:
        raise
    except (OSError, ConnectionError, socket.timeout) as e:
        raise TransferLost(
            f"peer {ref.addr} unreachable for task {ref.tid}: {e!r}") from e
    try:
        return decode(pickle.loads(blob))
    except TransferLost:
        raise
    except Exception as e:      # truncated/garbled stream: the peer died
        # mid-write (or something that isn't a PeerServer answered)
        raise TransferLost(
            f"peer {ref.addr} sent a corrupt stream for task "
            f"{ref.tid}: {e!r}") from e


def peer_fetch(ref: PeerRef, timeout: float = 30.0,
               retry: Optional[Any] = None) -> Any:
    """Pull ``ref.tid`` from the owning worker's socket (unix or TCP).

    Transient failures (unreachable peer, timeout, truncated stream) are
    retried under ``retry`` — default: this process's
    :func:`set_default_retry` policy, else a small bounded backoff.
    Definitive failures (the owner answered that it no longer holds the
    value) surface immediately.  When retries exhaust, the failure is
    still a :class:`TransferLost` — the caller degrades from there
    (driver-relay fallback, then lineage recovery)."""
    policy = retry if retry is not None else default_retry()

    def attempt(i: int) -> Any:
        if _FETCH_FAULT_HOOK is not None:
            _FETCH_FAULT_HOOK(ref, i)
        return _peer_fetch_once(ref, timeout)

    return policy.run(
        attempt,
        retryable=lambda e: isinstance(e, TransferLost)
        and getattr(e, "retryable", True))


# ------------------------------------------------------------------- sizing
def payload_nbytes(value: Any) -> int:
    """Cheap recursive payload-size estimate (exact for array leaves via
    ``.nbytes``); recorded per completed task and fed to the
    transfer-cost-aware placement score."""
    nb = getattr(value, "nbytes", None)
    if isinstance(nb, int):
        return nb
    if isinstance(value, (bytes, bytearray, memoryview)):
        return len(value)
    if isinstance(value, (str,)):
        return len(value)
    if isinstance(value, (list, tuple, set, frozenset)):
        return 64 + sum(payload_nbytes(v) for v in value)
    if isinstance(value, dict):
        return 64 + sum(payload_nbytes(k) + payload_nbytes(v)
                        for k, v in value.items())
    try:
        return sys.getsizeof(value)
    except Exception:
        return 64
