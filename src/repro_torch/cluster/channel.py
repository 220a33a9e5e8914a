"""Transport-agnostic control-plane channels for the cluster runtime.

Port of ``repro/cluster/channel.py``, unchanged: the control plane is plain
Python.

The driver logic in :mod:`repro_torch.cluster.executor` was always
transport-agnostic *in spirit* — it exchanges small tuple messages with
workers and never cares how they travel.  This module makes it so *in
code*: the executor talks to every worker through a :class:`Channel`, and
three implementations cover the deployment shapes the paper's
"large clusters" claim needs:

* :class:`PipeChannel` — today's fork+pipe path, kept as the in-host fast
  path.  One ``multiprocessing`` duplex pipe per forked worker; liveness
  is the OS truth (``proc.is_alive()`` — a SIGKILL is visible instantly).
* :class:`SpawnChannel` — the same pipe wiring for ``spawn``/``forkserver``
  workers (fresh interpreters; the graph must be picklable).  Kept as a
  distinct class because the *launch* contract differs (ship the recipe,
  not the memory image), not the wire format.
* :class:`TcpChannel` — a length-prefixed, message-framed TCP stream.
  This is the multi-host channel: a worker on any machine dials the
  driver's :class:`TcpListener`, handshakes (magic + protocol version +
  optional shared token + host identity), and then speaks the exact same
  tuple protocol.  Because a remote peer's death does not deliver SIGCHLD,
  liveness is **heartbeat-based**: both sides emit ``("hb",)`` frames on an
  interval, every received frame refreshes the peer's ``last_seen``, and
  :meth:`TcpChannel.dead` reports a peer silent past ``heartbeat_timeout``
  (an explicit ``("bye", wid)`` goodbye marks a *clean* exit so shutdown
  is never mistaken for a crash).  Sends go through a **bounded outbox**
  drained by a sender thread — backpressure: a peer that stops reading
  fills the queue and the send fails as a dead-peer event instead of
  wedging the driver loop on a blocking ``sendall``.

Driver-side contract (what the executor's event loop needs):

  ``selectable()``       object for ``multiprocessing.connection.wait``
  ``send(msg)``          enqueue/write one message; ``ChannelClosed`` if the
                         peer is gone (the caller turns that into a death)
  ``send_many(msgs)``    coalesce a burst of messages into one wire write
                         (a ``("batch", [...])`` frame: one pickle + one
                         syscall); order preserved, peers unwrap — the
                         driver flushes its per-worker outbox through this
                         once per event-loop iteration
  ``recv_available()``   drain every complete message currently readable
                         (never blocks after ``wait`` reported readability);
                         ``ChannelClosed`` on EOF
  ``dead()``             liveness verdict: ``None`` while believed alive,
                         else a human-readable reason
  ``maybe_heartbeat()``  rate-limited keepalive (no-op for pipes)
  ``close()``            release the endpoint

Worker-side endpoints (:class:`WorkerPipeEndpoint`,
:class:`WorkerTcpEndpoint`) expose blocking ``recv()`` + ``send()`` with
the same ``ChannelClosed`` error surface, so
:func:`repro_torch.cluster.worker.worker_main` runs unchanged over any wire.

Every channel carries the same verb-tuple protocol (the table lives in
:mod:`repro_torch.cluster.worker`), including the idempotent ``("cancel", tid)``
/ ``("cancelled", wid, tid)`` pair speculation uses to abort a losing
duplicate between tasks — pipe and TCP alike, no per-wire special case.
"""
from __future__ import annotations

import os
import pickle
import queue
import random
import socket
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

PROTOCOL_MAGIC = "repro-cluster"
# v2: super-task dispatch (``run``/``done`` carry cluster ids and
# per-member size maps) + ``("batch", [msgs])`` coalesced frames
# v3: driver-restart re-adoption — the hello may carry ``rejoin``/``wid``
# (a surviving worker re-dialing a resumed run), and a rejoining worker's
# first post-welcome frame is its ``("inv", wid, [(tid, nbytes), ...])``
# object-store inventory
PROTOCOL_VERSION = 3

#: control-plane channels a ClusterExecutor can be built on (the
#: transport matrix lives in serde.TRANSPORTS / serde.CROSS_HOST_TRANSPORTS)
CHANNELS = ("pipe", "spawn", "tcp")

_FRAME = struct.Struct("<Q")         # length prefix, host-order-independent
_MAX_FRAME = 1 << 34                 # 16 GiB sanity bound on one message


class ChannelClosed(ConnectionError):
    """The peer is unreachable (EOF, reset, dead process, backpressure
    overflow).  The executor treats this exactly like a worker death."""


class DialRejected(ChannelClosed):
    """The driver answered the dial and said no (bad token, wrong
    protocol, unshippable graph).  A *definitive* refusal — retrying the
    same dial cannot succeed, so retry policies must let it propagate."""


_SILENCE_PREFIX = "no heartbeat"


def is_silence(reason: Optional[str]) -> bool:
    """Classify a ``Channel.dead()`` verdict: silence-based verdicts
    (missed heartbeats — the peer may be partitioned-but-alive) are
    *suspicions* the executor grants a grace window; everything else
    (process exit, EOF, send failure) is definitive death."""
    return bool(reason) and reason.startswith(_SILENCE_PREFIX)


def wrap_batch(msgs: List[tuple]) -> Optional[tuple]:
    """The batch envelope, in one place: a single message travels bare, a
    burst travels as one ``("batch", [...])`` frame (one pickle + one
    syscall).  Returns ``None`` for an empty burst.  Every sender — both
    channel families and the worker's reply thread — must wrap through
    here so the envelope can never diverge from :func:`_flatten_batches`.
    """
    if not msgs:
        return None
    if len(msgs) == 1:
        return msgs[0]
    return ("batch", list(msgs))


def _flatten_batches(msgs: List[tuple]) -> List[tuple]:
    """Unwrap ``("batch", [...])`` frames into their member messages, in
    order.  Batching is a *wire* optimization (one pickle + one syscall
    for a burst of control messages); no consumer above the channel layer
    ever sees a batch frame."""
    if not any(m and m[0] == "batch" for m in msgs):
        return msgs
    flat: List[tuple] = []
    for m in msgs:
        if m and m[0] == "batch":
            flat.extend(m[1])
        else:
            flat.append(m)
    return flat


def host_id() -> str:
    """Identity of this machine for per-host locality grouping and the
    cross-host transport guard.  Hostname alone collides across cloned
    VMs / default cloud images, so it is salted with the stable
    machine-id when one exists — every process on one machine must agree
    on the id, so no per-process randomness is allowed here."""
    name = socket.gethostname() or "localhost"
    try:
        with open("/etc/machine-id") as f:
            mid = f.read().strip()[:12]
        if mid:
            return f"{name}-{mid}"
    except OSError:
        pass
    return name


def routable_ip() -> str:
    """Best-effort non-loopback IP of this machine.  Used as the peer
    data-plane advertise address for *local* workers in a mixed
    local+remote pool: they dial the driver over loopback, but a remote
    consumer pulling from their PeerServer must reach this machine's real
    interface, not 127.0.0.1 on its own."""
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:        # routing-table lookup only; no packet is sent
            s.connect(("10.254.254.254", 1))
            ip = s.getsockname()[0]
        finally:
            s.close()
        if not ip.startswith("127."):
            return ip
    except OSError:
        pass
    try:
        ip = socket.gethostbyname(socket.gethostname())
        if not ip.startswith("127."):
            return ip
    except OSError:
        pass
    return "127.0.0.1"


# --------------------------------------------------------------------- pipe
class PipeChannel:
    """Driver-side endpoint of a forked worker's duplex pipe.

    Liveness is authoritative: the worker is a child process, so
    ``proc.is_alive()`` sees SIGKILL/OOM the moment the OS reaps it —
    no heartbeats needed on this channel.
    """

    kind = "pipe"

    def __init__(self, conn, proc) -> None:
        self.conn = conn
        self.proc = proc
        self._closed = False

    def selectable(self):
        return self.conn

    def send(self, msg: tuple) -> None:
        # NOTE: ValueError (an over-2GiB pipe message) deliberately
        # propagates — it is a caller bug, not a dead worker, and mapping
        # it to ChannelClosed would cascade fake deaths across the pool
        try:
            self.conn.send(msg)
        except (BrokenPipeError, OSError) as e:
            raise ChannelClosed(f"pipe send failed: {e!r}") from e

    def send_many(self, msgs: List[tuple]) -> None:
        """Coalesce a burst of messages into one wire write (one pickle +
        one syscall) — the driver's per-iteration outbox flush.  Order is
        preserved; the worker-side reader unwraps the batch frame."""
        wrapped = wrap_batch(msgs)
        if wrapped is not None:
            self.send(wrapped)

    def recv_available(self) -> List[tuple]:
        # mp pipes deliver whole messages; one recv per readability event
        # matches the pre-channel driver loop exactly
        try:
            return _flatten_batches([self.conn.recv()])
        except (EOFError, OSError) as e:
            raise ChannelClosed(f"pipe EOF: {e!r}") from e

    def dead(self) -> Optional[str]:
        if self.proc is not None and not self.proc.is_alive():
            return f"process exited (code {self.proc.exitcode})"
        return None

    def maybe_heartbeat(self) -> None:     # pipes don't need keepalives
        pass

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self.conn.close()
        except OSError:
            pass


class SpawnChannel(PipeChannel):
    """Pipe wiring for ``spawn``/``forkserver`` workers.  Wire-identical to
    :class:`PipeChannel`; the difference is the launch contract (the child
    is a fresh interpreter, so the graph crossed by pickling, exactly like
    a remote worker receives it over TCP)."""

    kind = "spawn"


class WorkerPipeEndpoint:
    """Worker-side face of a duplex pipe, matching the TCP endpoint API."""

    def __init__(self, conn) -> None:
        self.conn = conn

    def recv(self) -> tuple:
        try:
            return self.conn.recv()
        except (EOFError, OSError) as e:
            raise ChannelClosed(f"driver gone: {e!r}") from e

    def send(self, msg: tuple) -> None:
        try:
            self.conn.send(msg)
        except (BrokenPipeError, OSError) as e:
            raise ChannelClosed(f"driver gone: {e!r}") from e

    def close(self) -> None:
        try:
            self.conn.close()
        except OSError:
            pass


# ---------------------------------------------------------------- tcp frames
def _send_frame(sock: socket.socket, payload: bytes,
                lock: Optional[threading.Lock] = None) -> None:
    data = _FRAME.pack(len(payload)) + payload
    if lock is None:
        sock.sendall(data)
    else:
        with lock:
            sock.sendall(data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ChannelClosed("peer closed mid-frame")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def _recv_raw_frame(sock: socket.socket, max_len: int = _MAX_FRAME) -> bytes:
    (n,) = _FRAME.unpack(_recv_exact(sock, _FRAME.size))
    if not 0 <= n <= max_len:
        raise ChannelClosed(f"insane frame length {n}")
    return _recv_exact(sock, n)


def _recv_frame(sock: socket.socket) -> tuple:
    return pickle.loads(_recv_raw_frame(sock))


class _FrameBuffer:
    """Incremental parser for length-prefixed frames (driver side, where
    reads happen in non-blocking bites after ``wait`` reports data)."""

    def __init__(self) -> None:
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[tuple]:
        self._buf.extend(data)
        msgs: List[tuple] = []
        while True:
            if len(self._buf) < _FRAME.size:
                return msgs
            (n,) = _FRAME.unpack_from(self._buf)
            if not 0 <= n <= _MAX_FRAME:
                raise ChannelClosed(f"insane frame length {n}")
            end = _FRAME.size + n
            if len(self._buf) < end:
                return msgs
            msgs.append(pickle.loads(bytes(self._buf[_FRAME.size:end])))
            del self._buf[:end]


# ----------------------------------------------------------------- tcp chan
class TcpChannel:
    """Driver-side endpoint of one dialed-in worker.

    * **Framing** — ``<u64 len><pickle>`` per message; a partial read parks
      bytes in a :class:`_FrameBuffer` until the frame completes.
    * **Liveness** — every received frame (heartbeats included) refreshes
      ``last_seen``; :meth:`dead` trips after ``heartbeat_timeout`` of
      silence.  A clean ``bye`` sets :attr:`said_goodbye` so shutdown
      drains are not misread as crashes.  EOF/reset surface as
      :class:`ChannelClosed` from :meth:`recv_available`.
    * **Backpressure** — :meth:`send` enqueues into a bounded outbox; a
      dedicated sender thread owns the socket's write side.  A peer that
      stops draining fills the queue and the next send raises
      :class:`ChannelClosed` after ``send_timeout`` instead of blocking
      the driver loop forever.
    """

    kind = "tcp"

    def __init__(self, sock: socket.socket, *,
                 heartbeat_interval: float = 2.0,
                 heartbeat_timeout: float = 10.0,
                 heartbeat_jitter: float = 0.25,
                 outbox_size: int = 256,
                 send_timeout: float = 30.0,
                 proc=None) -> None:
        self.sock = sock
        self.proc = proc            # local dialer's process, if any (chaos
        # hooks use it; liveness does NOT — multi-host has no proc to ask)
        self.heartbeat_interval = heartbeat_interval
        self.heartbeat_timeout = heartbeat_timeout
        # per-channel jittered beat: each peer's keepalives land at
        # interval*(1-jitter)..interval, so a large pool's heartbeats
        # de-phase instead of arriving as one synchronized burst (always
        # early, never late — timeout margins are unchanged)
        self.heartbeat_jitter = max(0.0, min(0.9, heartbeat_jitter))
        self._hb_rng = random.Random()
        self._hb_gap = self._jittered_gap()
        self.send_timeout = send_timeout
        self.last_seen = time.monotonic()
        self.said_goodbye = False
        self._frames = _FrameBuffer()
        self._outbox: "queue.Queue[Optional[bytes]]" = queue.Queue(
            maxsize=max(1, outbox_size))
        self._send_failed: Optional[str] = None
        self._last_hb = 0.0
        self._closed = False
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        self._sender = threading.Thread(
            target=self._drain_outbox, daemon=True,
            name=f"tcp-chan-sender-{sock.fileno()}")
        self._sender.start()

    # -- write side ---------------------------------------------------------
    def _drain_outbox(self) -> None:
        while True:
            payload = self._outbox.get()
            if payload is None:
                return
            try:
                self.sock.sendall(_FRAME.pack(len(payload)) + payload)
            except OSError as e:
                self._send_failed = f"send failed: {e!r}"
                return

    def send(self, msg: tuple) -> None:
        if self._closed or self._send_failed:
            raise ChannelClosed(self._send_failed or "channel closed")
        payload = pickle.dumps(msg, protocol=5)
        try:
            self._outbox.put(payload, timeout=self.send_timeout)
        except queue.Full:
            self._send_failed = (
                f"backpressure: peer did not drain {self._outbox.maxsize} "
                f"queued messages within {self.send_timeout}s")
            raise ChannelClosed(self._send_failed) from None

    def send_many(self, msgs: List[tuple]) -> None:
        """One frame for a burst of messages: a single pickle + a single
        outbox slot, amortizing serialization and syscall cost under
        load (order preserved; the peer unwraps)."""
        wrapped = wrap_batch(msgs)
        if wrapped is not None:
            self.send(wrapped)

    def _jittered_gap(self) -> float:
        return self.heartbeat_interval * \
            (1.0 - self.heartbeat_jitter * self._hb_rng.random())

    def maybe_heartbeat(self) -> None:
        now = time.monotonic()
        if now - self._last_hb < self._hb_gap:
            return
        self._last_hb = now
        self._hb_gap = self._jittered_gap()
        try:
            self.send(("hb",))
        except ChannelClosed:
            pass                     # dead() / next send reports it

    # -- read side ----------------------------------------------------------
    def selectable(self):
        return self.sock

    def recv_available(self) -> List[tuple]:
        try:
            data = self.sock.recv(1 << 20)
        except (BlockingIOError, InterruptedError):
            return []
        except OSError as e:
            raise ChannelClosed(f"recv failed: {e!r}") from e
        if not data:
            raise ChannelClosed("peer closed connection")
        self.last_seen = time.monotonic()
        msgs = _flatten_batches(self._frames.feed(data))
        if any(m and m[0] == "bye" for m in msgs):
            self.said_goodbye = True
        return msgs

    def dead(self) -> Optional[str]:
        if self._send_failed:
            return self._send_failed
        if self.said_goodbye:
            return None              # clean exit is not a crash
        silent = time.monotonic() - self.last_seen
        if silent > self.heartbeat_timeout:
            return (f"no heartbeat for {silent:.1f}s "
                    f"(timeout {self.heartbeat_timeout}s)")
        return None

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._outbox.put_nowait(None)
        except queue.Full:
            # make room for the shutdown sentinel (sends are refused now
            # that _closed is set), else the sender thread leaks blocked
            # in get() after the queue drains
            try:
                self._outbox.get_nowait()
            except queue.Empty:
                pass
            try:
                self._outbox.put_nowait(None)
            except queue.Full:
                pass
        # flush: queued messages (a final stop/die) should reach the wire
        # before the socket drops; a wedged peer bounds the wait
        self._sender.join(timeout=2.0)
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class WorkerTcpEndpoint:
    """Worker-side face of the TCP channel: blocking framed recv/send plus
    a background heartbeat thread and a driver-silence watchdog (a worker
    whose driver host vanished must not hang forever on a half-open
    socket — it exits, exactly as a pipe worker does on EOF).

    When the driver advertises a resumable run (:meth:`configure_rejoin`),
    a dead socket is no longer fatal: every send/recv failure funnels into
    :meth:`_try_rejoin`, which re-dials the driver address with a
    ``rejoin`` hello for up to ``window`` seconds, ships the worker's
    object-store inventory as the first frame on the fresh socket, and
    resumes.  Publishes queued during the outage simply block inside
    ``send`` until re-adoption — the worker keeps computing and buffers.
    Only after the window expires does the endpoint raise
    :class:`ChannelClosed` and let the worker die like an orphan.
    """

    supports_rejoin = True

    def __init__(self, sock: socket.socket, *,
                 heartbeat_interval: float = 2.0,
                 heartbeat_timeout: float = 30.0,
                 heartbeat_jitter: float = 0.25) -> None:
        self.sock = sock
        self.heartbeat_interval = heartbeat_interval
        self.heartbeat_timeout = heartbeat_timeout
        self.heartbeat_jitter = max(0.0, min(0.9, heartbeat_jitter))
        self.last_seen = time.monotonic()
        self._send_lock = threading.Lock()
        self._stop = threading.Event()
        self._rejoin: Optional[dict] = None
        self._reconn_lock = threading.Lock()
        self._gen = 0                   # bumped on every successful rejoin
        self.rejoined = 0
        self.inventory_fn = None        # set by worker_main once the store
        #                                 exists: () -> [(tid, nbytes), ...]
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        threading.Thread(target=self._heartbeat_loop, daemon=True,
                         name="worker-tcp-heartbeat").start()

    def configure_rejoin(self, *, address: str, token: Optional[str],
                         run_id: str, wid: int,
                         window: float = 60.0) -> None:
        """Arm driver-outage survival: on socket death, re-dial ``address``
        with a ``rejoin`` hello for this ``run_id``/``wid`` for up to
        ``window`` seconds before giving up."""
        self._rejoin = {"address": address, "token": token,
                        "run_id": run_id, "wid": wid, "window": window}

    def _heartbeat_loop(self) -> None:
        # random initial phase + per-beat jitter: N workers started by one
        # launcher would otherwise beat in lockstep and hit the driver as
        # one synchronized burst every interval.  Jitter only shortens the
        # gap (interval*(1-j)..interval), so timeout margins are unchanged.
        rng = random.Random()
        if self.heartbeat_jitter > 0 \
                and self._stop.wait(rng.random() * self.heartbeat_interval):
            return
        while not self._stop.wait(
                self.heartbeat_interval *
                (1.0 - self.heartbeat_jitter * rng.random())):
            try:
                self.send(("hb",))
            except ChannelClosed:
                return
            if time.monotonic() - self.last_seen > self.heartbeat_timeout:
                if self._rejoin is not None:
                    # Half-open socket during a resumable run: poke the
                    # blocked reader by closing the socket — its recv
                    # fails into _try_rejoin.  Must NOT exit: the rejoin
                    # window, not the heartbeat timeout, decides death,
                    # else a worker is counted dead once by the timeout
                    # and again at resume reconciliation.
                    try:
                        self.sock.close()
                    except OSError:
                        pass
                    self.last_seen = time.monotonic()
                    continue
                # driver silent past the deadline: orphaned worker.  Hard
                # exit mirrors the pipe worker's EOF death (daemonized
                # children of a dead driver must not linger).
                os._exit(1)

    def _try_rejoin(self, gen: int) -> bool:
        """Re-dial the driver after a socket failure observed at ``gen``.
        Returns True when a usable socket is in place (possibly installed
        by a racing thread), False when rejoin is off or the window
        expired."""
        rj = self._rejoin
        if rj is None or self._stop.is_set():
            return False
        with self._reconn_lock:
            if self._gen != gen:        # another thread already rejoined
                return True
            deadline = time.monotonic() + rj["window"]
            while not self._stop.is_set():
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                try:
                    sock, wid, _cfg, _blob = _dial_and_welcome(
                        rj["address"], token=rj["token"], has_graph=True,
                        timeout=min(5.0, max(0.5, left)),
                        retry_interval=0.2,
                        extra={"rejoin": rj["run_id"], "wid": rj["wid"]})
                except ChannelClosed:
                    time.sleep(0.25)
                    continue
                inv = list(self.inventory_fn()) if self.inventory_fn else []
                try:
                    sock.setsockopt(socket.IPPROTO_TCP,
                                    socket.TCP_NODELAY, 1)
                    # inventory is the FIRST frame on the new socket —
                    # written before the socket becomes visible to other
                    # sender threads, so the driver can reconcile before
                    # any buffered publish arrives
                    _send_frame(sock, pickle.dumps(
                        ("inv", rj["wid"], inv), protocol=5))
                except OSError:
                    try:
                        sock.close()
                    except OSError:
                        pass
                    time.sleep(0.25)
                    continue
                old, self.sock = self.sock, sock
                self._gen += 1
                self.last_seen = time.monotonic()
                self.rejoined += 1
                try:
                    old.close()
                except OSError:
                    pass
                return True
            return False

    def recv(self) -> tuple:
        while True:
            gen = self._gen
            try:
                msg = _recv_frame(self.sock)
            except (OSError, pickle.UnpicklingError, EOFError) as e:
                if self._try_rejoin(gen):
                    continue
                raise ChannelClosed(f"driver gone: {e!r}") from e
            self.last_seen = time.monotonic()
            return msg

    def send(self, msg: tuple) -> None:
        payload = pickle.dumps(msg, protocol=5)
        while True:
            gen = self._gen
            try:
                _send_frame(self.sock, payload, self._send_lock)
                return
            except OSError as e:
                if self._try_rejoin(gen):
                    continue
                raise ChannelClosed(f"driver gone: {e!r}") from e

    def close(self) -> None:
        self._rejoin = None             # a closing worker never re-dials
        self._stop.set()
        try:
            self.sock.close()
        except OSError:
            pass


# ----------------------------------------------------------------- listener
class TcpListener:
    """Driver-side accept loop for dialing workers.

    Binds ``host:port`` (port 0 = ephemeral; the resolved address is
    :attr:`address`), accepts connections on a background thread, performs
    the **server half of the handshake** — read the worker's ``hello``
    frame, check magic/version/token — and parks the authenticated
    ``(socket, hello)`` pair for the executor to adopt via
    :meth:`get_worker` (initial pool barrier) or :meth:`poll_worker`
    (mid-run elastic joins: any `repro-worker` that dials a live run is a
    join).  Rejected dials get a ``("reject", reason)`` frame and are
    closed; they never reach the executor.
    """

    def __init__(self, address: str = "127.0.0.1:0",
                 token: Optional[str] = None,
                 handshake_timeout: float = 10.0) -> None:
        host, _, port = address.rpartition(":")
        if not host:
            host, port = address or "127.0.0.1", "0"
        self.token = token
        self.handshake_timeout = handshake_timeout
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen(64)
        self.address = "%s:%d" % self._sock.getsockname()[:2]
        self._pending: "queue.Queue[Tuple[socket.socket, dict]]" = \
            queue.Queue()
        self._closed = False
        threading.Thread(target=self._accept_loop, daemon=True,
                         name=f"tcp-listener-{self.address}").start()

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                sock, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._handshake, args=(sock,),
                             daemon=True).start()

    def _handshake(self, sock: socket.socket) -> None:
        try:
            sock.settimeout(self.handshake_timeout)
            # SECURITY: the hello is the ONLY frame read from an
            # unauthenticated peer, and it is JSON — pickle.loads on
            # pre-auth bytes would hand arbitrary code execution to
            # anyone who can reach the port, making the token check
            # decorative.  Pickled frames start after the token passes.
            import json
            try:
                info = json.loads(
                    _recv_raw_frame(sock, max_len=1 << 16).decode("utf-8"))
            except (ValueError, UnicodeDecodeError) as e:
                raise ChannelClosed(f"malformed hello: {e!r}") from e
            if not isinstance(info, dict):
                raise ChannelClosed("malformed hello")
            if info.get("magic") != PROTOCOL_MAGIC:
                raise ChannelClosed("bad magic")
            if info.get("version") != PROTOCOL_VERSION:
                raise ChannelClosed(
                    f"protocol version {info.get('version')} != "
                    f"{PROTOCOL_VERSION}")
            if self.token is not None:
                # constant-time comparison, matching the peer data plane's
                # capability check (serde.PeerServer): a plain `!=` leaks
                # the shared token byte-by-byte through response timing
                import hmac
                tok = info.get("token")
                if not (isinstance(tok, str) and hmac.compare_digest(
                        tok.encode("utf-8"), self.token.encode("utf-8"))):
                    raise ChannelClosed("bad token")
            try:
                info["peer_ip"] = sock.getpeername()[0]
            except OSError:
                info["peer_ip"] = "127.0.0.1"
            sock.settimeout(None)
        except (ChannelClosed, OSError, pickle.UnpicklingError,
                EOFError) as e:
            try:
                _send_frame(sock, pickle.dumps(("reject", repr(e)),
                                               protocol=5))
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
            return
        self._pending.put((sock, info))

    def get_worker(self, timeout: float) -> Tuple[socket.socket, dict]:
        """Block until a handshaken worker connection is available."""
        try:
            return self._pending.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError(
                f"no worker dialed {self.address} within {timeout}s "
                "(start workers with: python -m repro_torch.launch.remote "
                f"--connect {self.address})") from None

    def poll_worker(self) -> Optional[Tuple[socket.socket, dict]]:
        """Non-blocking variant for mid-run elastic joins."""
        try:
            return self._pending.get_nowait()
        except queue.Empty:
            return None

    def fileno(self) -> int:
        """The listening socket's fd — fork-started workers close this
        inherited copy so a dead driver's port frees for a resumed one."""
        return self._sock.fileno()

    def close(self) -> None:
        self._closed = True
        # shutdown-before-close: the accept thread is blocked in accept(2),
        # and on Linux close() alone does NOT wake it — the in-flight
        # syscall keeps the kernel socket (and the PORT) alive until some
        # stray dial lands.  A driver restarted on the same address would
        # race that zombie LISTEN and lose with EADDRINUSE.
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


# --------------------------------------------------------------- worker dial
def _dial_and_welcome(address: str, *, token: Optional[str],
                      has_graph: bool, timeout: float,
                      retry_interval: float,
                      extra: Optional[dict] = None,
                      ) -> Tuple[socket.socket, int, dict, Optional[bytes]]:
    """Connect + hello + welcome, returning the raw authenticated socket.
    Shared between the first dial (:func:`dial_driver`) and the rejoin
    path (:meth:`WorkerTcpEndpoint._try_rejoin`), which differ only in
    the ``extra`` hello fields."""
    host, _, port = address.rpartition(":")
    if not host:
        raise ValueError(f"worker address must be host:port, got {address!r}")
    deadline = time.monotonic() + timeout
    last_err: Optional[BaseException] = None
    sock: Optional[socket.socket] = None
    while sock is None:
        try:
            sock = socket.create_connection((host, int(port)),
                                            timeout=timeout)
        except OSError as e:
            last_err = e
            if time.monotonic() >= deadline:
                raise ChannelClosed(
                    f"could not reach driver at {address}: {e!r}") from e
            time.sleep(retry_interval)
    import json
    hello = {"magic": PROTOCOL_MAGIC,
             "version": PROTOCOL_VERSION,
             "token": token,
             "host": host_id(),
             "pid": os.getpid(),
             "has_graph": has_graph}
    hello.update(extra or {})
    try:
        sock.settimeout(timeout)
        # hello is JSON (see TcpListener._handshake: the driver must not
        # unpickle pre-auth bytes); everything after it is pickled frames
        _send_frame(sock, json.dumps(hello).encode("utf-8"))
        reply = _recv_frame(sock)
    except (OSError, pickle.UnpicklingError, EOFError) as e:
        try:
            sock.close()
        except OSError:
            pass
        raise ChannelClosed(
            f"handshake with {address} failed: {e!r}") from (last_err or e)
    if reply and reply[0] == "reject":
        sock.close()
        raise DialRejected(f"driver rejected worker: {reply[1]}")
    if not (reply and reply[0] == "welcome" and len(reply) == 4):
        sock.close()
        raise ChannelClosed(f"unexpected handshake reply {reply!r}")
    _, wid, config, graph_blob = reply
    sock.settimeout(None)
    return sock, wid, config, graph_blob


def dial_driver(address: str, *, token: Optional[str] = None,
                has_graph: bool = False, timeout: float = 30.0,
                retry_interval: float = 0.2,
                heartbeat_interval: float = 2.0,
                heartbeat_timeout: float = 30.0,
                retry=None,
                ) -> Tuple[WorkerTcpEndpoint, int, dict, Optional[bytes]]:
    """Worker half of the handshake: connect to ``address``, send hello,
    await the driver's welcome.

    Retries the connect until ``timeout`` (workers routinely start before
    the driver binds), and retries *handshake* failures — a dial the
    driver accepted but whose welcome died mid-flight (restarting driver,
    flaky link, injected accept fault) — under ``retry``
    (a :class:`repro_torch.faults.RetryPolicy`; default: 4 attempts with
    exponential backoff inside ``timeout``).  A :class:`DialRejected`
    (bad token, version skew) is definitive and never retried.  Returns
    ``(endpoint, wid, config, graph_blob)`` — ``graph_blob`` is the
    pickled ``(graph, inputs)`` pair for workers that did not inherit the
    graph (``has_graph=False``), else ``None``.

    When the welcome config names a resumable run (``run_id``), the
    endpoint is armed to survive a driver outage: it re-dials ``address``
    with a ``rejoin`` hello instead of dying with the socket.
    """
    if retry is None:
        from repro_torch.faults.retry import RetryPolicy
        retry = RetryPolicy(attempts=4, base_delay=0.2, factor=2.0,
                            max_delay=2.0, deadline=timeout)

    def attempt(_i: int):
        return _dial_and_welcome(
            address, token=token, has_graph=has_graph, timeout=timeout,
            retry_interval=retry_interval)

    sock, wid, config, graph_blob = retry.run(
        attempt,
        retryable=lambda e: isinstance(e, ChannelClosed)
        and not isinstance(e, DialRejected))
    endpoint = WorkerTcpEndpoint(
        sock,
        heartbeat_interval=config.get("heartbeat_interval",
                                      heartbeat_interval),
        heartbeat_timeout=config.get("worker_heartbeat_timeout",
                                     heartbeat_timeout),
        heartbeat_jitter=config.get("heartbeat_jitter", 0.25))
    if config.get("run_id"):
        endpoint.configure_rejoin(
            address=address, token=token, run_id=config["run_id"], wid=wid,
            window=config.get("rejoin_window", 60.0))
    return endpoint, wid, config, graph_blob
