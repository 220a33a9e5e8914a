"""The port's multi-host control plane (``repro_torch/cluster/channel.py``,
``repro_torch/launch/remote.py``): the TCP channel (framing, heartbeat
liveness, backpressure, the handshake's checks), ``repro-worker`` dial-in,
the ``tcp`` data plane, per-host locality, elastic joins, driver restarts,
and the peer-socket and shared-memory hygiene, held to the reference's
suite ``tests/test_multihost.py``.

Each reference test has a case here but one:
``test_repro_worker_joins_midrun_then_sigkilled`` fails by turns on the
JAX package itself, so its copy waits until a cause is found.  Local TCP
workers are forked dialers; the ``repro-worker`` cases start ``python -m
repro_torch.launch.remote``, which unpickles graphs of module-level task
bodies (``tests/_torch_runtime.py``).  Frames the port and the reference
exchange are checked in both directions, and both sweep the same segment
names.  The port adds the Fig. 2 DAG's torch tensors served by two dialed
``repro-worker`` processes over the tcp data plane, and a spawned tcp pool
whose dialers start together.
"""
import glob
import json
import os
import pickle
import random
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.cluster.channel as rchannel                          # noqa: E402
import repro.core.scheduler as rsched                             # noqa: E402

from repro_torch.cluster import ClusterExecutor, serde            # noqa: E402
from repro_torch.cluster.channel import (ChannelClosed,           # noqa: E402
                                         PROTOCOL_MAGIC,
                                         PROTOCOL_VERSION, TcpChannel,
                                         TcpListener, _FrameBuffer,
                                         _send_frame, dial_driver)
from repro_torch.core import TaskGraph, TaskKind, execute_sequential  # noqa: E402
from repro_torch.core.scheduler import list_schedule              # noqa: E402
from repro_torch.core.tracing import RemappedRef as _Ref, trace   # noqa: E402
from repro_torch.workloads import matrix_driver                   # noqa: E402

from _torch_runtime import (REPO, WORKER_ENV, picklable_dag,      # noqa: E402
                            results_equal)

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


def exec_dag(seed: int, n: int, p: float, sleep: float = 0.0) -> TaskGraph:
    """Random integer DAG (closures — fine for fork-started dialers)."""
    rng = random.Random(seed)
    g = TaskGraph()
    for i in range(n):
        deps = [j for j in range(i) if rng.random() < p][-3:]

        def fn(*xs, _i=i, _s=sleep):
            if _s:
                time.sleep(_s)
            return (_i + sum(xs) * 7) % 1_000_003

        g.add_node(f"t{i}", fn, tuple(_Ref(d) for d in deps), {},
                   TaskKind.PURE, deps=deps, cost=rng.uniform(0.1, 1.0))
    g.mark_output(n - 1)
    return g


def array_dag(seed: int, n: int, p: float, elems: int) -> TaskGraph:
    """Random DAG of float32 tensors made from the reference's numpy
    draws."""
    rng = random.Random(seed)
    g = TaskGraph()
    for i in range(n):
        deps = [j for j in range(i) if rng.random() < p][-3:]

        def fn(*xs, _i=i, _e=elems):
            acc = torch.from_numpy((np.arange(_e) % 89).astype(np.float32)
                                   * np.float32(_i % 5 + 1))
            for x in xs:
                acc = acc + x
            return acc

        g.add_node(f"t{i}", fn, tuple(_Ref(d) for d in deps), {},
                   TaskKind.PURE, deps=deps, cost=rng.uniform(0.1, 1.0))
    g.mark_output(n - 1)
    return g


def start_repro_worker(address: str, *extra: str) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.remote",
         "--connect", address, "--timeout", "30", *extra],
        env=WORKER_ENV, cwd=REPO)


# ------------------------------------------------------------ channel units

def test_frame_buffer_reassembles_split_frames():
    """Length-prefixed framing must survive arbitrary TCP segmentation,
    and the port's frames are the reference's bytes."""
    msgs = [("run", 1, {"a": 1}), ("hb",), ("done", 0, 1, 0.5, 64, [2, 3])]
    blob = b"".join(
        len(p).to_bytes(8, "little") + p
        for p in (pickle.dumps(m, protocol=5) for m in msgs))
    for step in (1, 3, 7, len(blob)):
        for buf in (_FrameBuffer(), rchannel._FrameBuffer()):
            out = []
            for i in range(0, len(blob), step):
                out.extend(buf.feed(blob[i:i + step]))
            assert out == msgs
    assert (PROTOCOL_MAGIC, PROTOCOL_VERSION) == \
        (rchannel.PROTOCOL_MAGIC, rchannel.PROTOCOL_VERSION)


def _handshaken_pair(listener: TcpListener, **chan_kw):
    """Dial the listener like a worker would; return (driver_chan, sock).
    The hello is JSON — the driver never unpickles pre-auth bytes."""
    host, port = listener.address.rsplit(":", 1)
    sock = socket.create_connection((host, int(port)))
    _send_frame(sock, json.dumps(
        {"magic": PROTOCOL_MAGIC, "version": PROTOCOL_VERSION,
         "token": None, "host": "far-host", "pid": os.getpid(),
         "has_graph": True}).encode("utf-8"))
    server_sock, hello = listener.get_worker(timeout=10.0)
    assert hello["host"] == "far-host"
    return TcpChannel(server_sock, **chan_kw), sock


def test_tcp_channel_heartbeat_death_and_goodbye():
    """A silent TCP peer is dead after heartbeat_timeout — but a peer that
    said an explicit goodbye is a clean exit, never a crash."""
    listener = TcpListener("127.0.0.1:0")
    try:
        chan, sock = _handshaken_pair(listener, heartbeat_timeout=0.3)
        assert chan.dead() is None
        time.sleep(0.5)
        reason = chan.dead()
        assert reason is not None and "heartbeat" in reason
        # a goodbye frame absolves the silence; the reference's framing
        # sends it here, so the two packages speak one wire format
        rchannel._send_frame(sock, pickle.dumps(("bye", 0), protocol=5))
        time.sleep(0.05)
        assert chan.recv_available() == [("bye", 0)]
        time.sleep(0.5)
        assert chan.dead() is None      # clean shutdown, not a crash
        chan.close()
        sock.close()
    finally:
        listener.close()


def test_tcp_channel_backpressure_bounds_sends():
    """A peer that stops draining must surface as ChannelClosed from send
    (bounded outbox), not wedge the caller in a blocking sendall."""
    listener = TcpListener("127.0.0.1:0")
    try:
        chan, sock = _handshaken_pair(
            listener, outbox_size=1, send_timeout=0.2)
        payload = ("blob", b"x" * (4 << 20))    # beyond loopback buffers
        with pytest.raises(ChannelClosed, match="backpressure"):
            for _ in range(64):
                chan.send(payload)
        chan.close()
        sock.close()
    finally:
        listener.close()


def test_listener_rejects_bad_token_and_version():
    listener = TcpListener("127.0.0.1:0", token="s3cret")
    try:
        with pytest.raises(ChannelClosed, match="rejected"):
            dial_driver(listener.address, token="wrong", timeout=5.0,
                        has_graph=True)

        def good_dial():
            try:        # no welcome ever comes back in this unit test
                dial_driver(listener.address, token="s3cret",
                            timeout=5.0, has_graph=True)
            except ChannelClosed:
                pass

        threading.Thread(target=good_dial, daemon=True).start()
        _, hello = listener.get_worker(timeout=10.0)
        assert hello["token"] == "s3cret"
    finally:
        listener.close()


# ----------------------------------------------- localhost-TCP differential

def test_tcp_channel_differential_50_node():
    g = exec_dag(42, 50, 0.3)
    seq = execute_sequential(g)
    ex = ClusterExecutor(2, channel="tcp")
    try:
        assert ex.run(g) == seq
        assert ex.stats["dispatched"] >= 50
        assert ex.stats["failures"] == 0
    finally:
        ex.close()


def test_tcp_channel_arrays_and_tcp_transport_bit_identical():
    """Control plane AND data plane over TCP: float32 tensors bit for bit,
    bulk bytes moving worker-to-worker over direct TCP pulls."""
    g = array_dag(7, 18, 0.4, elems=1 << 16)
    seq = execute_sequential(g)
    ex = ClusterExecutor(2, channel="tcp", transport="tcp")
    try:
        res = ex.run(g)
        assert results_equal(res, seq)
        assert ex.transport_used == "tcp"
        assert ex.stats["transfers_direct"] > 0
        assert ex.stats["bytes_direct"] > 0
    finally:
        ex.close()


def test_tcp_transport_on_pipe_channel_matches_oracle():
    g = array_dag(11, 14, 0.4, elems=1 << 15)
    seq = execute_sequential(g)
    ex = ClusterExecutor(2, transport="tcp", shm_threshold=1)
    assert results_equal(ex.run(g), seq)
    assert ex.stats["transfers_direct"] > 0


def test_tcp_channel_sigkill_heartbeat_recovery():
    """SIGKILL a TCP worker mid-run: the socket/heartbeat path sees the
    death and lineage recovery still matches the oracle."""
    g = array_dag(13, 24, 0.4, elems=1 << 14)
    seq = execute_sequential(g)
    ex = ClusterExecutor(3, channel="tcp", fail_worker=(1, 2))
    try:
        res = ex.run(g)
        assert results_equal(res, seq)
        assert ex.stats["failures"] == 1
        assert ex.stats["recomputed"] > 0
        assert len(ex.recovery_events) >= 1
    finally:
        ex.close()


def test_tcp_channel_outputs_only_gc():
    g = exec_dag(5, 60, 0.3)
    seq = execute_sequential(g)
    want = {t: seq[t] for t in g.outputs}
    ex = ClusterExecutor(2, channel="tcp", outputs_only=True)
    try:
        assert ex.run(g) == want
        assert ex.stats["dropped"] > 0
    finally:
        ex.close()


def test_spawned_tcp_dialers_start_together():
    """The port's case: a spawned tcp pool starts every dialer before it
    adopts the first (each imports torch before it dials), and adopts them
    in order: the run matches the oracle with every worker adopted, none
    joined."""
    g = picklable_dag(5, 40, 0.3)
    seq = execute_sequential(g)
    ex = ClusterExecutor(3, channel="tcp", start_method="spawn",
                         progress_timeout=120.0, accept_timeout=120.0)
    try:
        assert ex.run(g) == seq
        assert ex.stats["joins"] == 0 and ex.stats["failures"] == 0
        assert ex.start_method == "spawn"
    finally:
        ex.close()


# -------------------------------------------------------------- elasticity

def test_elastic_join_under_sock_transport():
    """add_worker/join_after under transport='sock' — join two workers
    mid-run, then SIGKILL one of the joiners."""
    if not hasattr(socket, "AF_UNIX"):
        pytest.skip("no unix sockets here")
    g = exec_dag(11, 120, 0.25)
    seq = execute_sequential(g)
    # joiners get wids 2 and 3; kill wid 2 after its 2nd completion
    ex = ClusterExecutor(2, transport="sock", shm_threshold=1,
                         join_after=(20, 2), fail_worker=(2, 2))
    assert ex.run(g) == seq
    assert ex.stats["joins"] == 2
    assert ex.stats["failures"] == 1


def test_elastic_join_tcp_channel_then_kill_joiner():
    g = exec_dag(17, 120, 0.25)
    seq = execute_sequential(g)
    ex = ClusterExecutor(2, channel="tcp", join_after=(15, 1),
                         fail_worker=(2, 2))
    try:
        assert ex.run(g) == seq
        assert ex.stats["joins"] == 1
        assert ex.stats["failures"] == 1
    finally:
        ex.close()


def _mh_exit_now(*a, **kw):
    os._exit(3)


def test_dead_local_dialer_fails_fast(monkeypatch):
    """A dialer that dies at bootstrap must fail the run immediately with
    its exit code, not hang out the whole accept_timeout."""
    import repro_torch.cluster.executor as exmod

    monkeypatch.setattr(exmod, "tcp_worker_main", _mh_exit_now)
    ex = ClusterExecutor(1, channel="tcp", accept_timeout=60.0)
    t0 = time.monotonic()
    try:
        with pytest.raises(RuntimeError, match="before dialing"):
            ex.run(exec_dag(1, 5, 0.3))
        assert time.monotonic() - t0 < 20.0
    finally:
        ex.close()


def test_add_worker_idle_grows_tcp_pool():
    ex = ClusterExecutor(1, channel="tcp")
    try:
        ex.add_worker()
        assert ex.n_workers == 2
        g = exec_dag(23, 40, 0.3)
        assert ex.run(g) == execute_sequential(g)
    finally:
        ex.close()


# ----------------------------------------------------------- repro-worker

def test_repro_worker_dialed_pool_differential():
    """Workers started by the repro-worker CLI (fresh interpreters, graph
    shipped in the welcome frame) match the oracle."""
    g = picklable_dag(3, 50, 0.3)
    seq = execute_sequential(g)
    ex = ClusterExecutor(workers=["remote", "remote"])
    procs = [start_repro_worker(ex.address) for _ in range(2)]
    try:
        assert ex.run(g) == seq
        assert ex.stats["dispatched"] >= 50
    finally:
        for p in procs:
            assert p.wait(timeout=30) == 0      # explicit goodbye, rc 0
        ex.close()


def test_fig2_tensors_on_a_dialed_pool_over_the_tcp_data_plane():
    """The port's case: two ``repro-worker`` processes serve the Fig. 2
    DAG (torch tensors drawn from numpy, module-level task bodies), its
    values pulled worker to worker over TCP: bit for bit the sequential
    run, one ``mul`` task run a unit."""
    g, _ = trace(matrix_driver, 4, 32, device="cpu")
    seq = execute_sequential(g)
    ex = ClusterExecutor(workers=["remote", "remote"], transport="tcp",
                         shm_threshold=1, accept_timeout=60.0)
    procs = [start_repro_worker(ex.address) for _ in range(2)]
    try:
        assert results_equal(ex.run(g), seq)
        assert ex.transport_used == "tcp"
        assert ex.stats["bytes_direct"] > 0
        assert ex.stats["tasks_run"] == {"gen": 8, "mul": 4, "reduce": 1}
    finally:
        for p in procs:
            assert p.wait(timeout=30) == 0
        ex.close()


def test_remote_rejects_unpicklable_graph_with_clear_error():
    g = exec_dag(1, 8, 0.4)                 # closures: not picklable
    ex = ClusterExecutor(workers=["remote"], accept_timeout=30.0)
    proc = start_repro_worker(ex.address)
    try:
        with pytest.raises(ValueError, match="not picklable"):
            ex.run(g)
        assert proc.wait(timeout=30) != 0   # worker saw the reject
    finally:
        if proc.poll() is None:
            proc.kill()
        ex.close()


# ------------------------------------------------------ transport matrix

def test_remote_pool_refuses_host_local_transports():
    with pytest.raises(ValueError, match="host-local"):
        ClusterExecutor(workers=["remote"], transport="shm")
    with pytest.raises(ValueError, match="host-local"):
        serde.resolve_transport("sock", multihost=True)
    assert serde.resolve_transport("auto", multihost=True) == "tcp"
    assert serde.resolve_transport("driver", multihost=True) == "driver"


def test_launcher_transport_validation():
    """--transport/--channel are validated against what the chosen backend
    supports, with a named error instead of a deep KeyError."""
    import argparse

    from repro_torch.launch.backend import (add_backend_args,
                                            validate_backend_args)

    ap = argparse.ArgumentParser()
    add_backend_args(ap)
    ok = ap.parse_args(["--backend", "process", "--transport", "tcp",
                        "--channel", "tcp"])
    validate_backend_args(ok)               # no error
    bad = ap.parse_args(["--backend", "thread", "--transport", "shm"])
    with pytest.raises(SystemExit, match="thread"):
        validate_backend_args(bad)
    bad2 = ap.parse_args(["--backend", "thread", "--channel", "tcp"])
    with pytest.raises(SystemExit, match="channel"):
        validate_backend_args(bad2)
    with pytest.raises(SystemExit):         # argparse rejects unknown names
        ap.parse_args(["--backend", "process", "--transport", "warp"])
    with pytest.raises(ValueError, match="channel"):
        ClusterExecutor(2, channel="quantum")
    with pytest.raises(ValueError, match="remote workers"):
        ClusterExecutor(workers=["remote"], channel="pipe")
    from repro_torch.core import make_executor
    with pytest.raises(ValueError, match="process"):
        make_executor("thread", 2, transport="shm")
    with pytest.raises(ValueError, match="process"):
        make_executor("thread", 2, channel="tcp")


# ----------------------------------------------------- peer-socket hygiene

def test_sweep_peer_sockets_removes_stale_files(tmp_path):
    d = tmp_path / "rrpeerXYZ"
    d.mkdir()
    for i in range(3):
        (d / f"w{i}.sock").write_bytes(b"")
    (d / "straggler.txt").write_text("x")
    assert serde.sweep_peer_sockets(str(d)) == 3
    assert not d.exists()
    assert serde.sweep_peer_sockets(str(d)) == 0    # idempotent


def test_sock_run_leaves_no_peer_dir_even_after_sigkill(monkeypatch):
    """The shutdown sweep takes the peer-socket tmpdir with the same
    hygiene as /dev/shm — including sockets of SIGKILL'd workers that
    never ran their own close()."""
    if not hasattr(socket, "AF_UNIX"):
        pytest.skip("no unix sockets here")
    import tempfile as _tf

    made = []
    real = _tf.mkdtemp

    def spy(*a, **kw):
        path = real(*a, **kw)
        made.append(path)
        return path

    monkeypatch.setattr("repro_torch.cluster.executor.tempfile.mkdtemp",
                        spy)
    g = exec_dag(31, 60, 0.3)
    ex = ClusterExecutor(2, transport="sock", shm_threshold=1,
                         fail_worker=(0, 2))
    assert ex.run(g) == execute_sequential(g)
    assert ex.stats["failures"] == 1
    assert made, "sock transport should have made a peer dir"
    for path in made:
        assert not os.path.exists(path), f"peer dir leaked: {path}"


def test_peer_server_binds_over_stale_socket_file(tmp_path):
    stale = tmp_path / "w0.sock"
    srv = serde.PeerServer(str(stale), {0: 123})
    srv.close()
    stale.write_bytes(b"")                   # simulate a leftover file
    srv2 = serde.PeerServer(str(stale), {0: 456})
    got = serde.peer_fetch(serde.PeerRef(str(stale), 0, 8, 0))
    assert got == 456
    srv2.close()


def test_tcp_peer_server_roundtrip():
    value = torch.arange(1000, dtype=torch.int64)
    store = {7: value}
    srv = serde.PeerServer(None, store, advertise_host="127.0.0.1")
    assert srv.path.startswith("tcp://")
    ref = serde.PeerRef(srv.path, 7, 8000, 0, secret=srv.secret)
    got = serde.peer_fetch(ref)
    assert torch.equal(got, value) and got.dtype == value.dtype
    with pytest.raises(serde.TransferLost):
        serde.peer_fetch(serde.PeerRef(srv.path, 99, 8, 0,
                                       secret=srv.secret))
    # the capability gate: no secret / a wrong secret gets nothing
    with pytest.raises(serde.TransferLost):
        serde.peer_fetch(serde.PeerRef(srv.path, 7, 8000, 0))
    with pytest.raises(serde.TransferLost):
        serde.peer_fetch(serde.PeerRef(srv.path, 7, 8000, 0,
                                       secret="f" * 32), timeout=3.0)
    srv.close()
    # "fetch from a closed server" is asserted via the unix family: some
    # sandboxed loopback stacks fake-accept TCP connects to closed ports,
    # which peer_fetch maps to TransferLost anyway (corrupt stream)
    with pytest.raises(serde.TransferLost):
        serde.peer_fetch(serde.PeerRef("/nonexistent/peer.sock", 7, 8, 0),
                         timeout=2.0)


def test_no_shm_leak_on_tcp_channel(tmp_path):
    if not serde.shm_available():
        pytest.skip("no shared memory in this environment")
    g = exec_dag(41, 60, 0.3)
    ex = ClusterExecutor(2, channel="tcp", transport="shm", shm_threshold=1,
                         fail_worker=(1, 3))
    try:
        assert ex.run(g) == execute_sequential(g)
    finally:
        ex.close()
    assert not glob.glob(f"/dev/shm/{ex.seg_prefix}*")


# -------------------------------------------------- per-host locality

def _locality_graph(core_mod, Ref):
    g = core_mod.TaskGraph()
    g.add_node("big", lambda: 0, (), {}, core_mod.TaskKind.PURE, deps=(),
               cost=1.0)
    g.add_node("use", lambda x: x, (Ref(0),), {}, core_mod.TaskKind.PURE,
               deps=[0], cost=1.0)
    g.mark_output(1)
    return g


def test_scheduler_worker_host_locality_groups():
    """Same-host workers are near (shm-priced), cross-host ones far
    (TCP-priced): the consumer of a big value whose owner is busy should
    fall to the owner's host-mate, not to the distant idle worker — in
    both packages."""
    import repro.core as rcore
    import repro_torch.core as pcore
    from repro.core.tracing import RemappedRef as RRef
    kw = dict(done={0: 0.0}, placed={0: 1},
              data_sizes={0: 1 << 23}, bandwidth=float(1 << 20),
              worker_speed=[1.0, 0.01, 1.0])    # the owner is very slow
    for sched, g in ((list_schedule, _locality_graph(pcore, _Ref)),
                     (rsched.list_schedule, _locality_graph(rcore, RRef))):
        near = sched(g, 3, worker_host=["A", "B", "B"], **kw)
        assert near.placements[1].worker == 2       # host-mate of the bytes
        far = sched(g, 3, worker_host=["A", "B", "C"], **kw)
        assert far.placements[1].worker == 0        # all moves equally far
        with pytest.raises(ValueError, match="worker_host"):
            sched(g, 3, worker_host=["A", "B"], **kw)


def test_objectstore_tracks_hosts():
    from repro_torch.cluster import DriverObjectStore

    g = exec_dag(2, 4, 0.5)
    store = DriverObjectStore(g)
    store.add_worker(0, host="A")
    store.add_worker(1, host="B")
    store.record(0, 0, nbytes=8)
    assert store.on_host(0, "A") and not store.on_host(0, "B")
    store.record_replica(0, 1)
    assert store.on_host(0, "B")
    store.drop_worker(0)
    assert not store.on_host(0, "A") and store.on_host(0, "B")


# ------------------------------------------------ driver restart (tentpole)

def test_tcp_driver_kill_workers_rejoin_and_resume(tmp_path):
    """Emulate a driver SIGKILL (raw socket teardown), start a NEW executor
    resuming the run — every forked worker survives the outage, re-dials
    the rebound address, and is re-adopted with its object store intact,
    so the resume needs no fresh spawns, no deaths, and no
    recomputation."""
    from repro_torch.cluster import DriverKilled
    g = exec_dag(31, 150, 0.25, sleep=0.002)
    seq = execute_sequential(exec_dag(31, 150, 0.25))
    ex = ClusterExecutor(3, channel="tcp", checkpoint_dir=str(tmp_path),
                         checkpoint_interval=0.0, fail_driver=40)
    with pytest.raises(DriverKilled):
        ex.run(g)
    assert ex.run_id

    t0 = time.monotonic()
    ex2 = ClusterExecutor(3, channel="tcp", checkpoint_dir=str(tmp_path),
                          resume=ex.run_id, rejoin_timeout=8.0)
    try:
        assert ex2.run(g) == seq
        wall = time.monotonic() - t0
        assert ex2.stats["joins"] == 0 and ex2.stats["failures"] == 0
        assert ex2.stats["resumed_clusters"] > 0
        assert ex2.stats["recomputed"] == 0     # worker stores survived
        # every survivor must rejoin PROMPTLY
        assert wall < 6.0, f"rejoin barrier stalled: {wall:.1f}s"
    finally:
        ex2.close()


def test_tcp_resume_worker_lost_in_outage_single_recovery_plan(tmp_path):
    """A worker SIGKILL'd DURING the driver outage: the resumed driver
    reconciles checkpoint claims against rejoin inventories and issues
    exactly ONE recovery plan for the loss, then backfills the pool."""
    from repro_torch.cluster import DriverKilled
    g = picklable_dag(13, 100, 0.3)
    seq = execute_sequential(g)
    ex = ClusterExecutor(workers=["remote", "remote"],
                         checkpoint_dir=str(tmp_path),
                         checkpoint_interval=0.0, fail_driver=30,
                         accept_timeout=30.0)
    procs = [start_repro_worker(ex.address) for _ in range(2)]
    try:
        with pytest.raises(DriverKilled):
            ex.run(g)
        procs[0].kill()                 # dies while no driver is watching
        procs[0].wait(timeout=10)

        ex2 = ClusterExecutor(workers=["remote", "remote"],
                              checkpoint_dir=str(tmp_path),
                              resume=ex.run_id, rejoin_timeout=4.0)
        try:
            assert ex2.run(g) == seq
            outage = [e for e in ex2.recovery_events
                      if e["worker"] == "driver-outage"]
            assert len(ex2.recovery_events) == len(outage) <= 1
        finally:
            ex2.close()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)


def test_repro_driver_real_sigkill_then_resume_latest(tmp_path):
    """A ``repro_torch.launch.driver`` subprocess is SIGKILL'd mid-run, its
    fork-started workers keep running, and a second driver with
    ``--resume latest`` rebinds the address, re-adopts them, and finishes
    bit for bit."""
    ckpt = str(tmp_path)
    base = [sys.executable, "-m", "repro_torch.launch.driver",
            "--graph", "_torch_runtime:_dk_slow_graph",
            "--workers", "2", "--checkpoint-dir", ckpt,
            "--checkpoint-interval", "0.05",
            "--out", os.path.join(ckpt, "out.pkl")]
    p = subprocess.Popen(base, env=WORKER_ENV, cwd=REPO,
                         stdout=subprocess.PIPE, text=True)
    try:
        assert "listening" in p.stdout.readline()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            logs = glob.glob(os.path.join(ckpt, "*.log"))
            if logs and os.path.getsize(logs[0]) > 600:
                break
            time.sleep(0.01)
            assert p.poll() is None, "driver finished before the kill"
        p.send_signal(signal.SIGKILL)
        assert p.wait(timeout=30) != 0
    finally:
        if p.poll() is None:
            p.kill()

    r = subprocess.run(base + ["--resume", "latest"], env=WORKER_ENV,
                       cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "resuming" in r.stdout
    with open(os.path.join(ckpt, "out.pkl"), "rb") as f:
        got = pickle.load(f)
    assert results_equal(got, execute_sequential(picklable_dag(9, 80, 0.3)))


# ----------------------------------------------------- stale-segment sweep

def test_sweep_stale_segments_scoped_to_dead_owners(tmp_path):
    """The startup sweep removes ``rr*`` segments whose embedded driver pid
    is dead, keeps live-owner segments and anything it cannot
    attribute."""
    d = str(tmp_path)
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    live_pid, dead_pid = os.getpid(), dead.pid
    names = {
        "stale_worker": f"rr{dead_pid:x}0123abcdw3_7",
        "stale_driver": f"rr{dead_pid:x}0123abcdd_0",
        "stale_bare": f"rr{dead_pid:x}0123abcd",
        "live": f"rr{live_pid:x}0123abcdw0_1",
        "unparseable": "rrnothexatallw0_1",
        "foreign": "somethingelse.bin",
    }
    for n in names.values():
        with open(os.path.join(d, n), "wb") as f:
            f.write(b"x")
    assert serde.sweep_stale_segments(d) == 3
    left = set(os.listdir(d))
    assert left == {names["live"], names["unparseable"], names["foreign"]}
    assert serde.sweep_stale_segments(d) == 0       # idempotent
