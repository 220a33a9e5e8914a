"""The port's multi-tenant gateway (``repro_torch/gateway/``) on the CPU:
concurrent tenants on one shared resident pool, each bit for bit equal to
``execute_sequential``; typed quota rejection; fault and disconnect
isolation between tenants; session restore from the run log.

The reference's ``tests/test_gateway.py`` cases, over module-level torch
task bodies (16 KiB float32 tensors, so values cross through shared
memory), plus the port's own: the Fig. 2 DAG through the gateway, each
job's own kernel launches, tensors in a result frame, and ``serve
--gateway``.  Workers are forked; every pool passes a short
``progress_timeout``, so a hang becomes the executor's diagnostic error.
"""
import pickle
import random
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as rcore                                       # noqa: E402
from repro_torch.config import ClusterConfig                     # noqa: E402
from repro_torch.core import (TaskGraph, TaskKind,                # noqa: E402
                              execute_sequential, run_graph, trace)
from repro_torch.core.tracing import RemappedRef as Ref          # noqa: E402
from repro_torch.gateway import (GatewayError, GatewayService,   # noqa: E402
                                 QuotaExceeded, SessionClosed,
                                 TenantQuota, connect)
from repro_torch.kernels import matmul as kmm                    # noqa: E402
from repro_torch.launch import serve                             # noqa: E402
from repro_torch.workloads import matrix_driver                  # noqa: E402

from test_torch_cluster import (_counting_matmul, _tensor_node,  # noqa: E402
                                results_equal)
from test_torch_fusion import fig2_dag                           # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

TOKEN = "gw-test-token"
TIMEOUT = 15.0          # seconds without progress before a pool fails


def cfg(**kw) -> ClusterConfig:
    kw.setdefault("n_workers", 2)
    kw.setdefault("token", TOKEN)
    kw.setdefault("progress_timeout", TIMEOUT)
    return ClusterConfig(**kw)


def _slow_tensor_node(*xs, _i=0):
    """``_tensor_node``, padded to keep a job in flight for a while."""
    time.sleep(0.03)
    return _tensor_node(*xs, _i=_i)


def dag(seed: int, n: int, p: float, slow: bool = False) -> TaskGraph:
    """Random DAG of module-level tensor task bodies (picklable, so the
    graph ships to the gateway's pool)."""
    rng = random.Random(seed)
    fn = _slow_tensor_node if slow else _tensor_node
    g = TaskGraph()
    for i in range(n):
        deps = [j for j in range(i) if rng.random() < p][-3:]
        g.add_node(f"t{i}", fn, tuple(Ref(d) for d in deps), {"_i": i},
                   TaskKind.PURE, deps=deps, cost=1.0, out_bytes=16384)
    g.mark_output(n - 1)
    return g


@pytest.fixture(scope="module")
def gateway():
    """One shared 2-worker gateway for the module; each test uses its own
    tenant names so accounting stays independent."""
    gw = GatewayService(cfg(fuse="auto"), quotas={
        "tiny": TenantQuota(max_inflight_clusters=1),
        "thin": TenantQuota(max_store_bytes=10),
    }).start()
    yield gw
    gw.stop()


# ------------------------------------------------- concurrent tenants

def test_two_tenants_concurrent_bit_for_bit(gateway):
    """Two tenants submit from separate sessions at once; every result
    equals the sequential oracle for that tenant's graph."""
    ga, gb = dag(1, 40, 0.3), dag(2, 35, 0.35)
    seq_a, seq_b = execute_sequential(dag(1, 40, 0.3)), \
        execute_sequential(dag(2, 35, 0.35))
    out, errs = {}, []

    def tenant(name, g, priority):
        try:
            with connect(gateway.address, token=TOKEN, tenant=name,
                         priority=priority) as c:
                futs = [c.submit(g, label=f"{name}{i}") for i in range(3)]
                out[name] = [f.result(60) for f in futs]
                out[name + "_stats"] = futs[0].stats
        except BaseException as e:       # surface into the test thread
            errs.append(e)

    threads = [threading.Thread(target=tenant, args=("alpha", ga, 1.0)),
               threading.Thread(target=tenant, args=("beta", gb, 2.0))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(90)
    assert not errs, errs
    assert all(results_equal(r, seq_a) for r in out["alpha"])
    assert all(results_equal(r, seq_b) for r in out["beta"])
    st = out["beta_stats"]
    assert st["tenant"] == "beta"
    assert st["submit_to_gather_s"] >= st["submit_to_first_dispatch_s"] >= 0
    assert sum(st["tasks_run"].values()) == 35    # every task of its own

    s = gateway.stats()
    assert s["alpha"]["completed"] >= 3 and s["beta"]["completed"] >= 3
    slo = s["beta"]["slo"]["submit_to_gather_s"]
    assert slo["p50"] is not None and slo["p99"] >= slo["p50"]
    assert "pool" in s and s["pool"]["n_workers"] == 2


def test_run_graph_connect_oneliner(gateway):
    g = dag(3, 25, 0.3)
    res, rep = run_graph(g, connect=gateway.address, token=TOKEN,
                         with_report=True)
    assert results_equal(res, execute_sequential(dag(3, 25, 0.3)))
    assert rep["backend"] == "gateway"
    assert rep["stats"]["submit_to_gather_s"] > 0


# ----------------------------------------------------- admission gate

def test_cluster_quota_is_a_typed_client_error(gateway):
    """Over-quota submits come back as QuotaExceeded with the admission
    attributes intact, not a stringly RuntimeError."""
    with connect(gateway.address, token=TOKEN, tenant="tiny") as c:
        fut = c.submit(dag(4, 10, 0.0))
        err = fut.exception(30)
        assert isinstance(err, QuotaExceeded), err
        assert err.tenant == "tiny"
        assert err.resource == "inflight_clusters"
        assert err.limit == 1 and err.requested > 1
        # the typed error survives another pickle hop (supervisors relay)
        again = pickle.loads(pickle.dumps(err))
        assert isinstance(again, QuotaExceeded) and again.limit == 1
    assert gateway.stats()["tiny"]["rejected"] >= 1
    assert gateway.stats()["tiny"]["inflight_clusters"] == 0


def test_store_bytes_quota_uses_declared_bytes(gateway):
    g = TaskGraph()
    g.add_node("big", _tensor_node, (), {"_i": 9}, TaskKind.PURE, deps=(),
               out_bytes=1 << 20)
    g.mark_output(0)
    with connect(gateway.address, token=TOKEN, tenant="thin") as c:
        err = c.submit(g).exception(30)
        assert isinstance(err, QuotaExceeded), err
        assert err.resource == "store_bytes" and err.limit == 10


def test_pool_level_knob_rejected_before_unpickle(gateway):
    """A submit smuggling a non-TENANT_FIELDS option is refused server
    side (forged on the wire: the client API never sends one)."""
    from repro_torch.cluster.channel import _send_frame
    from repro_torch.cluster.futures import ClusterFuture

    with connect(gateway.address, token=TOKEN, tenant="alpha") as c:
        fut = ClusterFuture("forged")
        with c._lock:
            c._pending[9999] = fut
        blob = pickle.dumps((dag(5, 4, 0.0), {}), protocol=5)
        _send_frame(c._sock,
                    pickle.dumps(("submit", 9999, blob,
                                  {"transport": "tcp"}), protocol=5),
                    lock=c._send_lock)
        err = fut.exception(30)
        assert isinstance(err, GatewayError), err
        assert "not tenant-settable" in str(err)


# ------------------------------------------------------- isolation

def test_disconnect_cancels_only_that_tenants_jobs(gateway):
    """A hard socket drop (no bye) fails the dropper's futures with
    SessionClosed and must not perturb the surviving tenant."""
    seq = execute_sequential(dag(6, 30, 0.3))
    c1 = connect(gateway.address, token=TOKEN, tenant="dropper")
    c2 = connect(gateway.address, token=TOKEN, tenant="stayer")
    try:
        f1 = c1.submit(dag(7, 60, 0.2, slow=True))
        f2 = c2.submit(dag(6, 30, 0.3))
        c1._sock.close()                       # hard drop, no bye
        assert results_equal(f2.result(60), seq), "survivor perturbed"
        assert isinstance(f1.exception(10), SessionClosed)
    finally:
        c2.close()
        c1.close()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:         # server cancel is async
        if gateway.stats()["dropper"]["inflight_jobs"] == 0:
            break
        time.sleep(0.05)
    assert gateway.stats()["dropper"]["inflight_jobs"] == 0


def test_sigkilled_worker_task_does_not_perturb_other_tenant():
    """One tenant's task dies with the worker (SIGKILL mid-run); both
    tenants still gather bit for bit, and neither job fails."""
    ga = dag(8, 30, 0.3, slow=True)           # victim: long enough to hit
    gb = dag(9, 30, 0.3)
    seq_a = execute_sequential(dag(8, 30, 0.3, slow=True))
    seq_b = execute_sequential(dag(9, 30, 0.3))
    with GatewayService(cfg()) as gw:
        with connect(gw.address, token=TOKEN, tenant="victim") as ca, \
                connect(gw.address, token=TOKEN, tenant="bystander") as cb:
            fa = ca.submit(ga)
            fbs = [cb.submit(gb) for _ in range(2)]
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline:  # wait until work is live
                st = gw.stats().get("victim", {})
                if st.get("inflight_clusters", 0) > 0:
                    break
                time.sleep(0.02)
            gw.executor.kill_worker(1)          # SIGKILL mid-run
            assert results_equal(fa.result(120), seq_a)
            assert all(results_equal(f.result(120), seq_b) for f in fbs)
        s = gw.stats()
        assert s["victim"]["failed"] == 0       # recovered, not failed
        assert s["bystander"]["failed"] == 0
        assert s["pool"]["stats"]["failures"] == 1


# --------------------------------------------------------- restore

def test_resume_restores_sessions_on_a_fresh_run(tmp_path):
    """Open sessions journal to the run log; a gateway restarted with
    resume= re-creates their quotas/weights on a FRESH pool run id."""
    from repro_torch.checkpoint.runlog import latest_run, load_run

    config = cfg(checkpoint_dir=str(tmp_path), checkpoint_interval=0.05)
    g = dag(10, 20, 0.3)
    seq = execute_sequential(dag(10, 20, 0.3))

    gw1 = GatewayService(config, quotas={
        "alpha": TenantQuota(max_inflight_clusters=64)}).start()
    c_open = connect(gw1.address, token=TOKEN, tenant="alpha",
                     priority=3.0)
    try:
        assert results_equal(c_open.submit(g).result(60), seq)
        with connect(gw1.address, token=TOKEN, tenant="gone") as c2:
            assert results_equal(c2.submit(g).result(60), seq)
        time.sleep(0.3)              # let the sessionend record flush
    finally:
        gw1.stop()                   # crash-equivalent: no client bye
        c_open.close()

    run1 = latest_run(str(tmp_path))
    state = load_run(str(tmp_path / f"{run1}.log"))
    assert "alpha" in state.sessions            # still open at shutdown
    assert "gone" not in state.sessions         # closed cleanly
    assert state.sessions["alpha"]["quota"]["max_inflight_clusters"] == 64
    assert state.sessions["alpha"]["priority"] == 3.0
    assert not state.jobs, f"jobs should all be retired: {state.jobs}"

    with GatewayService(config.replace(resume=run1)) as gw2:
        s = gw2.stats()
        assert s["alpha"]["quota"]["max_inflight_clusters"] == 64
        assert gw2.executor.run_id != run1      # fresh incarnation
        with connect(gw2.address, token=TOKEN, tenant="alpha") as c:
            assert results_equal(c.submit(g).result(60), seq)


# ------------------------------------------------ the port's own cases

def test_fig2_dag_through_the_gateway_matches_sequential_and_reference(
        gateway):
    """8 units of 64x64: bit for bit the port's sequential run, within
    2e-5 of the reference's numpy run."""
    g, _ = trace(matrix_driver, 8, 64, device="cpu")
    seq = execute_sequential(g)
    with connect(gateway.address, token=TOKEN, tenant="fig2") as c:
        fut = c.submit(g, label="fig2")
        got = fut.result(60)
    assert results_equal(got, seq)
    assert fut.stats["tasks_run"] == {"gen": 16, "mul": 8, "reduce": 1}
    ref_graph = fig2_dag("ref", 8, 64)
    ref = rcore.execute_sequential(ref_graph)
    assert [n.name for n in ref_graph] == [n.name for n in g]
    for node in g:
        want = ref[node.tid]
        if node.name == "reduce":
            assert got[node.tid] == pytest.approx(want, rel=2e-5)
        else:
            np.testing.assert_allclose(got[node.tid].numpy() / 8.0,
                                       want / 8.0, rtol=2e-5, atol=2e-5)


def test_each_job_reports_its_own_kernel_launches(monkeypatch):
    """Two tenants' Fig. 2 jobs of different sizes run at once on one
    pool; each job's stats carry the matmul launches of its own ``mul``
    tasks, as its workers reported them, and this process launched none."""
    counting = _counting_matmul()
    monkeypatch.setattr(kmm, "matmul", counting)   # the forked pool inherits
    units = {"a": 4, "b": 7}
    graphs = {t: trace(matrix_driver, n, 32, device="cpu")[0]
              for t, n in units.items()}
    with GatewayService(cfg(fuse="auto")) as gw:
        clients = {t: connect(gw.address, token=TOKEN, tenant=t)
                   for t in units}
        try:
            futs = {t: clients[t].submit(graphs[t]) for t in units}
            got = {t: f.result(60) for t, f in futs.items()}
        finally:
            for c in clients.values():
                c.close()
    for t, n in units.items():
        stats = futs[t].stats
        assert stats["tenant"] == t
        assert stats["tasks_run"]["mul"] == n
        assert stats["kernel_launches"] == {
            "matmul": n, "matmul/simt": n, "matmul/vector": n}
        assert stats["recomputed"] == 0
        assert got[t].keys() == set(graphs[t].nodes)
    assert counting.launches == 0


def test_jobs_queued_out_of_id_order_keep_their_own_stats(monkeypatch):
    """The job that takes the lower id range is queued second (its
    submitter is held between the two steps): each job's stats still
    count its own tasks, and both results equal the sequential run."""
    from repro_torch.cluster import ClusterExecutor
    from repro_torch.cluster import executor as cex
    first_allocated, second_queued = threading.Event(), threading.Event()
    real = cex.offset_graph

    def held(graph, base, **kw):
        if base == 0:                 # the first range: wait for the second
            first_allocated.set()
            second_queued.wait(30)
        return real(graph, base, **kw)

    monkeypatch.setattr(cex, "offset_graph", held)
    ga, gb = dag(11, 20, 0.3), dag(12, 30, 0.3)
    ex = ClusterExecutor(config=cfg(fuse="auto"))
    ex.start_resident()
    try:
        futs = {}
        t = threading.Thread(target=lambda: futs.update(
            a=ex.submit_job(ga, tenant="a")))
        t.start()
        assert first_allocated.wait(30)
        futs["b"] = ex.submit_job(gb, tenant="b")
        second_queued.set()
        t.join(30)
        got = {k: f.result(60) for k, f in futs.items()}
    finally:
        ex.shutdown_resident()
        ex.close()
    assert results_equal(got["a"], execute_sequential(dag(11, 20, 0.3)))
    assert results_equal(got["b"], execute_sequential(dag(12, 30, 0.3)))
    assert futs["a"].stats["tasks_run"] == {f"t{i}": 1 for i in range(20)}
    assert futs["b"].stats["tasks_run"] == {f"t{i}": 1 for i in range(30)}


def _frame_f32():
    g = torch.Generator().manual_seed(1)
    return torch.randn(1024, 1024, generator=g)         # 4 MiB


def _frame_bf16():
    g = torch.Generator().manual_seed(2)
    return torch.randn(300, 257, generator=g).to(torch.bfloat16)


def test_tensors_cross_a_result_frame_as_host_bytes(gateway):
    """A 4 MiB float32 tensor and a bf16 one come back bit for bit with
    dtype and shape, and the frame holds their bytes about once."""
    g = TaskGraph()
    for name, fn in (("f32", _frame_f32), ("bf16", _frame_bf16)):
        g.mark_output(g.add_node(name, fn, (), {}, TaskKind.PURE, deps=()))
    want = {0: _frame_f32(), 1: _frame_bf16()}
    with connect(gateway.address, token=TOKEN, tenant="frames") as c:
        fut = c.submit(g)
        got = fut.result(60)
    assert got.keys() == want.keys()
    for tid, w in want.items():
        assert got[tid].dtype == w.dtype and got[tid].shape == w.shape
        assert got[tid].device == w.device
        bits = torch.int32 if w.element_size() == 4 else torch.int16
        assert torch.equal(got[tid].view(bits), w.view(bits))
    nbytes = sum(w.numel() * w.element_size() for w in want.values())
    assert nbytes <= fut.stats["result_bytes"] < nbytes + 4096
    assert fut.stats["result_encode_s"] >= 0
    assert fut.stats["result_decode_s"] >= 0


def test_serve_gateway_gives_the_thread_backends_traced_tokens(gateway):
    """``serve --gateway``: the traced request runs on the gateway's pool
    (whose workers draw the reduced model from the seed) and gives the
    thread backend's tokens, a prefix of request 0's."""
    argv = ["--arch", "qwen2-7b", "--reduced", "--device", "cpu",
            "--requests", "2", "--slots", "1", "--max-new", "4",
            "--show-graph"]
    local = serve.main(argv + ["--backend", "thread"])
    out = serve.main(argv + ["--gateway", gateway.address,
                             "--gateway-token", TOKEN, "--tenant", "serve"])
    req0 = min(out["finished"], key=lambda r: r.rid)
    assert len(out["traced_tokens"]) == 3
    assert out["traced_tokens"] == local["traced_tokens"] == req0.out[:3]
    stats = out["graph_stats"]
    assert stats["tenant"] == "serve"
    assert {k: stats["tasks_run"][k] for k in (
        "prefill", "decode", "respond")} == {"prefill": 1, "decode": 2,
                                             "respond": 1}
    assert stats["kernel_launches"] == {}        # the CPU: no kernel launch


def test_a_forked_resident_pool_is_up_when_start_resident_returns():
    """The resident driver forks its pool on its own thread, so
    ``start_resident`` returns only once it has: no fork overlaps the
    caller's next imports.  A worker forked while the caller's thread held
    a module's import lock hung in its first import of that module
    (``serve --gateway``'s recipe, reading its config by module name: 2 of
    108 runs of the isolation test's script, 8 at a time)."""
    import multiprocessing as mp
    from repro_torch.cluster.executor import ClusterExecutor
    before = set(mp.active_children())
    ex = ClusterExecutor(config=cfg(start_method="fork"))
    ex.start_resident()
    try:
        forked = [p for p in mp.active_children() if p not in before]
        assert len(forked) == 2 and all(p.is_alive() for p in forked)
    finally:
        ex.shutdown_resident()
        ex.close()
