"""The port's multi-process cluster runtime (``repro_torch/cluster/``) on the
CPU: every result bit for bit equal to ``execute_sequential``.

Workers are forked over pipes (the default ``start_method``), except where a
test says otherwise: one spawned run with tensor payloads, and one
``repro_torch.launch.remote`` worker that dials the driver over TCP.  The
Fig. 2 DAG is also held against the reference's numpy result.  Every run
passes a short ``progress_timeout``, so a hang becomes the executor's
diagnostic error instead of a stuck suite; no decision here reads a clock.
"""
import os
import random
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as rcore                                       # noqa: E402
from repro_torch.cluster import ClusterExecutor, DriverKilled   # noqa: E402
from repro_torch.config import ClusterConfig                     # noqa: E402
from repro_torch.core import (Executor, TaskFailed, TaskGraph,    # noqa: E402
                              TaskKind, execute_sequential,
                              make_executor, run_graph)
from repro_torch.core.fusion import fuse                          # noqa: E402
from repro_torch.core.tracing import RemappedRef as Ref          # noqa: E402
from repro_torch.kernels import matmul as kmm, ref as kref       # noqa: E402
from repro_torch.launch.driver import demo_graph                 # noqa: E402
from repro_torch.workloads import run_matrix_dag                 # noqa: E402

from test_torch_fusion import fig2_dag                           # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 15.0          # seconds without progress before the run fails
# the progress clock starts before the workers do, so a spawned pool's
# torch imports count against it: on a loaded host they take seconds each
SPAWN_TIMEOUT = 60.0


def cfg(**kw) -> ClusterConfig:
    kw.setdefault("progress_timeout", TIMEOUT)
    return ClusterConfig(**kw)


def _tensor_node(*xs, _i=0):
    acc = torch.arange(4096, dtype=torch.float32) * float(_i % 5 + 1)
    for x in xs:
        acc = acc * 0.5 + x
    return acc


def tensor_dag(seed: int, n: int, p: float) -> TaskGraph:
    """Random DAG whose values are 16 KiB float32 tensors (above the shm
    threshold at 4 KiB, so values cross through shared memory)."""
    rng = random.Random(seed)
    g = TaskGraph()
    for i in range(n):
        deps = [j for j in range(i) if rng.random() < p][-3:]
        g.add_node(f"t{i}", _tensor_node, tuple(Ref(d) for d in deps),
                   {"_i": i}, TaskKind.PURE, deps=deps,
                   cost=rng.uniform(0.1, 1.0), out_bytes=16384)
    g.mark_output(n - 1)
    return g


def same(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(a, b))
    return a == b


def results_equal(got, want) -> bool:
    return got.keys() == want.keys() and all(same(got[k], want[k])
                                             for k in got)


# ---------------------------------------------------------- differentials

@pytest.mark.parametrize("fuse", ["off", "auto"])
@pytest.mark.parametrize("graph", ["int200", "tensor60"])
def test_process_backend_matches_sequential(graph, fuse):
    make = {"int200": lambda: demo_graph(200, seed=3),
            "tensor60": lambda: tensor_dag(5, 60, 0.3)}[graph]
    g = make()
    seq = execute_sequential(make())
    got, report = run_graph(g, 3, backend="process", with_report=True,
                            config=cfg(fuse=fuse, shm_threshold=4096))
    assert results_equal(got, seq)
    stats = report["stats"]
    assert report["transport"] == "shm" and stats["recomputed"] == 0
    assert 0 < stats["first_done_s"] <= stats["last_done_s"] \
        <= report["wall_time"]
    if fuse == "auto":
        assert stats["tasks_fused"] > 0 and stats["n_clusters"] < len(g)
    else:
        assert stats["n_clusters"] == len(g)
    if graph == "tensor60":
        assert stats["bytes_direct"] > 0


@pytest.mark.parametrize("fuse", ["off", "auto"])
def test_sigkilled_worker_is_recovered_by_lineage(fuse):
    g = tensor_dag(9, 80, 0.3)
    seq = execute_sequential(tensor_dag(9, 80, 0.3))
    ex = ClusterExecutor(3, config=cfg(fuse=fuse, fail_worker=(1, 3)))
    try:
        assert results_equal(ex.run(g), seq)
    finally:
        ex.close()
    assert ex.stats["failures"] == 1 and ex.stats["recomputed"] >= 1
    assert ex.recovery_events


def test_driver_kill_then_resume_from_the_run_log(tmp_path):
    g = demo_graph(150, seed=7)
    seq = execute_sequential(demo_graph(150, seed=7))
    ex = ClusterExecutor(3, config=cfg(
        checkpoint_dir=str(tmp_path), checkpoint_interval=0.0,
        fail_driver=25))
    with pytest.raises(DriverKilled):
        ex.run(g)
    ex.close()
    assert ex.run_id
    ex2 = ClusterExecutor(3, config=cfg(checkpoint_dir=str(tmp_path),
                                        resume=ex.run_id))
    try:
        assert ex2.run(demo_graph(150, seed=7)) == seq
    finally:
        ex2.close()
    assert ex2.stats["resumed_clusters"] > 0


def test_fig2_on_cpu_tensors_matches_sequential_and_the_reference():
    """8 units of 64x64: bit for bit the sequential run, with fusion off,
    on and across a SIGKILL; within 2e-5 of the reference's numpy run."""
    graph, seq, _ = run_matrix_dag(8, 64, 1, device="cpu")
    for extra in ({"fuse": "off"}, {"fuse": "auto"},
                  {"fuse": "auto", "fail_worker": (1, 2)}):
        g, got, rep = run_matrix_dag(8, 64, 3, device="cpu",
                                     backend="process",
                                     config=cfg(n_workers=3, **extra))
        assert results_equal(got, seq), extra
        assert sum(1 for n in g if n.name == "mul") == 8
        if "fail_worker" in extra:
            assert rep["stats"]["recomputed"] >= 1
    ref_graph = fig2_dag("ref", 8, 64)
    ref = rcore.execute_sequential(ref_graph)
    assert [n.name for n in ref_graph] == [n.name for n in graph]
    for node in graph:
        want = ref[node.tid]
        if node.name == "reduce":
            assert seq[node.tid] == pytest.approx(want, rel=2e-5)
        else:
            np.testing.assert_allclose(seq[node.tid].numpy() / 8.0,
                                       want / 8.0, rtol=2e-5, atol=2e-5)


def _counting_matmul():
    """A stand-in for the matmul kernel's wrapper, for forked workers to
    inherit: it counts a launch as the wrapper does on the card, then
    returns the plain product."""
    def matmul(x, y):
        matmul.launches += 1
        matmul.route_launches["simt"] += 1
        matmul.variant_launches["vector"] += 1
        return kref.matmul(x, y)
    matmul.launches = 0
    matmul.route_launches = dict.fromkeys(kmm.ROUTES, 0)
    matmul.variant_launches = dict.fromkeys(kmm.VARIANTS, 0)
    return matmul


@pytest.mark.parametrize("extra", [{"fuse": "off"}, {"fuse": "auto"},
                                   {"fuse": "auto", "fail_worker": (1, 2)}])
def test_workers_report_the_kernel_launches_of_the_tasks_they_ran(
        monkeypatch, extra):
    """Each ``done`` carries the worker's launches: one matmul launch per
    ``mul`` task run, recomputed ones included, and none in the driver."""
    counting = _counting_matmul()
    monkeypatch.setattr(kmm, "matmul", counting)
    g, _, rep = run_matrix_dag(8, 64, 3, device="cpu", backend="process",
                               config=cfg(n_workers=3, **extra))
    stats = rep["stats"]
    plan = fuse(g, extra["fuse"])
    redo = sum(1 for ev in rep["recovery_events"] for c in ev["plan"]
               for m in plan.members[c] if g.nodes[m].name == "mul")
    n = stats["tasks_run"]["mul"]
    assert n == 8 + redo
    assert stats["tasks_run"]["gen"] >= 16 and stats["tasks_run"]["reduce"] == 1
    assert stats["kernel_launches"] == {"matmul": n, "matmul/simt": n,
                                        "matmul/vector": n}
    assert counting.launches == 0
    if "fail_worker" in extra:
        assert stats["recomputed"] >= 1


def test_start_method_is_spawn_once_cuda_is_initialised(monkeypatch):
    """Left unset, the start method is fork, or spawn once this process has
    initialised CUDA; a start method the config names is honoured."""
    def start_method(**kw):
        ex = ClusterExecutor(2, config=cfg(**kw))
        ex.close()
        return ex.start_method
    assert start_method() == "fork"
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert start_method() == "spawn"
    assert start_method(start_method="fork") == "fork"


def test_spawned_workers_carry_tensor_payloads():
    """Fresh interpreters receive the pickled graph (module-level Fig. 2
    tasks); bf16 values cross between them bit for bit."""
    _, seq, _ = run_matrix_dag(4, 32, 1, device="cpu", dtype=torch.bfloat16)
    _, got, rep = run_matrix_dag(
        4, 32, 2, device="cpu", dtype=torch.bfloat16, backend="process",
        config=cfg(n_workers=2, start_method="spawn", fuse="auto",
                   shm_threshold=1024, progress_timeout=SPAWN_TIMEOUT))
    assert results_equal(got, seq)
    assert rep["stats"]["bytes_direct"] > 0


def test_a_remote_worker_dials_the_driver_over_tcp():
    """``python -m repro_torch.launch.remote`` dials a port driver, gets
    the graph in the welcome frame and serves it.  The test waits until
    the driver's listener holds the handshaken dial before it runs (so the
    worker's start-up is not raced against the run), then for the
    worker's clean exit."""
    g = demo_graph(60, seed=2)
    seq = execute_sequential(demo_graph(60, seed=2))
    ex = ClusterExecutor(config=cfg(workers=["remote"], accept_timeout=60.0))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.remote", "--connect",
         ex.address, "--timeout", "60"], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 60
        while ex.listener._pending.qsize() < 1:
            assert proc.poll() is None, proc.communicate()[0]
            assert time.monotonic() < deadline, "the worker never dialed"
            time.sleep(0.05)
        assert ex.run(g) == seq
        assert ex.stats["dispatched"] >= 60
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
        assert "finished cleanly" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        ex.close()


# ------------------------------------------------------- errors and API

def _raise_like_torch():
    raise RuntimeError("Cannot re-initialize CUDA in forked subprocess. "
                       "To use CUDA with multiprocessing, you must use the "
                       "'spawn' start method")


def test_a_task_error_in_a_worker_is_task_failed_with_its_message():
    g = TaskGraph()
    a = g.add_node("ok", _tensor_node, (), {"_i": 1}, TaskKind.PURE, deps=())
    g.add_node("boom", _raise_like_torch, (), {}, TaskKind.PURE, deps=())
    g.mark_output(a)
    with pytest.raises(TaskFailed, match="forked subprocess"):
        run_graph(g, 2, backend="process", config=cfg())


def test_make_executor_process_is_an_executor():
    ex = make_executor("process", 2, config=cfg())
    assert isinstance(ex, ClusterExecutor) and isinstance(ex, Executor)
    with pytest.raises(ValueError, match="process backend"):
        make_executor("thread", 2, config=cfg())
