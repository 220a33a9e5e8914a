"""Speculative re-execution of stragglers in the port's ``ClusterExecutor``,
held to the reference's suite ``tests/test_speculation.py``.

Each reference test has a case here.  The policy (``pick_speculation`` on
a fixed trace, the simulator's speculated set) runs through both packages
and must agree exactly; every live run equals the port's
``execute_sequential``.  The port adds the Fig. 2 DAG with torch tensor
payloads and one straggling ``mul``: the twin wins, and the workers'
kernel launches equal the ``mul`` tasks the executor saw run, losers'
included.

Straggler injection: the task's value is deterministic, but its *first*
execution (the ``O_EXCL`` sentinel creator) sleeps — a speculative twin
launched after the original is asleep sees the sentinel and returns fast.
"""
import os
import time
from functools import partial

import pytest

torch = pytest.importorskip("torch")

import repro.core as rcore                                        # noqa: E402
import repro.core.simulator as rsim                               # noqa: E402
from repro.core.tracing import RemappedRef as RRef                # noqa: E402

import repro_torch.core as pcore                                  # noqa: E402
import repro_torch.core.simulator as psim                         # noqa: E402
from repro_torch.cluster import ClusterExecutor                   # noqa: E402
from repro_torch.config import ClusterConfig                      # noqa: E402
from repro_torch.core import (TaskGraph, TaskKind,                # noqa: E402
                              execute_sequential, run_graph)
from repro_torch.core.tracing import RemappedRef as _Ref, trace   # noqa: E402
from repro_torch.kernels import matmul as kmm, ref as kref       # noqa: E402
from repro_torch.workloads import matrix_driver                   # noqa: E402

from _torch_runtime import results_equal                          # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

PKGS = {"ref": (rcore, RRef), "port": (pcore, _Ref)}


def add_sleep_task(g, name: str, deps, sleep_s: float, salt: int,
                   pkg: str = "port") -> int:
    core, Ref = PKGS[pkg]

    def fn(*xs, _s=sleep_s, _salt=salt):
        if _s:
            time.sleep(_s)
        return (_salt + sum(xs) * 7) % 1_000_003

    return g.add_node(name, fn, tuple(Ref(d) for d in deps), {},
                      core.TaskKind.PURE, deps=list(deps), cost=1.0)


def _straggle(path: str, creator_sleep: float, twin_sleep: float, fn, *xs):
    """Runs ``fn``; the first execution (the sentinel's creator) sleeps
    ``creator_sleep`` first, any re-execution ``twin_sleep``."""
    try:
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        fd = -1
    if fd >= 0:
        os.close(fd)
        time.sleep(creator_sleep)
    elif twin_sleep:
        time.sleep(twin_sleep)
    return fn(*xs)


def _salted(salt, *xs):
    return (salt + sum(xs) * 7) % 1_000_003


def add_straggler(g: TaskGraph, name: str, deps, marker_dir: str,
                  creator_sleep: float, twin_sleep: float,
                  salt: int) -> int:
    """First execution (sentinel creator) sleeps ``creator_sleep``; any
    re-execution sleeps ``twin_sleep``.  The value is identical either
    way."""
    path = os.path.join(marker_dir, f"straggler-{name}")
    fn = partial(_straggle, path, creator_sleep, twin_sleep,
                 partial(_salted, salt))
    return g.add_node(name, fn, tuple(_Ref(d) for d in deps), {},
                      TaskKind.PURE, deps=list(deps), cost=1.0)


def spec_stats(ex) -> dict:
    return {k: v for k, v in ex.stats.items() if "spec" in k}


# ------------------------------------------------------------------ policy

def test_pick_speculation_fixed_trace():
    """The shared policy on a hand-written trace, in both packages:
    most-overdue wins, ties to the lower tid, nothing under the
    threshold."""
    running = {7: (3.0, 1.0),    # 3.0x overdue
               2: (9.0, 1.0),    # 9.0x — most overdue
               5: (1.0, 1.0)}    # on time
    cases = [(running, 2.0, 2), (running, 10.0, None), ({}, 1.0, None),
             # equal overdue ratios: deterministic tie to the lower tid
             ({4: (6.0, 1.0), 9: (6.0, 1.0)}, 2.0, 4),
             # at-threshold is NOT overdue (strictly greater)
             ({1: (2.0, 1.0)}, 2.0, None)]
    for trace_, after, want in cases:
        assert psim.pick_speculation(trace_, after) == want
        assert rsim.pick_speculation(trace_, after) == want


def test_sim_and_runtime_agree_on_speculated_set(tmp_path):
    """Same policy knobs, same graph shape — the simulator (the port's and
    the reference's) and the port's executor speculate on the SAME
    task."""
    def sim(pkg):
        core, _ = PKGS[pkg]
        sim_mod = {"ref": rsim, "port": psim}[pkg]
        gs = core.TaskGraph()
        for i in range(8):
            add_sleep_task(gs, f"t{i}", (), 0.0, i, pkg)
        gs.mark_output(7)
        return gs, sim_mod.ClusterSim(gs, 2, worker_speed=[0.02, 1.0],
                                      speculate_after=3.0, seed=0).run()

    gs, res = sim("port")
    _, rres = sim("ref")
    assert res.n_speculative >= 1 and res.speculated == {0}
    assert (res.makespan, res.speculated, res.n_speculative) == \
        (rres.makespan, rres.speculated, rres.n_speculative)

    # pipeline_depth=1 so nothing queues behind the sleeping original
    gr = TaskGraph()
    add_straggler(gr, "t0", (), str(tmp_path), 1.5, 0.0, 0)
    for i in range(1, 8):
        add_sleep_task(gr, f"t{i}", (), 0.1, i)
    gr.mark_output(7)
    ex = ClusterExecutor(2, speculate_after=3.0, pipeline_depth=1,
                         progress_timeout=60.0)
    got = ex.run(gr)
    ex.close()
    assert got == execute_sequential(gs)    # same values, sleep-free graph
    assert {e["tid"] for e in ex.speculation_events} == res.speculated


# -------------------------------------------------------- winner election

def test_twin_wins_and_result_is_oracle(tmp_path):
    """Ordering 1: the original straggles, the twin (seeing the sentinel)
    finishes first and wins; the late original is reconciled, not raised."""
    g = TaskGraph()
    calib = add_sleep_task(g, "calib", (), 0.1, 1)
    strag = add_straggler(g, "strag", (), str(tmp_path), 1.2, 0.0, 2)
    for j in range(4):
        add_sleep_task(g, f"c{j}", (calib, strag), 0.05, 10 + j)
    g.mark_output(5)
    seq = execute_sequential(g)     # consumes tmp_path's sentinel...
    os.unlink(os.path.join(str(tmp_path), "straggler-strag"))  # ...reset

    ex = ClusterExecutor(2, speculate_after=2.0, progress_timeout=60.0)
    got = ex.run(g)
    ex.close()
    assert got == seq
    assert ex.stats["n_speculative"] >= 1, spec_stats(ex)
    assert ex.stats["speculative_wins"] >= 1, spec_stats(ex)


def test_original_wins_twin_is_wasted(tmp_path):
    """Ordering 2: the 'straggler' is merely slow-ish and finishes first;
    the twin (launched strictly later, same fixed duration) loses and its
    work is accounted as waste."""
    g = TaskGraph()
    calib = add_sleep_task(g, "calib", (), 0.15, 1)
    slow = add_sleep_task(g, "slow", (), 1.0, 2)    # fixed sleep, no sentinel
    add_sleep_task(g, "c0", (calib, slow), 0.05, 3)
    g.mark_output(2)
    seq = execute_sequential(g)

    ex = ClusterExecutor(2, speculate_after=2.0, progress_timeout=60.0)
    got = ex.run(g)
    ex.close()
    assert got == seq
    assert ex.stats["n_speculative"] >= 1, spec_stats(ex)
    assert ex.stats["speculative_wins"] == 0, spec_stats(ex)
    assert ex.stats["speculative_wasted_s"] > 0.0, spec_stats(ex)


# ------------------------------------------------- SIGKILL mid-speculation

def test_sigkill_original_while_twin_runs_no_double_recovery(tmp_path):
    """SIGKILL the original's worker while the twin runs: the survivor
    owns the task — no lineage recompute, no re-queue, exactly one
    effective execution."""
    g = TaskGraph()
    calib = add_sleep_task(g, "calib", (), 0.1, 1)
    strag = add_straggler(g, "strag", (), str(tmp_path), 3.0, 0.5, 2)
    add_sleep_task(g, "c0", (calib, strag), 0.05, 3)
    last = add_sleep_task(g, "c1", (calib, strag), 0.05, 4)
    g.mark_output(last)
    gs = TaskGraph()                  # sleep-free twin graph: the oracle
    add_sleep_task(gs, "calib", (), 0.0, 1)
    add_sleep_task(gs, "strag", (), 0.0, 2)
    add_sleep_task(gs, "c0", (0, 1), 0.0, 3)
    add_sleep_task(gs, "c1", (0, 1), 0.0, 4)
    gs.mark_output(last)
    seq = execute_sequential(gs)

    ex = ClusterExecutor(2, speculate_after=2.0, progress_timeout=60.0)
    fut = ex.submit(g)
    deadline = time.monotonic() + 20.0
    while not ex.speculation_events:
        assert time.monotonic() < deadline, "twin never launched"
        assert not fut.done(), f"run finished without speculating: " \
                               f"{fut.exception(0)}"
        time.sleep(0.005)
    ev = ex.speculation_events[0]
    assert ev["tid"] == strag
    ex.kill_worker(ev["primary"])     # original dies mid-sleep

    got = fut.result(timeout=60.0)
    ex.close()
    assert got == seq
    stats = fut.stats
    assert stats["failures"] == 1, stats
    assert stats["recomputed"] == 0, stats          # no double recovery
    assert stats["speculative_wins"] == 1, stats    # the twin's completion
    # every task ran exactly once, plus the one speculative twin
    assert stats["dispatched"] == len(g.nodes) + 1, stats


# ------------------------------------------------------------ GC + default

def test_speculation_disabled_by_default_stats_zero():
    g = TaskGraph()
    prev = add_sleep_task(g, "t0", (), 0.0, 0)
    for i in range(1, 20):
        prev = add_sleep_task(g, f"t{i}", (prev,), 0.0, i)
    g.mark_output(prev)
    ex = ClusterExecutor(2, progress_timeout=60.0)
    got = ex.run(g)
    ex.close()
    assert got == execute_sequential(g)
    assert ex.stats["n_speculative"] == 0
    assert ex.stats["speculative_wins"] == 0
    assert ex.stats["speculative_swept"] == 0
    assert ex.stats["speculative_wasted_s"] == 0.0


def test_gc_mode_sweeps_loser_publish(tmp_path):
    """``outputs_only=True``: the straggler's value is consumed and
    GC-dropped while the loser is still asleep; the loser's late publish
    must be swept (the worker told to drop it), never resurrected as a
    replica of a collected value."""
    g = TaskGraph()
    calib = add_sleep_task(g, "calib", (), 0.05, 1)
    strag = add_straggler(g, "strag", (), str(tmp_path), 0.8, 0.0, 2)
    c = add_sleep_task(g, "consume", (calib, strag), 0.05, 3)
    prev = c
    for i in range(6):                # tail keeps the run alive past the
        prev = add_sleep_task(g, f"tail{i}", (prev,), 0.15, 10 + i)
    g.mark_output(prev)               # loser's wake-up at 0.8s
    gs_oracle = execute_sequential(g)     # consumes the sentinel...
    os.unlink(os.path.join(str(tmp_path), "straggler-strag"))  # ...reset

    ex = ClusterExecutor(2, outputs_only=True, speculate_after=2.0,
                         progress_timeout=60.0)
    got = ex.run(g)
    ex.close()
    assert got == {prev: gs_oracle[prev]}
    assert ex.stats["speculative_wins"] >= 1, spec_stats(ex)
    assert ex.stats["dropped"] >= 1, ex.stats
    assert ex.stats["speculative_swept"] >= 1, spec_stats(ex)


def test_speculate_after_validation():
    with pytest.raises(ValueError):
        ClusterExecutor(2, speculate_after=0.0)
    with pytest.raises(ValueError):
        ClusterExecutor(2, speculate_after=-1.5)


# -------------------------------------------- cooperative mid-task cancel

def _append_marker(x, _p=None):
    with open(_p, "ab") as f:       # one byte per execution
        f.write(b"x")
    return (x * 7 + 5) % 1_000_003


def _fused_straggler_chain(marker_dir: str, marker: str,
                           tail_chain: int = 0) -> TaskGraph:
    """calib, a straggler fused with a tail member that appends one byte to
    ``marker`` per execution, four consumers of both, and (optionally) a
    chain of 0.5 s tasks after the consumers that keeps the run alive past
    the loser's wake-up."""
    g = TaskGraph()
    calib = add_sleep_task(g, "calib", (), 0.1, 1)
    strag = add_straggler(g, "strag", (), marker_dir, 2.5, 0.05, 2)
    tail = g.add_node("tail", partial(_append_marker, _p=marker),
                      (_Ref(strag),), {}, TaskKind.PURE, deps=[strag],
                      cost=1.0)
    cs = [add_sleep_task(g, f"c{j}", (calib, tail), 0.05, 10 + j)
          for j in range(4)]   # fan-out: keeps strag+tail a pair
    prev = cs[-1]
    for i in range(tail_chain):
        prev = add_sleep_task(g, f"late{i}", (prev,), 0.5, 20 + i)
    g.mark_output(prev)
    return g


def _run_fused_straggler(tmp_path, tail_chain: int = 0):
    marker = os.path.join(str(tmp_path), "tail-runs")
    g = _fused_straggler_chain(str(tmp_path), marker, tail_chain)
    seq = execute_sequential(g)     # consumes the sentinel + marker...
    os.unlink(os.path.join(str(tmp_path), "straggler-strag"))  # ...reset
    os.unlink(marker)
    ex = ClusterExecutor(2, fuse="auto", speculate_after=2.0,
                         progress_timeout=60.0)
    got = ex.run(g)
    ex.close()
    assert got == seq
    assert ex.stats["tasks_fused"] >= 1         # the chain really fused
    assert ex.stats["n_speculative"] >= 1, spec_stats(ex)
    assert ex.stats["speculative_wins"] >= 1, spec_stats(ex)
    # the loser aborted before its tail member: exactly one execution
    # (the winner's) wrote the marker
    assert os.path.getsize(marker) == 1
    assert ex.stats["speculative_wasted_s"] > 0.0, spec_stats(ex)
    return ex


def test_cancel_aborts_fused_loser_at_member_boundary(tmp_path):
    """A speculation loser running a FUSED chain honors the cancel between
    members: the original straggles inside the first member, the twin wins
    the whole chain, and the loser aborts at the boundary — the tail
    member never executes a second time (counted via an append-only
    side-channel) and the abandoned partial wall is charged to
    ``speculative_wasted_s``."""
    _run_fused_straggler(tmp_path)


def test_an_aborted_loser_reports_the_members_it_ran(tmp_path):
    """The port's counters: with the run kept alive past the loser's
    wake-up, its abort ack names the one member it ran, so ``tasks_run``
    counts the straggler twice (the loser and the twin) and the tail once
    (the twin)."""
    ex = _run_fused_straggler(tmp_path, tail_chain=6)
    assert ex.stats["tasks_run"]["strag"] == 2, ex.stats["tasks_run"]
    assert ex.stats["tasks_run"]["tail"] == 1, ex.stats["tasks_run"]


# ------------------------------------- Fig. 2 with a straggling ``mul``

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


def test_fig2_straggling_mul_is_speculated_and_its_launches_counted(
        tmp_path, monkeypatch):
    """The Fig. 2 DAG (16 units of 32x32 float32 tensors) with the first
    execution of one ``mul`` asleep: a twin wins, the result is the
    sequential run's bit for bit, and the workers' matmul launches equal
    the ``mul`` tasks run, twins and losers included."""
    counting = _counting_matmul()
    monkeypatch.setattr(kmm, "matmul", counting)
    g, _ = trace(matrix_driver, 16, 32, device="cpu")
    node = [n for n in g if n.name == "mul"][5]
    marker = os.path.join(str(tmp_path), "straggler-mul")
    node.fn = partial(_straggle, marker, 1.5, 0.0, node.fn)
    seq = execute_sequential(g)
    os.unlink(marker)
    counting.launches = 0
    got, rep = run_graph(g, 4, backend="process", with_report=True,
                         config=ClusterConfig(
                             n_workers=4, fuse="auto", keep_parallelism=16,
                             speculate_after=2.0, progress_timeout=60.0))
    assert results_equal(got, seq)
    stats = rep["stats"]
    assert stats["n_speculative"] >= 1 and stats["speculative_wins"] >= 1
    n = stats["tasks_run"]["mul"]
    assert n >= 16
    assert stats["kernel_launches"] == {"matmul": n, "matmul/simt": n,
                                        "matmul/vector": n}
    assert counting.launches == 0
