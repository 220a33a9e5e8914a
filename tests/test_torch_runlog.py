"""The port's run-log checkpoint (``repro_torch/checkpoint/runlog.py``):
record roundtrip, torn-tail repair, replay semantics, fingerprints and the
flat-in-worker-count byte cost, held to the reference's suite
``tests/test_runlog.py``.

Each reference test has a case here.  The log is plain pickled records, so
the two packages must write the same bytes for the same records and read
each other's logs to the same state; the fingerprints of one graph shape,
built in each package, must be equal.  The port adds a Fig. 2 run with
torch tensor payloads whose driver is killed and resumed from the log.
"""
import os
import pickle
import random
import struct

import pytest

torch = pytest.importorskip("torch")

import repro.checkpoint.runlog as rrunlog                         # noqa: E402
import repro.core as rcore                                        # noqa: E402
import repro.core.fusion as rfusion                               # noqa: E402
from repro.core.tracing import RemappedRef as RRef                # noqa: E402

import repro_torch.checkpoint.runlog as prunlog                   # noqa: E402
import repro_torch.core as pcore                                  # noqa: E402
from _propcheck import given, settings, st                        # noqa: E402
from repro_torch.checkpoint.runlog import (RunLog, graph_fingerprint,  # noqa: E402
                                           latest_run, load_run,
                                           plan_fingerprint)
from repro_torch.cluster import ClusterExecutor, DriverKilled     # noqa: E402
from repro_torch.core import TaskKind, execute_sequential         # noqa: E402
from repro_torch.core.fusion import fuse                          # noqa: E402
from repro_torch.core.tracing import RemappedRef as _Ref, trace   # noqa: E402
from repro_torch.workloads import matrix_driver                   # noqa: E402

from _torch_runtime import results_equal                          # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

PKGS = {"ref": (rcore, RRef), "port": (pcore, _Ref)}


def _log(tmp_path, name="r1"):
    return os.path.join(str(tmp_path), f"{name}.log")


def _begin(run_id="r1", **extra):
    meta = {"run_id": run_id, "graph_fp": "g", "plan_fp": "p",
            "seg_prefix": "rrtest0", "address": None}
    meta.update(extra)
    return ("begin", meta)


def _node(*xs, _i=0):
    return _i + sum(xs)


def _dag(seed: int, n: int, pkg: str = "port"):
    core, Ref = PKGS[pkg]
    rng = random.Random(seed)
    g = core.TaskGraph()
    for i in range(n):
        deps = [j for j in range(i) if rng.random() < 0.3][-3:]
        g.add_node(f"t{i}", _node, tuple(Ref(d) for d in deps), {"_i": i},
                   core.TaskKind.PURE, deps=deps, cost=1.0)
    g.mark_output(n - 1)
    return g


def _state(st_):
    return (st_.meta, st_.seg_prefixes, st_.workers, st_.dead,
            st_.live_workers, st_.done, st_.dropped, st_.handles,
            st_.values, st_.truncated, st_.n_records)


# ----------------------------------------------------------- writer/loader

ALL_KINDS = [_begin(), ("worker", 0, "hostA"), ("worker", 1, "hostB"),
             ("done", 5, 0, {5: 128, 6: 64}), ("hnd", 5, b"handle-bytes"),
             ("val", 6, pickle.dumps(42)), ("gc", [3, 4]), ("live", [4]),
             ("dead", 1), ("redo", [7]), ("done", 7, 0, {7: 32}),
             ("resume", {"seg_prefix": "rrtest1"})]


def test_roundtrip_all_record_kinds(tmp_path):
    path = _log(tmp_path)
    log = RunLog(path, interval=0.0)
    for rec in ALL_KINDS:
        log.append(*rec)
    log.close()

    st_ = load_run(path)
    assert st_.meta["run_id"] == "r1"
    assert st_.seg_prefixes == ["rrtest0", "rrtest1"]
    assert st_.workers == {0: "hostA", 1: "hostB"}
    assert st_.dead == {1}
    assert st_.live_workers == {0: "hostA"}
    assert st_.done == {5: (0, {5: 128, 6: 64}), 7: (0, {7: 32})}
    assert st_.dropped == {3}           # 4 was resurrected by "live"
    assert st_.handles == {5: b"handle-bytes"}
    assert pickle.loads(st_.values[6]) == 42
    assert not st_.truncated

    # the reference writes the same bytes and reads the port's log alike
    rpath = _log(tmp_path, "ref")
    rlog = rrunlog.RunLog(rpath, interval=0.0)
    for rec in ALL_KINDS:
        rlog.append(*rec)
    rlog.close()
    with open(path, "rb") as a, open(rpath, "rb") as b:
        assert a.read() == b.read()
    assert _state(rrunlog.load_run(path)) == _state(st_)
    assert _state(load_run(rpath)) == _state(st_)


def test_redo_retracts_done_and_rejoin_revives_dead(tmp_path):
    path = _log(tmp_path)
    log = RunLog(path, interval=0.0)
    log.append(*_begin())
    log.append("worker", 0, "h")
    log.append("done", 1, 0, {1: 8})
    log.append("dead", 0)
    log.append("redo", [1])
    log.append("worker", 0, "h")        # re-adoption after rejoin
    log.close()
    st_ = load_run(path)
    assert st_.done == {}
    assert st_.dead == set()
    assert st_.live_workers == {0: "h"}


def test_buffered_append_defers_io_until_flush(tmp_path):
    path = _log(tmp_path)
    log = RunLog(path, interval=3600.0)
    log.append(*_begin())
    for i in range(50):
        log.append("done", i, 0, {i: 8})
    assert os.path.getsize(path) == 0           # nothing hit disk yet
    assert log.bytes_written == 0
    assert not log.maybe_flush()                # interval not elapsed
    log.flush()
    assert log.bytes_written == os.path.getsize(path) > 0
    log.close()
    assert len(load_run(path).done) == 50


def test_maybe_flush_triggers_on_buffer_pressure(tmp_path):
    def appends_until_flush(runlog):
        log = runlog.RunLog(_log(tmp_path, runlog.__name__), interval=3600.0,
                            max_buffer=256)
        log.append(*_begin())
        n = 0
        while not log.maybe_flush():
            log.append("done", 0, 0, {0: 8})
            n += 1
        assert log.bytes_written > 0
        log.close()
        return n, log.bytes_written

    assert appends_until_flush(prunlog) == appends_until_flush(rrunlog)


@pytest.mark.parametrize("cut", ["prefix", "payload", "garbage"])
def test_torn_tail_detected_and_repaired(tmp_path, cut):
    path = _log(tmp_path)
    log = RunLog(path, interval=0.0)
    log.append(*_begin())
    for i in range(10):
        log.append("done", i, 0, {i: 8})
    log.close()
    clean = os.path.getsize(path)

    with open(path, "ab") as f:
        if cut == "prefix":
            f.write(b"\x00\x00")                        # short length
        elif cut == "payload":
            f.write(struct.pack(">I", 999) + b"short")  # short payload
        else:
            f.write(struct.pack(">I", 4) + b"\xff\xff\xff\xff")  # bad pickle

    st_ = load_run(path, repair=False)
    assert st_.truncated and len(st_.done) == 10
    assert os.path.getsize(path) > clean        # repair=False left the tear
    assert _state(rrunlog.load_run(path, repair=False)) == _state(st_)

    st_ = load_run(path)                        # repair=True truncates...
    assert st_.truncated and len(st_.done) == 10
    assert os.path.getsize(path) == clean

    with open(path, "ab") as f:                 # ...so appends are clean
        rec = pickle.dumps(("done", 99, 1, {99: 1}))
        f.write(struct.pack(">I", len(rec)) + rec)
    st_ = load_run(path)
    assert not st_.truncated and 99 in st_.done


def test_torn_mid_record_loses_at_most_the_tail(tmp_path):
    """Cut the file at EVERY byte offset: the loader must never crash,
    never invent records, and keep the longest clean prefix — the
    reference's loader reads each cut alike."""
    path = _log(tmp_path)
    log = RunLog(path, interval=0.0)
    log.append(*_begin())
    for i in range(6):
        log.append("done", i, 0, {i: 8})
    log.close()
    with open(path, "rb") as f:
        blob = f.read()

    seen = []
    for cut in range(1, len(blob) + 1):
        p = _log(tmp_path, f"cut{cut}")
        with open(p, "wb") as f:
            f.write(blob[:cut])
        try:
            st_ = load_run(p, repair=False)
        except ValueError:
            with pytest.raises(ValueError):
                rrunlog.load_run(p, repair=False)
            continue                            # begin record itself torn
        assert _state(rrunlog.load_run(p, repair=False)) == _state(st_)
        seen.append(len(st_.done))
    assert seen and max(seen) == 6
    assert seen == sorted(seen)                 # monotone in cut point


def test_load_run_requires_begin(tmp_path):
    path = _log(tmp_path)
    log = RunLog(path, interval=0.0)
    log.append("done", 1, 0, {1: 8})            # no begin
    log.close()
    with pytest.raises(ValueError):
        load_run(path)


def test_unknown_record_kinds_are_skipped(tmp_path):
    path = _log(tmp_path)
    log = RunLog(path, interval=0.0)
    log.append(*_begin())
    log.append("future-kind", {"x": 1})
    log.append("done", 1, 0, {1: 8})
    log.close()
    st_ = load_run(path)
    assert st_.done == {1: (0, {1: 8})} and st_.n_records == 3


def test_latest_run_picks_newest_and_handles_missing_dir(tmp_path):
    assert latest_run(str(tmp_path / "nope")) is None
    for i, name in enumerate(["aaa", "bbb"]):
        p = _log(tmp_path, name)
        RunLog(p, interval=0.0).close()
        os.utime(p, (1000 + i, 1000 + i))
    assert latest_run(str(tmp_path)) == "bbb"
    assert rrunlog.latest_run(str(tmp_path)) == "bbb"


# --------------------------------------------------------------- property

@given(st.lists(st.tuples(st.integers(0, 40), st.integers(0, 3),
                          st.booleans()), max_size=60),
       st.integers(0, 2**32 - 1))
@settings(max_examples=40)
def test_replay_equals_dict_semantics(events, seed):
    """Replaying (done | redo | gc | live) events matches a plain
    last-writer-wins dict/set model, for any interleaving."""
    import tempfile
    rng = random.Random(seed)
    model_done, model_dropped = {}, set()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "p.log")
        log = RunLog(path, interval=0.0)
        log.append(*_begin())
        for cid, wid, flag in events:
            r = rng.random()
            if r < 0.6:
                log.append("done", cid, wid, {cid: 8})
                model_done[cid] = (wid, {cid: 8})
            elif r < 0.8:
                log.append("redo", [cid])
                model_done.pop(cid, None)
            elif flag:
                log.append("gc", [cid])
                model_dropped.add(cid)
            else:
                log.append("live", [cid])
                model_dropped.discard(cid)
        log.close()
        st_ = load_run(path)
    assert st_.done == model_done
    assert st_.dropped == model_dropped


@given(st.integers(0, 2**31 - 1), st.integers(5, 30))
@settings(max_examples=15)
def test_fingerprints_deterministic_and_shape_sensitive(seed, n):
    g1, g2 = _dag(seed, n), _dag(seed, n)
    assert graph_fingerprint(g1) == graph_fingerprint(g2)
    p1 = fuse(g1, "auto")
    p2 = fuse(g2, "auto")
    assert plan_fingerprint(p1) == plan_fingerprint(p2)
    # the same shape built in the reference digests alike
    rg = _dag(seed, n, "ref")
    assert rrunlog.graph_fingerprint(rg) == graph_fingerprint(g1)
    assert rrunlog.plan_fingerprint(rfusion.fuse(rg, "auto")) \
        == plan_fingerprint(p1)
    # perturb the shape: add one node feeding nothing
    g2.add_node("extra", lambda: 0, (), {}, TaskKind.PURE, deps=[], cost=1.0)
    assert graph_fingerprint(g1) != graph_fingerprint(g2)


def test_plan_fingerprint_distinguishes_fuse_specs():
    g = _dag(3, 24)
    off = fuse(g, "off")
    auto = fuse(g, "auto")
    if off.members != auto.members:
        assert plan_fingerprint(off) != plan_fingerprint(auto)


# ------------------------------------------------- flat-in-workers claim

def test_bytes_per_completion_flat_in_worker_count(tmp_path):
    """The hot-path record is a delta keyed by the completion event, so
    doubling the worker count must not change the bytes written per
    cluster (beyond the one-off adoption records)."""
    per_done = {}
    for n_workers in (2, 64):
        path = _log(tmp_path, f"w{n_workers}")
        log = RunLog(path, interval=0.0)
        log.append(*_begin())
        for w in range(n_workers):
            log.append("worker", w, f"host{w}")
        log.flush()
        adoption = log.bytes_written
        for cid in range(200):
            log.append("done", cid, cid % n_workers, {cid: 128})
        log.close()
        per_done[n_workers] = (log.bytes_written - adoption) / 200
    assert per_done[64] <= per_done[2] * 1.05


# ------------------------------------------ Fig. 2: driver kill + resume

def test_fig2_driver_killed_then_resumed_from_the_log(tmp_path):
    """The port's case: the Fig. 2 DAG's tensors on 2 forked workers, the
    driver killed after 10 completions, then a new driver resumed from the
    log: the sequential run bit for bit, the log's clusters adopted, and
    the resumed run's ``tasks_run`` counts only what it dispatched
    itself."""
    def graph():
        return trace(matrix_driver, 8, 32, device="cpu")[0]

    seq = execute_sequential(graph())
    ex = ClusterExecutor(2, fuse="off", checkpoint_dir=str(tmp_path),
                         checkpoint_interval=0.0, fail_driver=10,
                         progress_timeout=30.0)
    with pytest.raises(DriverKilled):
        ex.run(graph())
    ex.close()
    st_ = load_run(os.path.join(str(tmp_path), f"{ex.run_id}.log"))
    assert len(st_.done) >= 10
    ex2 = ClusterExecutor(2, fuse="off", checkpoint_dir=str(tmp_path),
                          resume=ex.run_id, progress_timeout=30.0)
    try:
        assert results_equal(ex2.run(graph()), seq)
    finally:
        ex2.close()
    stats = ex2.stats
    assert stats["resumed_clusters"] > 0
    # one task a super-task (fusion off): each dispatch of this driver is
    # one task run, and nothing of the killed driver's runs is counted
    assert sum(stats["tasks_run"].values()) == stats["dispatched"]
