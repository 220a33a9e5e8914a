"""The port's fault injection (``repro_torch/faults/``) and the degradation
it exercises, held to the reference's suite ``tests/test_faults.py``.

Each reference test has a case here.  The deterministic parts (a plan's
nth addressing and seeded prob stream, its pickling, ``scaled``, retry
backoffs, the simulator's partition verdicts, the phantom recovery cost)
run through both packages on the same inputs and must agree exactly.  Every
live cluster run is a differential against the port's
``execute_sequential``, under the reference's own limits.  Two cases are
the port's: the Fig. 2 DAG with torch tensor payloads under the combined
plan, and a ``done`` frame delivered twice, which must count its run once.
"""
import pickle
import random
import time

import pytest

torch = pytest.importorskip("torch")

import repro.cluster.serde as rserde                              # noqa: E402
import repro.core as rcore                                        # noqa: E402
import repro.core.fusion as rfusion                               # noqa: E402
import repro.core.lineage as rlineage                             # noqa: E402
import repro.core.simulator as rsim                               # noqa: E402
import repro.faults as rfaults                                    # noqa: E402
from repro.core.tracing import RemappedRef as RRef                # noqa: E402

import repro_torch.core as pcore                                  # noqa: E402
import repro_torch.core.fusion as pfusion                         # noqa: E402
import repro_torch.core.lineage as plineage                       # noqa: E402
import repro_torch.core.simulator as psim                         # noqa: E402
import repro_torch.faults as pfaults                              # noqa: E402
from repro_torch.cluster import ClusterExecutor, serde            # noqa: E402
from repro_torch.core import TaskGraph, TaskKind, execute_sequential  # noqa: E402
from repro_torch.core.tracing import RemappedRef as _Ref          # noqa: E402
from repro_torch.faults import FaultPlan, RetryPolicy            # noqa: E402

from _torch_runtime import fig2_process_run, results_equal        # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

PKGS = {"ref": (rcore, RRef), "port": (pcore, _Ref)}
FAULTS = {"ref": rfaults, "port": pfaults}


# --------------------------------------------------------------- graphs

def exec_dag(seed: int, n: int, p: float, pkg: str = "port"):
    core, Ref = PKGS[pkg]
    rng = random.Random(seed)
    g = core.TaskGraph()
    for i in range(n):
        deps = [j for j in range(i) if rng.random() < p][-3:]

        def fn(*xs, _i=i):
            return (_i + sum(xs) * 7) % 1_000_003

        g.add_node(f"t{i}", fn, tuple(Ref(d) for d in deps), {},
                   core.TaskKind.PURE, deps=deps, cost=rng.uniform(0.1, 1.0))
    g.mark_output(n - 1)
    return g


def shuffle_graph(producers: int = 4, consumers: int = 8,
                  payload: int = 256) -> TaskGraph:
    """Producers emit byte payloads big enough to ride the data plane
    (``shm_threshold`` in the tests is set below ``payload``), a strided
    shuffle forces cross-worker fetches, a reduce checks every byte."""
    g = TaskGraph()
    for i in range(producers):
        def produce(_i=i, _n=payload):
            return bytes((_i * 31 + k) % 251 for k in range(_n))
        g.add_node(f"p{i}", produce, (), {}, TaskKind.PURE,
                   deps=(), cost=1.0)
    for j in range(consumers):
        deps = [j % producers, (j + 1) % producers]

        def combine(a, b, _j=j):
            return bytes((x + y + _j) % 251 for x, y in zip(a, b))

        g.add_node(f"c{j}", combine, tuple(_Ref(d) for d in deps), {},
                   TaskKind.PURE, deps=deps, cost=1.0)
    rdeps = list(range(producers, producers + consumers))

    def reduce_all(*xs):
        return sum(sum(x) for x in xs)

    g.add_node("reduce", reduce_all, tuple(_Ref(d) for d in rdeps), {},
               TaskKind.PURE, deps=rdeps, cost=1.0)
    g.mark_output(producers + consumers)
    return g


def two_chains(length: int = 6, sleep: float = 0.05) -> TaskGraph:
    """Two independent chains so both workers hold sole copies of live
    values — the partition tests need the severed worker to matter."""
    g = TaskGraph()
    tid = 0
    tails = []
    for c in range(2):
        prev = None
        for i in range(length):
            deps = [prev] if prev is not None else []

            def fn(*xs, _c=c, _i=i, _s=sleep):
                time.sleep(_s)
                return (_c * 1000 + _i + sum(xs) * 3) % 1_000_003

            g.add_node(f"c{c}t{i}", fn, tuple(_Ref(d) for d in deps), {},
                       TaskKind.PURE, deps=deps, cost=1.0)
            prev = tid
            tid += 1
        tails.append(prev)

    def join(a, b):
        return a * 7 + b

    g.add_node("join", join, (_Ref(tails[0]), _Ref(tails[1])), {},
               TaskKind.PURE, deps=tails, cost=1.0)
    g.mark_output(tid)
    return g


def both(fn):
    """``fn(package)`` for the reference and the port; they must agree."""
    got = fn(FAULTS["port"])
    assert got == fn(FAULTS["ref"])
    return got


# ----------------------------------------------------------- unit: plan

def test_fault_rule_validation():
    for faults in FAULTS.values():
        with pytest.raises(ValueError):
            faults.FaultRule("teleport")
        with pytest.raises(ValueError):
            faults.FaultRule("drop", nth=0)
        with pytest.raises(ValueError):
            faults.FaultRule("drop", prob=1.5)


def test_fault_plan_nth_addressing_is_deterministic():
    def fired(faults):
        plan = faults.FaultPlan(seed=1).drop(src=1, dst="driver",
                                             verb="done", nth=2)
        return ([bool(plan.frame_actions(1, "driver", "done"))
                 for _ in range(4)],
                bool(plan.frame_actions(2, "driver", "done")))

    # nth=2 fires exactly once; a different link keeps its own counter
    assert both(fired) == ([False, True, False, False], False)


def test_fault_plan_prob_stream_is_seeded():
    def firing_pattern(faults, seed):
        plan = faults.FaultPlan(seed=seed).drop(verb="hb", prob=0.5)
        return [bool(plan.frame_actions(1, "driver", "hb"))
                for _ in range(32)]

    for seed in (7, 8):
        both(lambda f: firing_pattern(f, seed))
    assert firing_pattern(pfaults, 7) == firing_pattern(pfaults, 7)
    assert firing_pattern(pfaults, 7) != firing_pattern(pfaults, 8)


def test_fault_plan_pickles_description_not_counters():
    def roundtrip(faults):
        plan = faults.FaultPlan(seed=3).drop(verb="done", nth=1)
        first = bool(plan.frame_actions(1, 2, "done"))   # consume it
        clone = pickle.loads(pickle.dumps(plan))
        return (first, clone.rules == plan.rules,
                bool(clone.frame_actions(1, 2, "done")),  # restarted
                bool(plan.frame_actions(1, 2, "done")))   # stays spent

    assert both(roundtrip) == (True, True, True, False)
    port = FaultPlan(seed=3).drop(verb="done", nth=1)
    ref = rfaults.FaultPlan(seed=3).drop(verb="done", nth=1)
    assert [vars(r) for r in port.rules] == [vars(r) for r in ref.rules]


def test_fault_plan_sever_window_is_symmetric():
    plan = FaultPlan(seed=0).sever(window=0.2, src=1, verb="done", nth=1)
    assert plan.frame_actions(1, "driver", "done")
    assert plan.severed(1, "driver") is not None
    assert plan.severed("driver", 1) is not None   # both directions
    time.sleep(0.25)
    assert plan.severed(1, "driver") is None       # window expired


def test_scaled_plan_clamps_and_preserves_nth():
    def hot_rules(faults):
        plan = faults.FaultPlan(seed=5).drop(verb="hb", prob=0.4).delay(
            0.01, nth=3, verb="done")
        return [vars(r) for r in faults.scaled(plan, 10.0).rules]

    rules = both(hot_rules)
    assert rules[0]["prob"] == 1.0                 # clamped
    assert rules[1]["nth"] == 3                    # exact rules untouched


# ---------------------------------------------------------- unit: retry

def test_retry_policy_backoff_is_bounded_and_seeded():
    def delays(faults):
        pol = faults.RetryPolicy(attempts=5, base_delay=0.1, factor=2.0,
                                 max_delay=0.3, jitter=0.0)
        jit = faults.RetryPolicy(attempts=5, base_delay=0.1, jitter=0.5)
        rng = random.Random(9)
        return ([pol.backoff(i) for i in range(4)],
                [jit.backoff(0, rng=rng) for _ in range(20)])

    fixed, jittered = both(delays)
    assert fixed == [0.1, 0.2, 0.3, 0.3]          # capped at max_delay
    assert all(0.1 <= d <= 0.15 for d in jittered)


def test_retry_policy_run_retries_then_raises():
    calls = []

    def flaky(attempt):
        calls.append(attempt)
        raise OSError("nope")

    pol = RetryPolicy(attempts=3, base_delay=0.001, jitter=0.0)
    with pytest.raises(OSError):
        pol.run(flaky, retryable=lambda e: isinstance(e, OSError))
    assert calls == [0, 1, 2]

    calls.clear()
    with pytest.raises(OSError):     # non-retryable: no second attempt
        pol.run(flaky, retryable=lambda e: False)
    assert calls == [0]


def test_retry_policy_deadline_cuts_attempts_short():
    pol = RetryPolicy(attempts=50, base_delay=0.05, factor=1.0,
                      jitter=0.0, deadline=0.12)
    calls = []

    def flaky(attempt):
        calls.append(attempt)
        raise OSError("nope")

    t0 = time.perf_counter()
    with pytest.raises(OSError):
        pol.run(flaky, retryable=lambda e: True)
    assert time.perf_counter() - t0 < 1.0
    assert 1 <= len(calls) < 50


# ----------------------------------------- differential: fault matrix

def _plan_for(fault: str) -> FaultPlan:
    if fault == "drop":
        # keepalives only: control verbs assume TCP's reliable-or-dead
        # contract, so dropping them would model a fault TCP can't produce
        return FaultPlan(seed=11).drop(verb="hb", prob=0.5)
    if fault == "delay":
        return FaultPlan(seed=12).delay(0.02, prob=0.3)
    if fault == "dup":
        return FaultPlan(seed=13).duplicate(prob=0.3)
    if fault == "reorder":
        return FaultPlan(seed=14).reorder(prob=0.3)
    if fault == "sever":
        return FaultPlan(seed=15).sever(window=0.3, src=1, verb="done",
                                        nth=1)
    if fault == "fail_fetch":
        return FaultPlan(seed=16).fail_fetch(nth=1)
    raise AssertionError(fault)


TCP = dict(channel="tcp", heartbeat_interval=0.1, heartbeat_timeout=1.0,
           suspect_grace=5.0)


@pytest.mark.parametrize("channel", ["pipe", "tcp"])
@pytest.mark.parametrize("fault", ["drop", "delay", "dup", "reorder",
                                   "sever", "fail_fetch"])
def test_fault_matrix_differential(channel, fault):
    """Every fault class, both control channels, bit-for-bit vs the
    sequential oracle — the in-tree version of the chaos smoke."""
    g = shuffle_graph()
    seq = execute_sequential(g)
    kw = dict(fault_plan=_plan_for(fault), transport="sock",
              shm_threshold=64,
              fetch_retry=RetryPolicy(attempts=3, base_delay=0.01,
                                      jitter=0.0))
    if channel == "tcp":
        kw.update(TCP)
    ex = ClusterExecutor(2, **kw)
    assert ex.run(g) == seq
    assert ex.stats["failures"] == 0


def _combined_plan() -> FaultPlan:
    return (FaultPlan(seed=99)
            .drop(verb="hb", prob=0.4)
            .delay(0.01, prob=0.2)
            .duplicate(prob=0.2)
            .reorder(prob=0.2)
            .sever(window=0.3, src=1, verb="done", nth=2))


def test_combined_plan_differential_pipe_and_tcp():
    """All fault classes at once — the worst single plan still converges."""
    g = exec_dag(21, 60, 0.3)
    seq = execute_sequential(g)
    for channel in ("pipe", "tcp"):
        kw = dict(fault_plan=_combined_plan())
        if channel == "tcp":
            kw.update(TCP)
        ex = ClusterExecutor(2, **kw)
        assert ex.run(g) == seq


@pytest.mark.parametrize("channel", ["pipe", "tcp"])
def test_fig2_tensor_payloads_under_the_combined_plan(channel):
    """The port's case: the Fig. 2 DAG's tensors cross the data plane as
    pickle-5 buffers (``cluster/serde.py``) under every fault class at
    once, bit for bit the sequential run's."""
    kw = dict(TCP) if channel == "tcp" else {}
    g, got, rep, seq = fig2_process_run(
        4, 32, 2, fault_plan=_combined_plan(), transport="sock",
        shm_threshold=1024,
        fetch_retry=RetryPolicy(attempts=3, base_delay=0.01, jitter=0.0),
        **kw)
    assert results_equal(got, seq)
    assert rep["stats"]["bytes_direct"] > 0
    assert rep["stats"]["tasks_run"]["mul"] >= 4


@pytest.mark.parametrize("channel", ["pipe", "tcp"])
def test_a_done_delivered_twice_counts_its_run_once(channel):
    """Every ``done`` frame duplicated by the channel: the run still equals
    the sequential one, and ``tasks_run`` and the workers' kernel launches
    equal the fault-free run's (a duplicated frame is not a run)."""
    kw = dict(TCP) if channel == "tcp" else {"channel": channel}
    _, clean, clean_rep, seq = fig2_process_run(4, 32, 2, **kw)
    plan = FaultPlan(seed=1).duplicate(verb="done", prob=1.0)
    _, got, rep, _ = fig2_process_run(4, 32, 2, fault_plan=plan, **kw)
    assert results_equal(got, seq) and results_equal(clean, seq)
    assert rep["stats"]["tasks_run"] == clean_rep["stats"]["tasks_run"] \
        == {"gen": 8, "mul": 4, "reduce": 1}
    assert rep["stats"]["kernel_launches"] \
        == clean_rep["stats"]["kernel_launches"]
    assert rep["stats"]["control_msgs"] > clean_rep["stats"]["control_msgs"]


# ------------------------------------------- degradation: flaky fetches

def test_persistent_fetch_faults_fall_back_to_relay():
    """Owner alive + retries exhausted => driver-relay fallback, NOT
    lineage recompute: ``deplost`` re-queues must prefer the relay."""
    g = shuffle_graph(producers=4, consumers=8)
    seq = execute_sequential(g)
    plan = FaultPlan(seed=31).fail_fetch()        # every attempt fails
    ex = ClusterExecutor(2, fault_plan=plan, transport="sock",
                         shm_threshold=64,
                         fetch_retry=RetryPolicy(attempts=2,
                                                 base_delay=0.01,
                                                 jitter=0.0))
    assert ex.run(g) == seq
    assert ex.stats["relay_fallbacks"] >= 1
    assert ex.stats["recomputed"] == 0            # owner never died
    assert ex.stats["deplosts"] >= 1
    # the driver-side plan object never fires fetch rules itself: the
    # hook runs on each worker's own (forked/pickled) copy
    assert plan.stats() == {}


def test_same_value_lost_twice_in_a_row():
    """The same value hitting ``TransferLost`` twice (several consumers
    racing on a dead data plane) must stay idempotent in the driver:
    one relay handle, no double recovery, bit-for-bit result."""
    g = shuffle_graph(producers=2, consumers=12)
    seq = execute_sequential(g)
    plan = FaultPlan(seed=32).fail_fetch()
    ex = ClusterExecutor(3, fault_plan=plan, transport="sock",
                         shm_threshold=64,
                         fetch_retry=RetryPolicy(attempts=2,
                                                 base_delay=0.01,
                                                 jitter=0.0))
    assert ex.run(g) == seq
    assert ex.stats["recomputed"] == 0
    assert ex.stats["deplosts"] >= 2
    assert ex.stats["failures"] == 0


# --------------------------------------- degradation: timed partitions

def test_timed_partition_heals_without_recompute():
    """A live worker partitioned past the heartbeat timeout but inside
    ``suspect_grace`` is suspected, drained, healed, and its in-flight
    work reconciled — ``recomputed == 0``."""
    g = two_chains(length=6, sleep=0.05)
    seq = execute_sequential(g)
    plan = FaultPlan(seed=41).sever(window=1.2, src=1, verb="done", nth=2)
    ex = ClusterExecutor(2, channel="tcp", fault_plan=plan,
                         heartbeat_interval=0.1, heartbeat_timeout=0.4,
                         suspect_grace=5.0)
    assert ex.run(g) == seq
    assert ex.stats["recomputed"] == 0
    assert ex.stats["suspected"] >= 1
    assert ex.stats["healed"] >= 1
    assert ex.stats["failures"] == 0


def test_partition_past_grace_escalates_to_recovery():
    """A partition longer than the grace is a death — lineage recovery
    still finishes the run bit-for-bit."""
    g = two_chains(length=6, sleep=0.05)
    seq = execute_sequential(g)
    plan = FaultPlan(seed=42).sever(window=8.0, src=1, verb="done", nth=2)
    ex = ClusterExecutor(2, channel="tcp", fault_plan=plan,
                         heartbeat_interval=0.1, heartbeat_timeout=0.3,
                         suspect_grace=0.5, progress_timeout=60.0)
    assert ex.run(g) == seq
    assert ex.stats["failures"] >= 1              # escalated to death
    assert ex.stats["recomputed"] >= 1            # lineage replayed


def test_quarantine_probe_readmit_round_trip():
    """Repeated suspect-then-heal episodes quarantine a flaky worker;
    ``probe_interval`` of healthy channel re-admits it."""
    g = two_chains(length=26, sleep=0.1)
    seq = execute_sequential(g)
    plan = (FaultPlan(seed=43)
            .sever(window=0.5, src=1, dst="driver", verb="hb", nth=1)
            .sever(window=0.5, src=1, dst="driver", verb="hb", nth=25))
    ex = ClusterExecutor(3, channel="tcp", fault_plan=plan,
                         heartbeat_interval=0.05, heartbeat_timeout=0.2,
                         suspect_grace=10.0, quarantine_after=2,
                         probe_interval=0.3)
    assert ex.run(g) == seq
    assert ex.stats["recomputed"] == 0
    assert ex.stats["healed"] >= 2
    assert ex.stats["quarantined"] >= 1
    assert ex.stats["readmitted"] >= 1
    assert ex.stats["failures"] == 0


# ------------------------------------------------- simulator modeling

def wide_graph(pkg: str, n: int = 24):
    """Independent unit tasks, ALL outputs — so a false death's lost
    values are values somebody still needs (the phantom-recovery term)."""
    core, _ = PKGS[pkg]
    g = core.TaskGraph()
    for i in range(n):
        def fn(_i=i):
            return _i + 1
        g.add_node(f"t{i}", fn, (), {}, core.TaskKind.PURE, deps=(),
                   cost=1.0)
        g.mark_output(i)
    return g


SIMS = {"ref": rsim, "port": psim}


def sim_key(res):
    return (res.makespan, res.timeline, res.n_suspected, res.n_healed,
            res.n_false_deaths, res.n_recomputed)


def partition_sim(pkg: str, outage: float):
    sim = SIMS[pkg]
    return sim.simulate(wide_graph(pkg), 3,
                        events=[sim.WorkerEvent(2.0, "partition", 1, outage)],
                        suspect_grace=5.0, seed=7)


def test_sim_partition_heals_inside_grace():
    res = partition_sim("port", 3.0)
    assert sim_key(res) == sim_key(partition_sim("ref", 3.0))
    assert res.n_suspected == 1 and res.n_healed == 1
    assert res.n_false_deaths == 0 and res.n_recomputed == 0


def test_sim_partition_past_grace_is_false_death():
    res = partition_sim("port", 20.0)
    assert res.n_false_deaths == 1
    assert res.n_recomputed >= 1   # phantom recovery: the waste term
    res2 = partition_sim("port", 20.0)
    assert res.makespan == res2.makespan and res.timeline == res2.timeline
    assert sim_key(res) == sim_key(partition_sim("ref", 20.0))


def test_sim_search_suspect_grace():
    def search(pkg):
        sim = SIMS[pkg]
        ev = [sim.WorkerEvent(3.0, "partition", 0, 4.0)]
        return sim.search_suspect_grace(exec_dag(9, 30, 0.3, pkg), 2,
                                        [0.5, 2.0, 8.0], events=ev, seed=3)

    best, results = search("port")
    rbest, rresults = search("ref")
    assert set(results) == {0.5, 2.0, 8.0}
    assert best in results and best == rbest
    assert {c: sim_key(r) for c, r in results.items()} == \
        {c: sim_key(r) for c, r in rresults.items()}
    assert results[8.0].n_healed == 1             # grace > outage: heals
    assert results[0.5].n_false_deaths == 1       # grace < outage: phantom
    with pytest.raises(ValueError):
        psim.search_suspect_grace(exec_dag(9, 30, 0.3), 2, [],
                                  events=[psim.WorkerEvent(
                                      3.0, "partition", 0, 4.0)])


def test_phantom_recovery_cost_matches_cluster_plan():
    def cost(fusion, lineage, pkg):
        g = exec_dag(17, 40, 0.3, pkg)
        plan = fusion.fuse(g, "off")
        values = set(g.nodes)
        suspect = {5, 11, 23}
        c = lineage.phantom_recovery_cost(plan, suspect, values)
        assert c == lineage.recovery_plan_clusters(plan, suspect,
                                                   values - suspect)
        return c

    got = cost(pfusion, plineage, "port")
    assert got == cost(rfusion, rlineage, "ref")
    assert got   # losing live values is never free on this DAG


# ------------------------------------------------------------ shm lease

# a pid in the kernel's valid range (< 2**22) that cannot exist: pids
# this high require pid_max raised to its ceiling AND full saturation
_GHOST_PID_HEX = f"{(1 << 22) - 1:x}"


def _seg(tmp_path, uuid8):
    """A bare run segment name as the executor mints them:
    ``rr<driver-pid:x><uuid8>``."""
    p = tmp_path / f"rr{_GHOST_PID_HEX}{uuid8}"
    p.write_bytes(b"x")
    return p, f"rr{_GHOST_PID_HEX}{uuid8}"


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_sweep_respects_resume_lease(tmp_path, pkg):
    """Each package sweeps the other's layout the same way: the port's
    leases are the reference's files."""
    mine = serde if pkg == "port" else rserde
    d = str(tmp_path)
    dead, _ = _seg(tmp_path, "aaaaaaaa")
    leased, leased_prefix = _seg(tmp_path, "bbbbbbbb")
    mine.write_resume_lease(leased_prefix, "run1", window=30.0,
                            shm_dir=d)
    expired, expired_prefix = _seg(tmp_path, "cccccccc")
    mine.write_resume_lease(expired_prefix, "run2", window=-120.0,
                            shm_dir=d)

    serde.sweep_stale_segments(d)
    assert not dead.exists()          # dead pid, no lease: swept
    assert leased.exists()            # live lease: protected
    assert not expired.exists()       # expired lease: reaped + swept
    assert not (tmp_path / f".rrlease-{expired_prefix}").exists()
    serde.clear_resume_lease(leased_prefix, shm_dir=d)
    assert not (tmp_path / f".rrlease-{leased_prefix}").exists()


def test_sweep_ignores_foreign_hex_names(tmp_path):
    """A foreign all-hex file name used to parse to a pid above the OS
    maximum and blow up ``os.kill`` with OverflowError."""
    foreign = tmp_path / ("rr" + "f" * 24)
    foreign.write_bytes(b"x")
    serde.sweep_stale_segments(str(tmp_path))      # must not raise
    assert foreign.exists()           # unparseable owner: left alone
