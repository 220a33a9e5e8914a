"""Profile-guided adaptive replanning in the port (``repro_torch/core/
adaptive.py``, the executor's re-fusion), held to the reference's suite
``tests/test_adaptive.py``.

Each reference test has a case here but two, which fail by turns on the
JAX package itself and wait until a cause is found:
``test_adaptive_stays_quiet_when_costs_are_honest`` and
``test_static_knobs_override_derivation``.  The deterministic parts (the
cost model's decisions, the governor, plan surgery, the simulator fed a
fixed trace, the offline searches) run through both packages on the same
inputs and must agree exactly; every live run equals the port's
``execute_sequential``.  The port adds the Fig. 2 DAG's torch tensors run
adaptively across a driver kill and a resume that replays the journal.
"""
import random
import time
import types

import pytest

torch = pytest.importorskip("torch")

import repro.core as rcore                                        # noqa: E402
import repro.core.adaptive as radaptive                           # noqa: E402
import repro.core.fusion as rfusion                               # noqa: E402
import repro.core.simulator as rsim                               # noqa: E402
from repro.core.tracing import RemappedRef as RRef                # noqa: E402

import repro_torch.core as pcore                                  # noqa: E402
import repro_torch.core.adaptive as padaptive                     # noqa: E402
import repro_torch.core.fusion as pfusion                         # noqa: E402
import repro_torch.core.simulator as psim                         # noqa: E402
from _propcheck import given, settings, st                        # noqa: E402
from repro_torch.cluster import ClusterExecutor, DriverKilled     # noqa: E402
from repro_torch.config import ClusterConfig                      # noqa: E402
from repro_torch.core import execute_sequential, simulate         # noqa: E402
from repro_torch.core.adaptive import (MAX_REFUSIONS, MIN_FRONTIER,  # noqa: E402
                                       MIN_OBS, CostModel,
                                       RefuseGovernor, RunTrace,
                                       refusion_due)
from repro_torch.core.tracing import RemappedRef as _Ref, trace   # noqa: E402
from repro_torch.workloads import matrix_driver                   # noqa: E402

from _torch_runtime import results_equal                          # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

PKGS = {"ref": (rcore, RRef, radaptive, rfusion, rsim),
        "port": (pcore, _Ref, padaptive, pfusion, psim)}


# ------------------------------------------------------------ workloads

def heavy_fn(x, s):
    time.sleep(s)
    return x * 3 + 1


def cheap_fn(x, s):
    time.sleep(s)
    return x + 1


def comb(*xs):
    return sum(int(x) for x in xs) % 1_000_003


def lopsided(width=24, n_heavy=6, heavy_s=0.05, cheap_s=0.001,
             miscosted=True):
    """Two wide epochs pinched through dual-gate reductions; the first
    ``n_heavy`` tasks per epoch sleep ~50x longer than the rest while
    (when ``miscosted``) declaring the same ``cost=1.0`` — epoch 1 is
    calibration data, epoch 2 the re-fusable frontier."""
    hc = 1.0 if miscosted else heavy_s / cheap_s
    g = pcore.TaskGraph()

    def layer(dep):
        tids = []
        for i in range(width):
            heavy = i < n_heavy
            t = len(g.nodes)
            fn = heavy_fn if heavy else cheap_fn
            s = heavy_s if heavy else cheap_s
            g.add_node(f"w{t}", fn,
                       (_Ref(dep), s) if dep is not None else (i, s), {},
                       pcore.TaskKind.PURE,
                       deps=[dep] if dep is not None else [],
                       cost=hc if heavy else 1.0)
            tids.append(t)
        return tids

    def gatepair(tids):
        a = g.add_node("ga", comb, tuple(_Ref(t) for t in tids), {},
                       pcore.TaskKind.PURE, deps=tids, cost=1.0)
        b = g.add_node("gb", comb, tuple(_Ref(t) for t in tids), {},
                       pcore.TaskKind.PURE, deps=tids, cost=1.0)
        return g.add_node("gc", comb, (_Ref(a), _Ref(b)), {},
                          pcore.TaskKind.PURE, deps=[a, b], cost=1.0)

    g.mark_output(gatepair(layer(gatepair(layer(None)))))
    return g


def sim_dag(seed: int, n: int = 40, p: float = 0.2, pkg: str = "port"):
    """Fn-less random DAG for pure simulator sweeps."""
    core = PKGS[pkg][0]
    rng = random.Random(seed)
    g = core.TaskGraph()
    for i in range(n):
        deps = [j for j in range(i) if rng.random() < p][-4:]
        g.add_node(f"t{i}", None, (), {}, core.TaskKind.PURE, deps=deps,
                   cost=rng.uniform(0.1, 4.0))
    g.mark_output(n - 1)
    return g


def _adaptive_cfg(**kw) -> ClusterConfig:
    return ClusterConfig(n_workers=kw.pop("n_workers", 4), channel="pipe",
                         fuse="auto", adaptive="auto",
                         progress_timeout=120.0, **kw)


# ------------------------------------------- property: scale invariance

def _tmpl_a(x):
    return x


def _tmpl_b(x):
    return x


def _decisions(adaptive, seed, k):
    """Feeds one seeded run to a cost model with its wall clocks times k;
    returns every decision it takes, in order."""
    rng = random.Random(seed)
    m, gov = adaptive.CostModel(), adaptive.RefuseGovernor()
    node_a = types.SimpleNamespace(cost=2.0, fn=_tmpl_a)
    node_b = types.SimpleNamespace(cost=0.7, fn=_tmpl_b)
    out = []
    for i in range(1, 25):
        units = rng.uniform(0.5, 4.0)
        wall = rng.uniform(0.002, 0.05) * (40.0 if rng.random() < 0.25
                                           else 1.0)
        key = rng.choice([adaptive.fn_key(node_a), adaptive.fn_key(node_b),
                          None])
        m.observe(units, wall * k, fn_units=((key, units),))
        m.observe_dispatch(0.0004 * i * k, i)
        derived = m.derived_speculate_after()
        n_frontier = rng.randint(0, 12)
        fire = adaptive.refusion_due(m, gov, n_frontier)
        if fire:
            gov.note_fired(m)
        out.append((m.skew(), m.cv(),
                    [m.corrected_units(n) for n in (node_a, node_b)],
                    m.fuse_gates(30.0, 6.0), derived, fire))
    return out, gov.fired


@given(st.tuples(st.integers(0, 10_000), st.sampled_from(
    [1e-3, 0.1, 3.0, 250.0, 1e4])))
@settings(max_examples=30, deadline=None)
def test_cost_model_decisions_are_scale_invariant(params):
    """Feeding the same run with all wall clocks multiplied by k changes
    no decision; and the port's cost model takes the reference's
    decisions on the same run."""
    seed, k = params
    a, fired_a = _decisions(padaptive, seed, 1.0)
    b, fired_b = _decisions(padaptive, seed, k)
    for (sa, ca, ua, ga, da, fa), (sb, cb, ub, gb, db, fb) in zip(a, b):
        assert sa == pytest.approx(sb) and ca == pytest.approx(cb)
        assert ua == pytest.approx(ub) and ga == pytest.approx(gb)
        assert (da is None) == (db is None)
        if da is not None:
            assert da == pytest.approx(db)
        assert fa == fb
    assert fired_a == fired_b <= MAX_REFUSIONS
    assert _decisions(radaptive, seed, k) == (b, fired_b)


def test_governor_hysteresis_and_caps():
    """No decision before MIN_OBS fresh observations, no fire below
    MIN_FRONTIER, window reset after a fire, hard cap at MAX_REFUSIONS —
    the reference's constants and verdicts."""
    assert (MIN_OBS, MIN_FRONTIER, MAX_REFUSIONS) == \
        (radaptive.MIN_OBS, radaptive.MIN_FRONTIER, radaptive.MAX_REFUSIONS)
    m, gov = CostModel(), RefuseGovernor()
    for _ in range(MIN_OBS - 1):
        m.observe(1.0, 0.001)
    m.observe(1.0, 1.0)                       # one huge outlier
    assert not refusion_due(m, gov, MIN_FRONTIER - 1)   # frontier too small
    assert refusion_due(m, gov, MIN_FRONTIER)
    gov.note_fired(m)
    # the outlier is *history* now: the fresh window must re-earn a fire
    assert not refusion_due(m, gov, 10)
    fires = 1
    while fires < MAX_REFUSIONS + 2:
        for _ in range(MIN_OBS - 1):
            m.observe(1.0, 0.001)
        m.observe(1.0, 1.0)
        if refusion_due(m, gov, 10):
            gov.note_fired(m)
            fires += 1
        else:
            break
    assert gov.fired == fires == MAX_REFUSIONS


# --------------------------------- property: plan surgery is structure-safe

def _refuse(pkg, seed, kp):
    _, _, _, fusion, _ = PKGS[pkg]
    g = sim_dag(seed, n=50, p=0.25, pkg=pkg)
    plan = fusion.fuse(g, "auto", keep_parallelism=8)
    old_consumers = {v: len(cs) for v, cs in plan.consumers.items()}
    frontier = sorted(plan.cgraph.nodes)        # nothing dispatched yet
    out = fusion.refuse_frontier(plan, frontier, keep_parallelism=kp,
                                 cost_of=lambda n: n.cost * 3.0)
    if out is None:                              # partition unchanged
        return g, plan, None, old_consumers, None
    retired, new_clusters = out
    delta = fusion.splice_plan(plan, retired, new_clusters)
    return g, plan, out, old_consumers, delta


@given(st.tuples(st.integers(0, 5_000), st.integers(2, 6)))
@settings(max_examples=20, deadline=None)
def test_refuse_frontier_splice_preserves_partition(params):
    """Re-fusing the full frontier under a different parallelism floor
    must keep the member partition exact, keep the cluster DAG valid, and
    report consumer deltas that reconcile the old and new consumer
    indexes — with the reference's surgery on the same graph."""
    seed, kp = params
    g, plan, out, old_consumers, delta = _refuse("port", seed, kp)
    _, rplan, rout, _, rdelta = _refuse("ref", seed, kp)
    assert out == rout and delta == rdelta
    assert plan.members == rplan.members
    if out is None:
        return
    seen = [m for ms in plan.members.values() for m in ms]
    assert sorted(seen) == sorted(g.nodes)
    assert set(plan.members) == set(plan.cgraph.nodes)
    for cid, ms in plan.members.items():
        for m in ms:
            assert plan.cluster_of[m] == cid
    plan.cgraph.validate()
    assert plan.cgraph.topo_order()              # acyclic, deps present
    new_consumers = {v: len(cs) for v, cs in plan.consumers.items()}
    for v in set(old_consumers) | set(new_consumers) | set(delta):
        assert (old_consumers.get(v, 0) + delta.get(v, 0)
                == new_consumers.get(v, 0)), v


# ------------------------------------ determinism: trace-driven simulator

def _fixed_trace(g, skewed: bool, pkg: str = "port"):
    """Honest trace: member seconds proportional to declared cost.  Skewed
    trace: every 7th task runs ~100x its proportional share."""
    tasks = {t: g.nodes[t].cost * (0.4 if skewed and t % 7 == 0
                                   else 0.004)
             for t in g.nodes}
    return PKGS[pkg][2].RunTrace(tasks=tasks, n_workers=4, unit_s=0.01,
                                 dispatch_s=0.0004)


def test_fixed_trace_gives_deterministic_replan_decisions():
    def run(pkg, skewed):
        sim = PKGS[pkg][4]
        g = sim_dag(11, n=60, pkg=pkg)
        tr = _fixed_trace(g, skewed, pkg)
        return sim.simulate(g, 4, fuse="auto", adaptive="auto", trace=tr,
                            dispatch_overhead=tr.dispatch_s)

    r1, r2 = run("port", True), run("port", True)
    assert r1.makespan == r2.makespan
    assert r1.refusions == r2.refusions >= 1
    assert r1.refusion_times == r2.refusion_times
    rr = run("ref", True)
    assert (r1.makespan, r1.refusions, r1.refusion_times) == \
        (rr.makespan, rr.refusions, rr.refusion_times)
    # honest costs, uniform durations: the governor must stay quiet
    assert run("port", False).refusions == 0 == run("ref", False).refusions


def test_run_trace_roundtrip(tmp_path):
    g = sim_dag(3, n=12)
    tr = _fixed_trace(g, skewed=True)
    path = str(tmp_path / "trace.json")
    tr.save(path)
    back = RunTrace.load(path)
    assert back == tr
    members = sorted(g.nodes)[:5]
    assert back.cluster_seconds(members, g.nodes) == pytest.approx(
        tr.cluster_seconds(members, g.nodes))
    # the reference loads the port's file to an equal trace
    rback = radaptive.RunTrace.load(path)
    assert (rback.tasks, rback.n_workers, rback.unit_s, rback.dispatch_s) \
        == (back.tasks, back.n_workers, back.unit_s, back.dispatch_s)


# --------------------------------------- live executor <-> sim agreement

def test_adaptive_refuses_midrun_and_matches_oracle_and_sim_agrees():
    """On the mis-costed lopsided workload the live adaptive run must
    re-fuse mid-run, stay bit-for-bit equal to the sequential oracle, and
    the simulator fed the recorded trace must agree that re-fusion
    fires."""
    g = lopsided()
    seq = execute_sequential(lopsided())
    ex = ClusterExecutor(config=_adaptive_cfg())
    got = ex.run(g)
    ex.close()
    assert got == seq
    assert ex.stats["refusions"] >= 1
    assert ex.stats["replan_triggers"] >= 1
    assert ex.stats["cost_unit_s"] > 0
    assert ex.stats["adaptive_skew"] > 4.0
    trace_ = ex.last_trace
    assert trace_ is not None and trace_.unit_s > 0
    res = simulate(lopsided(), 4, fuse="auto", adaptive="auto",
                   trace=trace_, dispatch_overhead=trace_.dispatch_s)
    assert res.refusions >= 1


def test_resume_replays_journaled_refusions(tmp_path):
    """Kill the driver after re-fusion fired; the resumed incarnation must
    replay the journaled splices (refusions_replayed) before adopting
    done-claims, and finish bit-for-bit."""
    g = lopsided()
    seq = execute_sequential(lopsided())
    ex = ClusterExecutor(config=_adaptive_cfg(
        checkpoint_dir=str(tmp_path), checkpoint_interval=0.0,
        fail_driver=14))
    with pytest.raises(DriverKilled):
        ex.run(g)
    ex.close()
    assert ex.stats["refusions"] >= 1
    ex2 = ClusterExecutor(config=_adaptive_cfg(
        checkpoint_dir=str(tmp_path), checkpoint_interval=0.0,
        resume=ex.run_id))
    got = ex2.run(lopsided())
    ex2.close()
    assert got == seq
    assert ex2.stats["refusions_replayed"] >= 1


def test_fig2_tensors_adaptive_across_a_driver_kill(tmp_path):
    """The port's case: the Fig. 2 DAG's tensors run adaptively on 4
    forked workers, the driver killed after 5 completions (of 11 fused
    clusters) and resumed from the log: the resumed run adopts the log's
    clusters and returns the sequential run's values bit for bit."""
    def graph():
        return trace(matrix_driver, 16, 32, device="cpu")[0]

    seq = execute_sequential(graph())
    ex = ClusterExecutor(config=_adaptive_cfg(
        checkpoint_dir=str(tmp_path), checkpoint_interval=0.0,
        fail_driver=5))
    with pytest.raises(DriverKilled):
        ex.run(graph())
    ex.close()
    ex2 = ClusterExecutor(config=_adaptive_cfg(
        checkpoint_dir=str(tmp_path), checkpoint_interval=0.0,
        resume=ex.run_id))
    got = ex2.run(graph())
    ex2.close()
    assert results_equal(got, seq)
    assert ex2.stats["resumed_clusters"] > 0


# ------------------------------------------------- offline search front door

def test_search_policy_wrappers_are_equivalent():
    def searches(pkg):
        sim = PKGS[pkg][4]
        g = sim_dag(21, n=50, pkg=pkg)
        ev = [sim.WorkerEvent(time=2.0, kind="partition", worker=0,
                              factor=4.0)]
        b1, r1 = sim.search_suspect_grace(g, 3, [0.5, 2.0, 8.0], events=ev)
        b2, r2 = sim.search_policy("suspect_grace", g, 3, [0.5, 2.0, 8.0],
                                   events=ev)
        b3, _ = sim.search_collective_arity(g, 3, [2, 4])
        b4, _ = sim.search_policy("collective_arity", g, 3, [2, 4])
        return (b1, b2, b3, b4, {c: r.makespan for c, r in r1.items()},
                {c: r.makespan for c, r in r2.items()})

    b1, b2, b3, b4, m1, m2 = searches("port")
    assert b1 == b2 and m1 == m2 and b3 == b4
    assert searches("ref") == (b1, b2, b3, b4, m1, m2)


def test_search_policy_knobs_and_errors():
    def search(pkg, knob, grid):
        sim = PKGS[pkg][4]
        g = sim_dag(5, n=40, pkg=pkg)
        return sim.search_policy(knob, g, 4, grid,
                                 trace=_fixed_trace(g, True, pkg))

    for knob, grid in (("speculate_after", [1.5, 4.0]),
                       ("keep_parallelism", [2, 8]),
                       ("fanin_cost", [1.0, 30.0]),
                       ("group_cost", [1.0, 6.0])):
        best, results = search("port", knob, grid)
        assert best in grid and set(results) == set(grid)
        assert all(r.makespan > 0 for r in results.values())
        rbest, rresults = search("ref", knob, grid)
        assert best == rbest
        assert {c: r.makespan for c, r in results.items()} == \
            {c: r.makespan for c, r in rresults.items()}
    g = sim_dag(5, n=40)
    with pytest.raises(ValueError, match="unknown policy knob"):
        psim.search_policy("nope", g, 4, [1])
    with pytest.raises(ValueError, match="need at least one candidate"):
        psim.search_policy("speculate_after", g, 4, [])
    with pytest.raises(ValueError, match="partition events"):
        psim.search_policy("suspect_grace", g, 4, [1.0])
