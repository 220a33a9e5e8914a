"""The port's fusion pass, simulator and adaptive cost model against the
reference's (``repro/core/{fusion,simulator,adaptive}.py``).

The same graphs are built in both packages from the same module-level
functions: seeded random DAGs, the 200-node DAG of ``tests/test_fusion.py``
and the paper's Fig. 2 DAG.  Both packages must fuse them into the same
clusters, simulate them to the same makespan and speculation picks, and
take the same adaptive decisions on a fixed recorded trace (no wall clock
enters any decision here).
"""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as rcore                                       # noqa: E402
import repro.core.adaptive as radaptive                          # noqa: E402
import repro.core.fusion as rfusion                              # noqa: E402
import repro.core.lineage as rlineage                            # noqa: E402
import repro.core.simulator as rsim                              # noqa: E402
from repro.core.tracing import RemappedRef as RRef               # noqa: E402

import repro_torch.core as pcore                                 # noqa: E402
import repro_torch.core.adaptive as padaptive                    # noqa: E402
import repro_torch.core.fusion as pfusion                        # noqa: E402
import repro_torch.core.lineage as plineage                      # noqa: E402
import repro_torch.core.simulator as psim                        # noqa: E402
from repro_torch.core.tracing import RemappedRef as PRef         # noqa: E402
from repro_torch.workloads import matrix_driver                  # noqa: E402

PKGS = {"ref": (rcore, RRef), "port": (pcore, PRef)}


# ------------------------------------------------ module-level task bodies

def _node(*xs, _i=0):
    return (_i + sum(xs) * 7) % 1_000_003


def _np_gen(seed, size):
    return np.random.default_rng(seed).standard_normal(
        (size, size), dtype=np.float32)


def _np_mul(a, b):
    return a @ b


def _np_red(*xs):
    return sum(float(x.sum(dtype=np.float64)) for x in xs)


# ----------------------------------------------------------- graph builders

def random_dag(pkg: str, seed: int, n: int, p: float):
    """Seeded random DAG with varied costs and sizes; every 13th node is a
    barrier and every 17th an effect (both stay singletons)."""
    core, Ref = PKGS[pkg]
    rng = random.Random(seed)
    g = core.TaskGraph()
    for i in range(n):
        deps = [j for j in range(i) if rng.random() < p][-3:]
        kind = (core.TaskKind.BARRIER if i % 13 == 12 else
                core.TaskKind.EFFECTFUL if i % 17 == 16 else
                core.TaskKind.PURE)
        g.add_node(f"t{i}", _node, tuple(Ref(d) for d in deps), {"_i": i},
                   kind, deps=deps, cost=rng.uniform(0.1, 1.0),
                   out_bytes=rng.choice([0, 256, 1 << 20]))
    g.mark_output(n - 1)
    return g


def fig2_dag(pkg: str, n_tasks: int = 16, size: int = 64):
    """The paper's Fig. 2 DAG, ``gen(2i), gen(2i+1) -> mul -> reduce``,
    traced with the package's own ``task``/``trace``."""
    core, _ = PKGS[pkg]
    nbytes = size * size * 4
    gen = core.task(_np_gen, cost=1.0, name="gen", out_bytes=nbytes)
    mul = core.task(_np_mul, cost=2.0, name="mul", out_bytes=nbytes)
    red = core.task(_np_red, cost=0.0, name="reduce")

    def driver():
        return red(*[mul(gen(2 * i, size), gen(2 * i + 1, size))
                     for i in range(n_tasks)])

    g, _ = core.trace(driver)
    return g


GRAPHS = {
    "random_s3": lambda pkg: random_dag(pkg, 3, 60, 0.3),
    "random_s11": lambda pkg: random_dag(pkg, 11, 90, 0.15),
    "random_s2024": lambda pkg: random_dag(pkg, 2024, 40, 0.5),
    "dag200": lambda pkg: random_dag(pkg, 42, 220, 0.25),
    "fig2": fig2_dag,
}


def plan_key(plan):
    return (plan.members, plan.cluster_of, plan.outputs, plan.ext_deps,
            plan.consumers, sorted(plan.cgraph.nodes),
            {c: (n.cost, n.out_bytes, n.deps)
             for c, n in plan.cgraph.nodes.items()})


# ------------------------------------------------------------------- fusion

@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("spec,kw", [("off", {}), ("auto", {}), (4, {}),
                                     ("auto", {"keep_parallelism": 2}),
                                     ("auto", {"fanin_cost": 0.5,
                                               "group_cost": 3.0})])
def test_fuse_gives_the_references_clusters(graph, spec, kw):
    ref = rfusion.fuse(GRAPHS[graph]("ref"), spec, **kw)
    port = pfusion.fuse(GRAPHS[graph]("port"), spec, **kw)
    assert plan_key(port) == plan_key(ref)
    assert port.n_clusters == ref.n_clusters and port.n_fused == ref.n_fused
    assert port.identity == ref.identity
    required = set(port.graph.outputs)
    assert port.worker_view(required) == pfusion.WorkerFusionView(
        **vars(ref.worker_view(required)))


def test_the_ports_fig2_workload_fuses_like_the_reference_dag():
    """The port's own traced workload has the reference DAG's shape, so it
    compiles to the same plan."""
    port, _ = pcore.trace(matrix_driver, 16, 64, device="cpu")
    ref = fig2_dag("ref", 16, 64)
    assert [(n.name, n.deps, n.cost, n.out_bytes) for n in port] == \
        [(n.name, n.deps, n.cost, n.out_bytes) for n in ref]
    for spec in ("off", "auto"):
        assert plan_key(pfusion.fuse(port, spec)) == \
            plan_key(rfusion.fuse(ref, spec))


@pytest.mark.parametrize("graph", ["random_s3", "dag200", "fig2"])
def test_cluster_lineage_agrees_on_fused_plans(graph):
    """``lineage.recovery_plan_clusters``, ``phantom_recovery_cost`` and
    ``outage_recovery`` (ported ahead of fusion) give the reference's plans
    on ported fused plans."""
    rp = rfusion.fuse(GRAPHS[graph]("ref"), "auto")
    pp = pfusion.fuse(GRAPHS[graph]("port"), "auto")
    rng = random.Random(7)
    tids, cids = sorted(pp.graph.nodes), sorted(pp.members)
    for _ in range(10):
        lost = set(rng.sample(tids, 3))
        avail = {t for t in tids if t not in lost and rng.random() < 0.6}
        claimed = {c for c in cids if rng.random() < 0.7}
        assert plineage.recovery_plan_clusters(pp, lost, avail) == \
            rlineage.recovery_plan_clusters(rp, lost, avail)
        assert plineage.phantom_recovery_cost(pp, lost, avail) == \
            rlineage.phantom_recovery_cost(rp, lost, avail)
        for outputs_only in (False, True):
            assert plineage.outage_recovery(
                pp, pp.graph, claimed, avail, outputs_only) == \
                rlineage.outage_recovery(rp, rp.graph, claimed, avail,
                                         outputs_only)


# ---------------------------------------------------------------- simulator

def sim_key(res):
    return (res.makespan, res.n_steals, res.n_recomputed, res.n_speculative,
            res.n_failures, res.speculated, res.task_worker, res.busy_time,
            res.refusions, res.refusion_times)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("seed", [0, 5])
def test_simulate_gives_the_references_makespan_and_speculation(graph, seed):
    kw = dict(seed=seed, policy="random", speculate_after=1.5,
              worker_speed=[1.0, 0.25, 1.0, 0.7], fuse="auto",
              dispatch_overhead=0.01, steal_latency=0.02)
    ref = rsim.simulate(GRAPHS[graph]("ref"), 4, **kw)
    port = psim.simulate(GRAPHS[graph]("port"), 4, **kw)
    assert sim_key(port) == sim_key(ref)
    if graph != "fig2":          # 11 clusters: no straggler at some seeds
        assert port.speculated, "the slow worker's tasks are speculated"


@pytest.mark.parametrize("graph", ["random_s11", "dag200"])
def test_simulated_failures_and_joins_recover_alike(graph):
    def events(sim):
        return [sim.WorkerEvent(2.0, "fail", 1),
                sim.WorkerEvent(3.0, "join", 4),
                sim.WorkerEvent(4.0, "slow", 0, 0.5),
                sim.WorkerEvent(5.0, "partition", 2, 7.0)]
    kw = dict(seed=1, fuse="auto", suspect_grace=5.0)
    ref = rsim.simulate(GRAPHS[graph]("ref"), 4, events=events(rsim), **kw)
    port = psim.simulate(GRAPHS[graph]("port"), 4, events=events(psim), **kw)
    assert sim_key(port) == sim_key(ref)
    assert (port.n_suspected, port.n_false_deaths) == \
        (ref.n_suspected, ref.n_false_deaths)
    assert port.n_recomputed > 0


def test_pick_speculation_agrees():
    rng = random.Random(3)
    for _ in range(50):
        running = {t: (rng.uniform(0, 5), rng.uniform(0.1, 2))
                   for t in rng.sample(range(40), rng.randint(0, 8))}
        after = rng.choice([1.0, 1.5, 3.0])
        assert psim.pick_speculation(running, after) == \
            rsim.pick_speculation(running, after)


# ------------------------------------------------------------------ adaptive

def _fixed_trace(adaptive, g, skewed: bool):
    """Member seconds proportional to declared cost, except every 7th task
    at ~100x its share when ``skewed`` (``tests/test_adaptive.py``)."""
    tasks = {t: g.nodes[t].cost * (0.4 if skewed and t % 7 == 0 else 0.004)
             for t in g.nodes}
    return adaptive.RunTrace(tasks=tasks, n_workers=4, unit_s=0.01,
                             dispatch_s=0.0004)


@pytest.mark.parametrize("skewed", [True, False])
@pytest.mark.parametrize("graph", ["random_s11", "dag200", "fig2"])
def test_run_trace_replay_gives_the_references_decisions(graph, skewed):
    def run(pkg, sim, adaptive):
        g = GRAPHS[graph](pkg)
        tr = _fixed_trace(adaptive, g, skewed)
        return sim.simulate(g, 4, fuse="auto", adaptive="auto", trace=tr,
                            dispatch_overhead=tr.dispatch_s)
    ref = run("ref", rsim, radaptive)
    port = run("port", psim, padaptive)
    assert sim_key(port) == sim_key(ref)
    if skewed and graph != "fig2":
        assert port.refusions >= 1


@pytest.mark.parametrize("knob,grid", [("keep_parallelism", [2, 4, 8]),
                                       ("speculate_after", [1.5, 3.0]),
                                       ("fanin_cost", [0.5, 2.0])])
def test_search_policy_agrees_on_a_recorded_trace(knob, grid):
    def search(pkg, sim, adaptive):
        g = GRAPHS["random_s11"](pkg)
        best, results = sim.search_policy(
            knob, g, 4, grid, trace=_fixed_trace(adaptive, g, True))
        return best, {c: sim_key(r) for c, r in results.items()}
    assert search("port", psim, padaptive) == search("ref", rsim, radaptive)


def test_cost_model_and_governor_take_the_references_decisions():
    rng = random.Random(9)
    models = (radaptive.CostModel(), padaptive.CostModel())
    govs = (radaptive.RefuseGovernor(skew_threshold=3.0),
            padaptive.RefuseGovernor(skew_threshold=3.0))
    node = rcore.TaskNode(0, "x", _node, (), {}, rcore.TaskKind.PURE, (),
                          (), cost=2.0)
    pnode = pcore.TaskNode(0, "x", _node, (), {}, pcore.TaskKind.PURE, (),
                           (), cost=2.0)
    decisions = ([], [])
    for step in range(60):
        units = rng.uniform(0.1, 3.0)
        wall = units * (0.3 if step % 9 == 0 else 0.003) * rng.uniform(0.8, 1.2)
        fn_units = (("_node", units), ("other", units / 2))
        for i, (mod, model, gov, n) in enumerate(
                ((radaptive, models[0], govs[0], node),
                 (padaptive, models[1], govs[1], pnode))):
            model.observe(units, wall, fn_units)
            model.observe_dispatch(0.001 * (step + 1), step + 1)
            due = mod.refusion_due(model, gov, n_frontier=step % 6)
            if due:
                gov.note_fired(model)
            decisions[i].append((
                due, model.unit_s, model.corrected_units(n),
                model.fuse_gates(1.0, 2.0), model.skew(), model.cv(),
                model.derived_speculate_after(), gov.fired,
                gov.last_skew, mod.fn_key(n)))
    assert decisions[1] == decisions[0]
    assert any(d[0] for d in decisions[1])


def test_run_trace_roundtrips_between_packages(tmp_path):
    g = GRAPHS["random_s3"]("port")
    tr = _fixed_trace(padaptive, g, True)
    path = str(tmp_path / "trace.json")
    tr.save(path)
    back = radaptive.RunTrace.load(path)
    assert vars(back) == vars(tr)
    members = sorted(g.nodes)[:5]
    assert back.cluster_seconds(members, g.nodes) == \
        tr.cluster_seconds(members, g.nodes)
