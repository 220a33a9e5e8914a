"""The port's graph-level collectives (``repro_torch/core/collectives.py``):
tracing, tree lowering, the scheduler's price, cluster execution and
recovery, held to the reference's suite ``tests/test_collectives.py``.

Each reference test has a case here.  Payloads are torch tensors made from
the reference's numpy draws.  The deterministic parts run through both
packages on the same inputs and must agree exactly: spec parsing,
``tree_fold``'s bracketing (the port's float32 tensors carry the
reference's numpy bits), the lowered graph's shape, the simulator's
verdicts and the recovery plans.  Every live run equals the port's
``execute_sequential``.  The port adds the Fig. 2 DAG whose 16 products a
traced ``all_reduce`` sums, on a cluster across a SIGKILL.
"""
import argparse

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as rcore                                        # noqa: E402
import repro.core.collectives as rcoll                            # noqa: E402
import repro.core.fusion as rfusion                               # noqa: E402
import repro.core.lineage as rlineage                             # noqa: E402
import repro.core.scheduler as rsched                             # noqa: E402
import repro.core.simulator as rsim                               # noqa: E402
from repro.core.tracing import RemappedRef as RRef                # noqa: E402

import repro_torch.core as pcore                                  # noqa: E402
import repro_torch.core.collectives as pcoll                      # noqa: E402
import repro_torch.core.fusion as pfusion                         # noqa: E402
import repro_torch.core.lineage as plineage                       # noqa: E402
import repro_torch.core.scheduler as psched                       # noqa: E402
import repro_torch.core.simulator as psim                         # noqa: E402
from repro_torch.cluster import ClusterExecutor                   # noqa: E402
from repro_torch.core import (TaskKind, ThreadedExecutor,         # noqa: E402
                              all_reduce, broadcast,
                              execute_sequential, gather, scatter, task,
                              trace)
from repro_torch.core.collectives import (add_all_reduce,         # noqa: E402
                                          add_broadcast, add_gather,
                                          collective_stages,
                                          lower_collectives)
from repro_torch.core.fusion import fuse as fuse_graph            # noqa: E402
from repro_torch.core.tracing import RemappedRef as _Ref          # noqa: E402
from repro_torch.workloads import _gen, _mul, _red                # noqa: E402

from _torch_runtime import as_numpy, same_value                   # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

PKGS = {"ref": (rcore, rcoll, RRef), "port": (pcore, pcoll, _Ref)}


# ----------------------------------------------------------------- helpers

def same(got, want):
    """Bit-for-bit dict equality that understands tensors and tuples."""
    assert got.keys() == want.keys()
    for k in want:
        assert same_value(got[k], want[k]), k


def same_as_reference(port_value, ref_value, what):
    """A port value (tensors) carries the reference's (numpy) bits."""
    assert same_value(as_numpy(port_value), ref_value), what


def _draw(i, elems):
    # irrational-ish scale: float32 addition order changes bits
    return (np.arange(1, elems + 1, dtype=np.float32)
            * np.float32(0.1 + 0.7 * i))


def _p_np(_i, _n):
    return _draw(_i, _n)


def _p_torch(_i, _n):
    return torch.from_numpy(_draw(_i, _n))


def producers_graph(n, elems=64, pkg="port"):
    """n float32 producers whose sums are order-sensitive in float32: torch
    tensors in the port's graph, the same numpy draws in the
    reference's."""
    core, _, _ = PKGS[pkg]
    fn = _p_torch if pkg == "port" else _p_np
    g = core.TaskGraph()
    tids = [g.add_node(f"p{i}", fn, (i, elems), {}, core.TaskKind.PURE,
                       deps=(), out_bytes=elems * 4) for i in range(n)]
    return g, tids


def lowered_results(g, spec="auto", pkg="port"):
    """Sequential results of the lowered graph, keyed by ORIGINAL tid."""
    core, coll, _ = PKGS[pkg]
    low, o2n = coll.lower_collectives(g, spec)
    res = core.execute_sequential(low)
    if o2n is None:
        return res
    return {old: res[new] for old, new in o2n.items()}


def shape_of(graph):
    return [(t, n.name, n.kind.value, n.deps, n.cost, n.out_bytes,
             n.meta.get("collective"), n.meta.get("collective_stage"))
            for t, n in sorted(graph.nodes.items())]


# ------------------------------------------------------------- unit: spec

def test_parse_collectives_spec():
    for coll in (pcoll, rcoll):
        assert coll.parse_collectives_spec(None) == "off"
        assert coll.parse_collectives_spec(False) == "off"
        assert coll.parse_collectives_spec("off") == "off"
        assert coll.parse_collectives_spec("none") == "off"
        assert coll.parse_collectives_spec(True) == "auto"
        assert coll.parse_collectives_spec("auto") == "auto"
        assert coll.parse_collectives_spec(3) == 3
        assert coll.parse_collectives_spec(" 8 ") == 8
        for bad in (1, 0, -2, "1", "junk", 2.5):
            with pytest.raises(ValueError):
                coll.parse_collectives_spec(bad)


def test_resolve_op():
    a = torch.from_numpy(_draw(1, 8))
    b = torch.from_numpy(_draw(2, 8)[::-1].copy())
    for name in ("sum", "max", "min", "concat"):
        got_name, fn = pcoll.resolve_op(name)
        assert got_name == name and callable(fn)
        _, rfn = rcoll.resolve_op(name)
        same_as_reference(fn(a, b), rfn(a.numpy(), b.numpy()), name)
    name, fn = pcoll.resolve_op(lambda a, b: a * b)
    assert callable(fn)
    with pytest.raises(ValueError):
        pcoll.resolve_op("median")


def test_tree_fold_and_depth():
    for n in (1, 2, 3, 5, 9, 17):
        vals = list(range(1, n + 1))
        for arity in (2, 3, 4):
            assert pcoll.tree_fold(vals, lambda a, b: a + b, arity) \
                == sum(vals)
            d = pcoll.tree_depth(n, arity)
            assert d == rcoll.tree_depth(n, arity) and d >= 0
            # depth is the number of non-root levels the lowering emits
            m, want = n, 0
            while m > arity:
                m = -(-m // arity)
                want += 1
            assert d == want
            # the bracketing itself, in both packages
            assert pcoll.tree_fold(vals, lambda a, b: (a, b), arity) \
                == rcoll.tree_fold(vals, lambda a, b: (a, b), arity)
    with pytest.raises(ValueError):
        pcoll.tree_fold([], lambda a, b: a + b, 2)


def test_tree_fold_bracketing_is_its_own_semantics():
    """float32 sums depend on bracketing: the tree fold and the naive
    left fold genuinely differ on this data, and the port's tree over
    torch tensors gives the reference's numpy bits."""
    rng = np.random.RandomState(7)
    draws = [rng.randn(257).astype(np.float32) * (10.0 ** (i % 7 - 3))
             for i in range(17)]
    vals = [torch.from_numpy(v) for v in draws]
    _, add = pcoll.resolve_op("sum")
    tree = pcoll.tree_fold(vals, add, 2)
    flat = vals[0]
    for v in vals[1:]:
        flat = flat + v
    assert not torch.equal(tree, flat)      # non-associativity is real
    again = pcoll.tree_fold(list(vals), add, 2)
    assert torch.equal(tree, again)         # but the tree is deterministic
    _, radd = rcoll.resolve_op("sum")
    same_as_reference(tree, rcoll.tree_fold(draws, radd, 2), "tree")


def test_chunk_bounds_match_array_split():
    for length in (0, 1, 7, 12, 13):
        for n in (1, 2, 3, 5):
            x = np.arange(length)
            want = [a.tolist() for a in np.array_split(x, n)]
            got = [x[a:b].tolist()
                   for a, b in pcoll._chunk_bounds(length, n)]
            assert got == want, (length, n)
            assert pcoll._chunk_bounds(length, n) \
                == rcoll._chunk_bounds(length, n)


# ------------------------------------------- lowering: bit-equality sweep

@pytest.mark.parametrize("arity", [2, 3, 4])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 9, 17])
def test_all_reduce_lowering_bit_equal(n, arity):
    def build(pkg):
        _, coll, _ = PKGS[pkg]
        g, tids = producers_graph(n, pkg=pkg)
        ar = coll.add_all_reduce(g, tids, "sum", arity=arity,
                                 out_bytes=64 * 4)
        g.mark_output(ar)
        return g, ar

    g, ar = build("port")
    dense = execute_sequential(g)
    low = lowered_results(g)
    assert same_value(low[ar], dense[ar]), ("all_reduce", n, arity)
    # an integer spec must NOT reshape a reduction in executor mode —
    # the traced bracketing IS the value, so the override stays bit-equal
    low3 = lowered_results(g, spec=3)
    assert same_value(low3[ar], dense[ar]), ("override", n, arity)
    # the reference's lowering: the same graph shape, the same bits
    rg, rar = build("ref")
    assert shape_of(lower_collectives(g, "auto")[0]) \
        == shape_of(rcoll.lower_collectives(rg, "auto")[0])
    same_as_reference(low[ar], lowered_results(rg, pkg="ref")[rar],
                      ("reference", n, arity))


def test_sim_mode_reshapes_reduce_trees_executor_mode_does_not():
    g, tids = producers_graph(17)
    ar = add_all_reduce(g, tids, "sum", arity=2, out_bytes=64 * 4)
    g.mark_output(ar)
    exec_low, _ = lower_collectives(g, 8)
    sim_low, _ = lower_collectives(g, 8, reshape_reductions=True)
    arity2, _ = lower_collectives(g, "auto")
    # executor mode keeps the traced arity-2 tree under a spec of 8 ...
    assert len(exec_low.nodes) == len(arity2.nodes)
    # ... while the simulator's reshape really is an arity-8 tree
    assert len(sim_low.nodes) < len(exec_low.nodes)
    rg, rtids = producers_graph(17, pkg="ref")
    rar = rcoll.add_all_reduce(rg, rtids, "sum", arity=2, out_bytes=64 * 4)
    rg.mark_output(rar)
    assert shape_of(sim_low) == shape_of(
        rcoll.lower_collectives(rg, 8, reshape_reductions=True)[0])


def test_gather_lowering_preserves_order():
    for n in (1, 2, 5, 9):
        g, tids = producers_graph(n)
        gt = add_gather(g, tids, arity=2, out_bytes=64 * 4 * n)
        g.mark_output(gt)
        dense = execute_sequential(g)
        low = lowered_results(g)
        assert isinstance(low[gt], tuple) and len(low[gt]) == n
        for a, b in zip(low[gt], dense[gt]):
            assert torch.equal(a, b)


def _consumer(x, _j=0):
    return float((x * np.float32(_j + 1)).sum())


def test_broadcast_copy_tree_rewires_consumers():
    g, tids = producers_graph(3)
    ar = add_all_reduce(g, tids, "sum", arity=2, out_bytes=64 * 4)
    bc = add_broadcast(g, ar, arity=2, out_bytes=64 * 4)
    cons = [g.add_node(f"c{j}", _consumer, (_Ref(bc),), {"_j": j},
                       TaskKind.PURE, deps=(bc,)) for j in range(10)]
    for t in cons:
        g.mark_output(t)
    dense = execute_sequential(g)
    low, o2n = lower_collectives(g, "auto")
    copies = collective_stages(low, bc)
    assert copies, "10 consumers over arity 2 must grow a copy tree"
    # each consumer reads a copy node, never the root; <= arity consumers
    # per copy
    root_new = o2n[bc]
    fanout = {}
    for t in cons:
        (dep,) = low.nodes[o2n[t]].deps
        assert dep != root_new
        assert dep in copies
        fanout[dep] = fanout.get(dep, 0) + 1
    assert all(k <= 2 for k in fanout.values())
    res = execute_sequential(low)
    for t in cons:
        assert res[o2n[t]] == dense[t]


def test_scatter_projections_become_direct_chunk_reads():
    @task(cost=1.0)
    def seed():
        return torch.from_numpy(np.arange(13, dtype=np.float32)
                                * np.float32(1.7))

    @task(cost=1.0)
    def consume(part, j):
        return float(part.sum()) + j

    def driver():
        x = seed()
        parts = scatter(x, 4, arity=4)
        return [consume(parts[i], i) for i in range(4)]

    g, _ = trace(driver)
    dense = execute_sequential(g)
    low, o2n = lower_collectives(g, "auto")
    # the lowered graph reads chunks straight off the source: no node
    # depends on the dense scatter tuple any more
    scatter_new = [o2n[t] for t, n in g.nodes.items()
                   if n.meta.get("collective", {}).get("op") == "scatter"]
    (sc,) = scatter_new
    assert all(sc not in n.deps for n in low.nodes.values())
    res = execute_sequential(low)
    for old, new in o2n.items():
        if old in g.outputs:
            assert res[new] == dense[old]
    # uneven split: chunk sizes follow np.array_split (4+3+3+3)
    chunks = [res[o2n[t]] for t, n in g.nodes.items()
              if n.kind is TaskKind.PROJECTION]
    assert sorted(len(c) for c in chunks) == [3, 3, 3, 4]


def test_lowering_identity_when_off_or_collective_free():
    g, tids = producers_graph(3)
    ar = add_all_reduce(g, tids, "sum", arity=2)
    g.mark_output(ar)
    same_g, o2n = lower_collectives(g, "off")
    assert same_g is g and o2n is None
    g2, _ = producers_graph(3)
    same_g2, o2n2 = lower_collectives(g2, "auto")
    assert same_g2 is g2 and o2n2 is None


def _sum_times(x, _j=0):
    return float(x.sum()) * (_j + 1)


def test_lowering_is_deterministic():
    def build(pkg):
        core, coll, Ref = PKGS[pkg]
        g, tids = producers_graph(9, pkg=pkg)
        ar = coll.add_all_reduce(g, tids, "sum", arity=2, out_bytes=64 * 4)
        bc = coll.add_broadcast(g, ar, arity=2, out_bytes=64 * 4)
        for j in range(6):
            g.add_node(f"c{j}", _sum_times, (Ref(bc),), {"_j": j},
                       core.TaskKind.PURE, deps=(bc,))
        g.mark_output(ar)
        return coll.lower_collectives(g, "auto")[0]

    a, b = build("port"), build("port")
    assert shape_of(a) == shape_of(b)
    assert shape_of(a) == shape_of(build("ref"))


def test_duplicate_ref_participates_twice():
    g, tids = producers_graph(2)
    # a + a + b: the same ref twice must fold twice, like the dense fn
    ar = add_all_reduce(g, [tids[0], tids[0], tids[1]], "sum", arity=2)
    g.mark_output(ar)
    dense = execute_sequential(g)
    low = lowered_results(g)
    assert same_value(low[ar], dense[ar]), "dup-ref"


def test_collective_stages_are_singleton_fusion_clusters():
    g, tids = producers_graph(9)
    ar = add_all_reduce(g, tids, "sum", arity=2, out_bytes=64 * 4)
    g.mark_output(ar)
    low, o2n = lower_collectives(g, "auto")
    plan = fuse_graph(low, "auto")
    for t in collective_stages(low, ar) + [o2n[ar]]:
        assert plan.members[plan.cluster_of[t]] == (t,), \
            "collective hops must stay their own super-task"


# ----------------------------------------------------- tracing-level API

def test_traced_collectives_end_to_end():
    @task(cost=1.0)
    def seed(i):
        return torch.from_numpy(np.arange(32, dtype=np.float32)
                                * np.float32(0.3 * (i + 1)))

    @task(cost=1.0)
    def use(x, j):
        return float(x.sum()) * (j + 1)

    def driver():
        xs = [seed(i) for i in range(5)]
        total = all_reduce(xs, "sum", arity=2)
        copy = broadcast(total, arity=2)
        parts = gather(xs, arity=2)
        return [use(copy, j) for j in range(5)], parts

    g, _ = trace(driver)
    dense = execute_sequential(g)
    low = lowered_results(g)
    same({t: low[t] for t in g.outputs}, {t: dense[t] for t in g.outputs})
    # threaded executor runs the dense collective nodes unchanged
    thr = ThreadedExecutor(2).run(g)
    same({t: thr[t] for t in g.outputs}, {t: dense[t] for t in g.outputs})


def test_collectives_outside_trace_raise():
    with pytest.raises(RuntimeError):
        all_reduce([])
    with pytest.raises(RuntimeError):
        broadcast(None)


# ------------------------------------------------------------- rendering

def test_to_dot_and_summary_render_collectives():
    g, tids = producers_graph(9)
    ar = add_all_reduce(g, tids, "sum", arity=2, out_bytes=64 * 4)
    g.mark_output(ar)
    dot = g.to_dot()
    assert "doubleoctagon" in dot
    assert "all_reduce(n=9, arity=2)" in dot
    assert "collectives={'all_reduce': 1}" in g.summary()
    low, _ = lower_collectives(g, "auto")
    ldot = low.to_dot()
    assert f"stage L0 of #{ar}" in ldot
    assert "collectives={'all_reduce': 1}" in low.summary()
    rg, rtids = producers_graph(9, pkg="ref")
    rcoll.add_all_reduce(rg, rtids, "sum", arity=2, out_bytes=64 * 4)
    assert rg.summary() == g.summary()


# ------------------------------------------------------ scheduling price

def test_collective_comm_cost_beats_point_to_point_when_wide():
    cost = psched.collective_comm_cost
    p2p = 16 * 32 * 1024 / 1e6
    tree = cost(16, 32, 1024, 1e6, arity=4)
    assert 0 < tree < p2p / 2
    # single consumer, tiny n: point-to-point is not worse
    assert cost(2, 1, 1024, 1e6) >= 2 * 1 * 1024 / 1e6
    # host boundaries are priced: crossing hosts costs more than one host
    one = cost(16, 8, 1024, 1e6, n_hosts=1)
    four = cost(16, 8, 1024, 1e6, n_hosts=4, cross_host_penalty=4.0)
    assert four > one
    assert cost(8, 4, 1024, 0.0) == 0.0
    for args, kw in (((16, 32, 1024, 1e6), {"arity": 4}),
                     ((2, 1, 1024, 1e6), {}),
                     ((16, 8, 1024, 1e6), {"n_hosts": 4,
                                           "cross_host_penalty": 4.0})):
        assert cost(*args, **kw) == rsched.collective_comm_cost(*args, **kw)


# ---------------------------------------------------- simulator modeling

def test_sim_models_collective_lowering():
    def sims(pkg, sim):
        _, coll, _ = PKGS[pkg]
        g, tids = producers_graph(16, pkg=pkg)
        ar = coll.add_all_reduce(g, tids, "sum", arity=4, out_bytes=64 * 4)
        g.mark_output(ar)
        return (sim.simulate(g, 4, collectives="off", seed=3),
                sim.simulate(g, 4, collectives="auto", seed=3))

    off, auto = sims("port", psim)
    assert off.makespan > 0 and auto.makespan > 0
    # lowering adds schedulable stages: the sim must see more tasks
    assert len(auto.task_worker) > len(off.task_worker)
    roff, rauto = sims("ref", rsim)
    assert (off.makespan, auto.makespan, auto.task_worker) == \
        (roff.makespan, rauto.makespan, rauto.task_worker)


def test_sim_search_collective_arity():
    def search(pkg, sim):
        core, coll, Ref = PKGS[pkg]
        g, tids = producers_graph(16, pkg=pkg)
        ar = coll.add_all_reduce(g, tids, "sum", arity=4, out_bytes=64 * 4)
        bc = coll.add_broadcast(g, ar, arity=4, out_bytes=64 * 4)
        for j in range(8):
            g.add_node(f"c{j}", _sum_times, (Ref(bc),), {"_j": j},
                       core.TaskKind.PURE, deps=(bc,))
        g.mark_output(ar)
        return g, sim.search_collective_arity(g, 4, [2, 4, 8], seed=5)

    g, (best, results) = search("port", psim)
    assert set(results) == {2, 4, 8}
    assert best in results
    # deterministic: same search, same verdict, the reference's too
    _, (best2, _) = search("port", psim)
    _, (rbest, rresults) = search("ref", rsim)
    assert best == best2 == rbest
    assert {a: r.makespan for a, r in results.items()} == \
        {a: r.makespan for a, r in rresults.items()}
    with pytest.raises(ValueError):
        psim.search_collective_arity(g, 4, [], seed=5)


# ------------------------------------------------- lineage: subtree replan

def _deep_reduce_graph(n=8, arity=2, pkg="port"):
    _, coll, _ = PKGS[pkg]
    g, tids = producers_graph(n, pkg=pkg)
    ar = coll.add_all_reduce(g, tids, "sum", arity=arity, out_bytes=64 * 4)
    g.mark_output(ar)
    return g, ar


def _subtree_plans(pkg, fusion, lineage):
    _, coll, _ = PKGS[pkg]
    g, ar = _deep_reduce_graph(8, 2, pkg)
    low, o2n = coll.lower_collectives(g, "auto")
    plan = fusion.fuse(low, "auto")
    stages = coll.collective_stages(low, ar)
    by_level = {}
    for t in stages:
        by_level.setdefault(
            low.nodes[t].meta["collective_stage"]["level"], []).append(t)
    root_new = o2n[ar]
    all_vals = set(low.nodes)
    mid = sorted(by_level[0])[0]
    one = lineage.recovery_plan_clusters(plan, {mid}, all_vals - {mid})
    path = {mid, sorted(by_level[1])[0], root_new}
    chain = lineage.recovery_plan_clusters(plan, {root_new},
                                           all_vals - path)
    return (plan, stages, by_level, root_new, mid, path, sorted(one),
            sorted(chain))


def test_mid_tree_loss_replans_only_the_subtree():
    (plan, stages, by_level, root_new, mid, path, one,
     chain) = _subtree_plans("port", pfusion, plineage)
    assert (one, chain) == _subtree_plans("ref", rfusion, rlineage)[6:]

    # one dead level-0 aggregator, leaves alive: replay exactly that stage
    members = {v for cid in one for v in plan.members[cid]}
    assert members == {mid}

    # a dead chain up one side of the tree: replay that path only — the
    # sibling subtrees' partials are alive and must NOT be recomputed
    members = {v for cid in chain for v in plan.members[cid]}
    assert members == path
    assert sorted(by_level[0])[1] not in members
    assert sorted(by_level[1])[1] not in members
    # the whole blast radius is bounded by the root's own stage set
    assert members <= set(stages) | {root_new}


# ------------------------------------------- cluster: differential + kill

def wide_collective_graph(n=9, m=6, elems=4096, arity=2):
    g, tids = producers_graph(n, elems)
    ar = add_all_reduce(g, tids, "sum", arity=arity, out_bytes=elems * 4)
    bc = add_broadcast(g, ar, arity=arity, out_bytes=elems * 4)
    cons = [g.add_node(f"c{j}", _consumer, (_Ref(bc),), {"_j": j},
                       TaskKind.PURE, deps=(bc,)) for j in range(m)]

    def red(*xs):
        return float(sum(xs))
    out = g.add_node("out", red, tuple(_Ref(d) for d in cons), {},
                     TaskKind.PURE, deps=tuple(cons))
    g.mark_output(out)
    return g


@pytest.mark.parametrize("spec", ["off", "auto", 3])
def test_cluster_differential_vs_oracle(spec):
    g = wide_collective_graph()
    seq = execute_sequential(g)
    ex = ClusterExecutor(2, collectives=spec, progress_timeout=120.0)
    got = ex.run(g)
    ex.close()
    same(got, seq)
    assert ex.stats["collective_roots"] == 2
    if spec == "off":
        assert ex.stats["collective_stages"] == 0
    else:
        assert ex.stats["collective_stages"] > 0


def test_cluster_tcp_channel_differential():
    g = wide_collective_graph()
    seq = execute_sequential(g)
    ex = ClusterExecutor(2, channel="tcp", collectives="auto",
                         progress_timeout=120.0)
    got = ex.run(g)
    ex.close()
    same(got, seq)


def test_cluster_sigkill_mid_tree_recovers_bounded():
    g = wide_collective_graph(n=9, m=6, elems=4096, arity=2)
    seq = execute_sequential(g)
    ex = ClusterExecutor(3, collectives="auto", fuse="auto",
                         fail_worker=(1, 3), progress_timeout=120.0)
    got = ex.run(g)
    ex.close()
    same(got, seq)
    assert ex.stats["failures"] == 1
    assert ex.stats["recomputed"] >= 1
    # bounded: a one-worker loss must never cascade into a full replay
    low, _ = lower_collectives(g, "auto")
    assert ex.stats["recomputed"] < len(low.nodes)


def test_cluster_faultplan_on_collective_hops_no_double_reduce():
    """Drop/delay/dup on the data and control planes while a lowered
    reduction is in flight: RetryPolicy-driven retries must not apply a
    combine twice — bit-equality against the oracle is the proof."""
    from repro_torch.faults import FaultPlan, RetryPolicy
    g = wide_collective_graph(n=9, m=6, elems=4096, arity=2)
    seq = execute_sequential(g)
    plan = (FaultPlan(seed=23)
            .fail_fetch(nth=1)
            .delay(0.01, prob=0.3)
            .duplicate(prob=0.3))
    ex = ClusterExecutor(2, collectives="auto", fault_plan=plan,
                         transport="sock", shm_threshold=64,
                         fetch_retry=RetryPolicy(attempts=3,
                                                 base_delay=0.01,
                                                 jitter=0.0),
                         progress_timeout=120.0)
    got = ex.run(g)
    ex.close()
    same(got, seq)
    assert ex.stats["failures"] == 0      # owner stayed alive
    assert ex.stats["recomputed"] == 0    # retried, not replayed


def test_cluster_resume_meta_records_collectives(tmp_path):
    g = wide_collective_graph(n=5, m=3, elems=512, arity=2)
    seq = execute_sequential(g)
    ex = ClusterExecutor(2, collectives=3,
                         checkpoint_dir=str(tmp_path / "ck"),
                         progress_timeout=120.0)
    got = ex.run(g)
    ex.close()
    same(got, seq)
    assert ex.collectives == 3


def _fig2_all_reduce(n_tasks, size):
    """Fig. 2 with its products summed by a traced binary all_reduce (the
    tree's bracketing is the value), then read as one float."""
    gen = task(_gen, cost=1.0, name="gen", out_bytes=size * size * 4)
    mul = task(_mul, cost=2.0, name="mul", out_bytes=size * size * 4)
    red = task(_red, cost=0.0, name="reduce")

    def driver():
        prods = [mul(gen(2 * i, size, "float32", "cpu"),
                     gen(2 * i + 1, size, "float32", "cpu"))
                 for i in range(n_tasks)]
        return red(all_reduce(prods, "sum", arity=2))

    g, _ = trace(driver)
    return g


def test_fig2_products_summed_by_all_reduce_across_a_sigkill():
    """The port's case: Fig. 2's 16 tensor products summed by a traced
    ``all_reduce`` on 4 forked workers, lowered to a tree, with worker 1
    SIGKILLed mid-tree: the graph's own sequential value bit for bit, and
    fewer recomputed super-tasks than the lowered graph has nodes."""
    g = _fig2_all_reduce(16, 32)
    seq = execute_sequential(g)
    ex = ClusterExecutor(4, collectives="auto", fail_worker=(1, 10),
                         progress_timeout=60.0)
    got = ex.run(g)
    ex.close()
    same(got, seq)
    low, _ = lower_collectives(g, "auto")
    assert ex.stats["collective_stages"] > 0
    assert ex.stats["failures"] == 1
    assert 1 <= ex.stats["recomputed"] < len(low.nodes)
    assert ex.stats["tasks_run"]["mul"] >= 16


# ----------------------------------------------------- launcher plumbing

def _args(**over):
    from repro_torch.launch.backend import add_backend_args
    ap = argparse.ArgumentParser()
    add_backend_args(ap)
    args = ap.parse_args([])
    for k, v in over.items():
        setattr(args, k, v)
    return args


def test_launcher_collectives_flag_validation():
    from repro_torch.launch.backend import validate_backend_args
    validate_backend_args(_args())                              # defaults
    validate_backend_args(_args(collectives="off"))
    validate_backend_args(_args(backend="process", collectives="4"))
    with pytest.raises(SystemExit):
        validate_backend_args(_args(collectives="sideways"))
    with pytest.raises(SystemExit):
        validate_backend_args(_args(collectives="1"))
    with pytest.raises(SystemExit):     # arity override needs a cluster
        validate_backend_args(_args(collectives="4"))


def test_make_executor_rejects_collectives_on_thread_backend():
    from repro_torch.core import make_executor
    with pytest.raises(ValueError, match="collectives"):
        make_executor("thread", 2, collectives="auto")
