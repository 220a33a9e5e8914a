"""The port's runtime core against the JAX package's: the same drivers traced
by both give the same graphs, schedules and effect order.

Drivers: the paper's §2 example (as in ``tests/test_system.py``) and a small
Fig. 2 DAG (``benchmarks/matmul_scaling.py``'s driver against
``repro_torch.workloads.matrix_driver``, 4 units of 96x96).  Graph
structure and schedules are compared exactly; they involve no arithmetic on
data.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro_torch.core as pcore  # noqa: E402
from repro_torch.config import ClusterConfig  # noqa: E402
from benchmarks.matmul_scaling import matrix_driver as jax_matrix_driver  # noqa: E402
from repro_torch.workloads import (COST_GEN, COST_MUL,  # noqa: E402
                                   matrix_driver as pt_matrix_driver)


def make_paper_main(core, arange, log):
    """The §2 example (clean_files / complex_evaluation /
    semantic_analysis), built on ``core``'s decorators."""

    @core.io_task(cost=2.0)
    def clean_files():
        log.append("clean_files")
        return arange(8.0)              # "Summary"

    @core.task(cost=5.0)
    def complex_evaluation(x):
        return int(x.sum())

    @core.io_task(cost=2.0)
    def semantic_analysis():
        log.append("semantic_analysis")
        return 42

    def paper_main():
        x = clean_files()
        y = complex_evaluation(x)
        z = semantic_analysis()
        return y, z

    return paper_main


def structure(graph):
    return [(n.tid, n.name, n.kind.value, n.deps, n.token_deps, n.cost,
             n.out_bytes) for n in graph]


def placements(graph, n_workers):
    core = pcore if type(graph).__module__.startswith("repro_torch") \
        else jcore
    sched = core.list_schedule(graph, n_workers)
    sched.validate_against(graph)
    return sorted((p.tid, p.worker, p.start, p.end)
                  for p in sched.placements.values())


def traced_pair(jax_driver, pt_driver, *args, **kw):
    jg, _ = jcore.trace(jax_driver, *args)
    pg, _ = pcore.trace(pt_driver, *args, **kw)
    return jg, pg


def test_paper_example_traces_identically():
    jg, pg = traced_pair(make_paper_main(jcore, jnp.arange, []),
                         make_paper_main(pcore, torch.arange, []))
    assert structure(pg) == structure(jg)
    assert pg.outputs == jg.outputs
    nodes = {n.name: n for n in pg}
    assert nodes["clean_files"].tid in nodes["semantic_analysis"].token_deps
    assert placements(pg, 2) == placements(jg, 2)


def test_paper_example_effects_in_program_order_under_threads():
    logs, values = {}, {}
    for name, core, arange in (("jax", jcore, jnp.arange),
                               ("torch", pcore, torch.arange)):
        log = []
        g, _ = core.trace(make_paper_main(core, arange, log))
        seq = core.execute_sequential(g)
        seq_log = list(log)
        log.clear()
        par = core.ThreadedExecutor(4).run(g)
        assert log == seq_log
        logs[name] = seq_log
        values[name] = [(seq[t], par[t]) for t in g.outputs]
    assert logs["jax"] == logs["torch"] == ["clean_files",
                                            "semantic_analysis"]
    assert values["jax"] == values["torch"] == [(28, 28), (42, 42)]


@pytest.mark.parametrize("n_workers", [2, 3])
def test_fig2_dag_traces_and_schedules_identically(n_workers):
    jg, _ = jcore.trace(jax_matrix_driver, 4, 96, COST_GEN, COST_MUL)
    pg, _ = pcore.trace(pt_matrix_driver, 4, 96, device="cpu")
    assert len(pg) == 4 * 3 + 1
    assert structure(pg) == structure(jg)
    assert placements(pg, n_workers) == placements(jg, n_workers)
    assert pg.critical_path_length() == jg.critical_path_length()


def test_fig2_chain_variant_traces_identically():
    jg, _ = jcore.trace(jax_matrix_driver, 3, 8, COST_GEN, COST_MUL, 3)
    pg, _ = pcore.trace(pt_matrix_driver, 3, 8, device="cpu", chain=3)
    assert structure(pg) == structure(jg)


def test_infer_purity_pure_inplace_and_declared():
    x = torch.randn(4)
    assert pcore.infer_purity(lambda t: torch.sin(t) * 2, x)
    assert not pcore.infer_purity(lambda t: t.add_(1), x)

    def writes_second(a, b):
        b.copy_(a)
        return a

    assert not pcore.infer_purity(writes_second, x, torch.zeros(4))
    # tracing that cannot proceed (data-dependent Python) is impure
    assert not pcore.infer_purity(lambda t: 1 if t.sum() > 0 else 0, x)
    # a declaration wins over inspection
    def declared(t):
        return t * 2
    pcore.declare(declared, False)
    assert not pcore.infer_purity(declared, x)

    @pcore.task
    def traced(t):
        return t.add_(1)
    assert pcore.declared_purity(traced.__wrapped_task__) is True


def test_effect_token_is_a_float32_scalar_tensor():
    tok = pcore.initial_token().next().next()
    t = tok.as_array()
    assert t.dtype == torch.float32 and t.dim() == 0 and float(t) == 2.0
    j = jcore.initial_token().next().next().as_array()
    assert float(np.asarray(j)) == float(t)


@pytest.mark.parametrize("op", ["sum", "max", "min", "concat"])
def test_all_reduce_on_tensors_matches_reference_on_arrays(op):
    rng = np.random.default_rng(4)
    parts = [rng.standard_normal(6, dtype=np.float32) for _ in range(7)]

    def driver(core, make):
        @core.task
        def src(i):
            return make(parts[i])

        def main():
            return core.all_reduce([src(i) for i in range(7)], op, arity=3)
        return main

    results = {}
    for name, core, make in (("jax", jcore, np.asarray),
                             ("torch", pcore, torch.from_numpy)):
        g, out = core.trace(driver(core, make))
        lowered, _ = core.lower_collectives(g)
        seq = core.execute_sequential(g)[out.tid]
        low = core.execute_sequential(lowered)[lowered.outputs[0]]
        assert np.asarray(seq).tobytes() == np.asarray(low).tobytes()
        results[name] = np.asarray(seq)
    assert results["jax"].tobytes() == results["torch"].tobytes()


# a tensor combined with a number or a numpy array, as when one task of an
# all_reduce returns a tensor and another a float
@pytest.mark.parametrize("op,other,want", [
    ("max", 2.0, [2.0, 5.0]),
    ("min", 2.0, [1.0, 2.0]),
    ("concat", np.array([2.0]), [1.0, 5.0, 2.0])])
def test_combine_ops_take_a_tensor_with_a_number_or_array(op, other, want):
    from repro.core.collectives import REDUCE_OPS as JAX_OPS
    from repro_torch.core.collectives import REDUCE_OPS as PT_OPS
    ref = np.asarray(JAX_OPS[op](jnp.array([1.0, 5.0]), other))
    got = PT_OPS[op](torch.tensor([1.0, 5.0]), other)
    assert isinstance(got, torch.Tensor)
    got = got.numpy()
    assert ref.tolist() == want and got.tolist() == want
    assert got.dtype == ref.dtype


def test_unported_backends_raise_not_implemented():
    """Every backend is ported now: the process backend, and the gateway
    (``connect=`` on the thread backend, ROADMAP §1 item 4), each give the
    sequential oracle's values bit for bit; a cluster-only option on the
    thread backend is still a named error."""
    from repro_torch.gateway import GatewayService

    def check(got, seq):
        assert got.keys() == seq.keys()
        for tid, want in seq.items():
            assert (torch.equal(got[tid], want)
                    if isinstance(want, torch.Tensor) else got[tid] == want)

    g, _ = pcore.trace(make_paper_main(pcore, torch.arange, []))
    check(pcore.run_graph(g, 2, backend="process",
                          config=ClusterConfig(progress_timeout=15.0)),
          pcore.execute_sequential(g))
    # the gateway's pool unpickles the graph: module-level task bodies
    fig2, _ = pcore.trace(pt_matrix_driver, 2, 8, device="cpu")
    with GatewayService(ClusterConfig(n_workers=2, token="t",
                                      progress_timeout=15.0)) as gw:
        got, report = pcore.run_graph(fig2, 2, connect=gw.address,
                                      token="t", with_report=True)
    check(got, pcore.execute_sequential(fig2))
    assert report["backend"] == "gateway"
    assert report["stats"]["tasks_run"] == {"gen": 4, "mul": 2, "reduce": 1}
    with pytest.raises(ValueError, match="process backend"):
        pcore.make_executor("thread", 2, transport="shm")
