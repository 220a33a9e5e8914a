"""The port's first slice as a whole, on the CPU: the paper's Fig. 2 DAG run
by the port against the same DAG run by the JAX package with the Pallas
matmul kernel (interpret mode) as its ``mul``.

Both sides draw their matrices with numpy's ``default_rng(seed)``.  Each
``mul`` value must agree at the float32 matmul tolerance of
``tests/test_kernels.py`` (2e-5) applied to ``out / sqrt(K)`` — the inputs
are standard normal, so products grow like ``sqrt(K)``.  Inside the port the
threaded run must equal the sequential one bit for bit, as the executor
promises.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro_torch.interop import tensor_to_numpy  # noqa: E402
from repro_torch.kernels import matmul as pt_matmul  # noqa: E402
from repro_torch.workloads import run_matrix_dag  # noqa: E402

TOL = 2e-5
UNITS, SIZE = 4, 96


def jax_matrix_driver(n_tasks, size):
    """The reference DAG with the Pallas kernel as ``mul`` (test code: the
    JAX package's own driver multiplies with numpy)."""
    @jcore.task(cost=1.0, name="gen")
    def gen(seed):
        rng = np.random.default_rng(seed)
        return jnp.asarray(rng.standard_normal((size, size), dtype=np.float32))

    @jcore.task(cost=2.0, name="mul")
    def mul(a, b):
        return jax_ops.matmul(a, b, interpret=True)

    @jcore.task(cost=0.0, name="reduce")
    def red(*xs):
        return sum(float(np.asarray(x, np.float64).sum()) for x in xs)

    return red(*[mul(gen(2 * i), gen(2 * i + 1)) for i in range(n_tasks)])


def bits(t):
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def assert_bit_equal(graph, a, b):
    assert set(a) == set(b) == set(graph.nodes)
    for tid in graph.nodes:
        x, y = a[tid], b[tid]
        if isinstance(x, torch.Tensor):
            assert torch.equal(bits(x), bits(y)), graph.nodes[tid].name
        else:
            assert x == y, graph.nodes[tid].name


def test_slice_matches_jax_package_with_pallas_mul():
    jg, _ = jcore.trace(jax_matrix_driver, UNITS, SIZE)
    jres = jcore.execute_sequential(jg)
    pg, pres, report = run_matrix_dag(UNITS, SIZE, 1, device="cpu")
    assert report["backend"] == "sequential"
    assert [(n.tid, n.name, n.deps) for n in pg] == \
        [(n.tid, n.name, n.deps) for n in jg]
    s = np.sqrt(SIZE)
    products, slack = [], 0.0
    for node in pg:
        got = pres[node.tid]
        want = jres[node.tid]
        if node.name == "gen":
            assert tensor_to_numpy(got).tobytes() == \
                np.asarray(want).tobytes()
        elif node.name == "mul":
            got, want = tensor_to_numpy(got), np.asarray(want)
            np.testing.assert_allclose(got / s, want / s, rtol=TOL,
                                       atol=TOL)
            products.append(got)
            # the most the allclose above lets this product's sum move
            slack += float(np.sum(TOL * s + TOL * np.abs(want)))
    assert len(products) == UNITS
    out = pg.outputs[0]
    # reduce: float64 sums of the products, added in argument order
    assert pres[out] == pytest.approx(
        sum(float(p.astype(np.float64).sum()) for p in products), rel=1e-12)
    assert abs(pres[out] - jres[out]) <= slack


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_threaded_equals_sequential_bit_for_bit(dtype):
    g, seq, _ = run_matrix_dag(UNITS, SIZE, 1, device="cpu", dtype=dtype)
    g2, par, report = run_matrix_dag(UNITS, SIZE, 4, device="cpu",
                                     dtype=dtype)
    assert report["backend"] == "thread" and report["n_workers"] == 4
    assert len(g) == len(g2) == 3 * UNITS + 1
    assert_bit_equal(g, seq, par)
    assert all(seq[t].dtype == dtype for t in seq
               if isinstance(seq[t], torch.Tensor))


def test_cpu_run_launches_no_kernel():
    before = pt_matmul.matmul.launches
    run_matrix_dag(2, 16, 2, device="cpu")
    assert pt_matmul.matmul.launches == before


def test_no_device_and_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_matrix_dag(2, 16, 1)
