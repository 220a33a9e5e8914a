"""The port's optimizers and schedules against the JAX package.

Convergence, state shapes and clipping as ``tests/test_optim.py`` checks
them, and AdamW, Adafactor and SGD given the same gradients as the
reference's (made with numpy from a seed and carried across), step after
step: the port updates in place what the reference returns, and the
parameters and state agree to 1e-6 (float32 throughout; the two differ
only in the rounding of fused multiply-adds).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as J  # noqa: E402
from repro.optim import schedules as JS  # noqa: E402
from repro_torch import optim as P  # noqa: E402
from repro_torch.optim import schedules as PS  # noqa: E402
from repro_torch.tree import tree_flatten_with_paths  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)
SHAPES = {"w": (160, 130), "b": (130,), "layers": {"k": (2, 3, 4)}}


def _tree(shapes, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in shapes.items()}


def _assert_trees_close(got, want, **tol):
    want = dict(tree_flatten_with_paths(jax.device_get(want)))
    got = tree_flatten_with_paths(got)
    assert sorted(p for p, _ in got) == sorted(want)
    for path, g in got:
        np.testing.assert_allclose(g.numpy(), np.asarray(want[path]),
                                   err_msg=path, **tol)


def quad_loss(params):
    return sum(((p - 3.0) ** 2).sum() for p in params.values())


@pytest.mark.parametrize("opt", [P.AdamW(lr=0.1), P.Adafactor(lr=0.5),
                                 P.SGD(lr=0.05, momentum=0.9)])
def test_optimizer_converges_on_quadratic(opt):
    params = {"w": torch.zeros(4, 4), "b": torch.zeros(4)}
    state = opt.init(params)
    for _ in range(200):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        grads = torch.autograd.grad(quad_loss(leaves), list(leaves.values()))
        state = opt.update(dict(zip(leaves, grads)), state, params)
    assert float(quad_loss(params)) < 0.05
    assert int(state["step"]) == 200


def test_adamw_state_mirrors_params_f32():
    st = P.AdamW().init({"w": torch.zeros(8, 8, dtype=torch.bfloat16)})
    assert st["m"]["w"].dtype == torch.float32
    assert tuple(st["m"]["w"].shape) == (8, 8)
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 0


def test_adafactor_factored_state_is_small():
    opt = P.Adafactor(min_dim_factored=128)
    params = {"big": torch.zeros(512, 256), "small": torch.zeros(4, 4),
              "vec": torch.zeros(1024)}
    st = opt.init(params)
    assert set(st["v"]["big"]) == {"vr", "vc"}
    assert tuple(st["v"]["big"]["vr"].shape) == (512,)
    assert tuple(st["v"]["big"]["vc"].shape) == (256,)
    assert set(st["v"]["small"]) == {"v"} and set(st["v"]["vec"]) == {"v"}


def test_grad_clipping_bounds_update():
    opt = P.AdamW(lr=1.0, clip_norm=1.0, weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    opt.update({"w": torch.full((4,), 1e6)}, opt.init(params), params)
    assert float(params["w"].abs().max()) < 10.0


def test_update_works_in_place():
    """The state and the parameters keep their storage: no new copy of
    m, v or the parameters per step."""
    opt = P.AdamW(lr=1e-2, weight_decay=0.1)
    params = {"w": torch.ones(3, 5), "b": torch.ones(5)}
    st = opt.init(params)
    ptrs = [t.data_ptr() for t in (params["w"], params["b"], st["m"]["w"],
                                   st["v"]["w"], st["step"])]
    grads = {"w": torch.full((3, 5), 0.5), "b": torch.full((5,), -0.5)}
    st2 = opt.update(grads, st, params)
    assert st2 is st
    assert ptrs == [t.data_ptr() for t in (params["w"], params["b"],
                                           st["m"]["w"], st["v"]["w"],
                                           st["step"])]
    assert not torch.equal(params["w"], torch.ones(3, 5))


@pytest.mark.parametrize("name", ["adamw_cosine", "adamw_noclip", "adafactor",
                                  "sgd_momentum", "sgd"])
def test_optimizer_matches_reference_step_by_step(name):
    sched = (JS.cosine_schedule(1e-2, 2, 6), PS.cosine_schedule(1e-2, 2, 6))
    jopt, popt = {
        "adamw_cosine": (J.AdamW(lr=sched[0], weight_decay=0.1),
                         P.AdamW(lr=sched[1], weight_decay=0.1)),
        "adamw_noclip": (J.AdamW(lr=1e-3, clip_norm=None),
                         P.AdamW(lr=1e-3, clip_norm=None)),
        "adafactor": (J.Adafactor(lr=sched[0]), P.Adafactor(lr=sched[1])),
        "sgd_momentum": (J.SGD(lr=0.1, momentum=0.9),
                         P.SGD(lr=0.1, momentum=0.9)),
        "sgd": (J.SGD(lr=0.1), P.SGD(lr=0.1)),
    }[name]
    rng = np.random.default_rng(7)
    init = _tree(SHAPES, lambda s: rng.standard_normal(s, dtype=np.float32))
    jparams = jax.tree.map(jnp.asarray, init)
    params = jax.tree.map(lambda a: torch.from_numpy(a.copy()), init)
    jstate, state = jopt.init(jparams), popt.init(params)
    for _ in range(4):
        g = _tree(SHAPES, lambda s: 3 * rng.standard_normal(
            s, dtype=np.float32))
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate,
                                      jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        state = popt.update(jax.tree.map(torch.from_numpy, g), state, params)
        _assert_trees_close(params, jparams, **TOL)
        _assert_trees_close(state, jstate, **TOL)


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd_momentum"])
def test_optimizer_matches_reference_with_bf16_params(name):
    """bf16 parameters (``llama4_maverick_400b``'s ``param_dtype``): the
    reference's train step adds each float32 update to its parameter in
    float32 and rounds once, ``(p + u).astype(p.dtype)``
    (``launch/steps.py``); the port's in-place update must round once too,
    so the bf16 parameters agree bit for bit and the float32 state to
    1e-6."""
    jopt, popt = {
        "adamw": (J.AdamW(lr=1e-2, weight_decay=0.1),
                  P.AdamW(lr=1e-2, weight_decay=0.1)),
        "adafactor": (J.Adafactor(lr=1e-2), P.Adafactor(lr=1e-2)),
        "sgd_momentum": (J.SGD(lr=0.1, momentum=0.9),
                         P.SGD(lr=0.1, momentum=0.9)),
    }[name]
    rng = np.random.default_rng(11)
    init = _tree(SHAPES, lambda s: rng.standard_normal(s, dtype=np.float32))
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), init)
    params = jax.tree.map(
        lambda a: torch.from_numpy(a.copy()).to(torch.bfloat16), init)
    jstate, state = jopt.init(jparams), popt.init(params)
    for _ in range(4):
        g = _tree(SHAPES, lambda s: 3 * rng.standard_normal(
            s, dtype=np.float32))
        jg = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), g)
        pg = jax.tree.map(
            lambda a: torch.from_numpy(a).to(torch.bfloat16), g)
        updates, jstate = jopt.update(jg, jstate, jparams)
        jparams = jax.tree.map(lambda p, u: (p + u).astype(p.dtype),
                               jparams, updates)
        state = popt.update(pg, state, params)
        _assert_trees_close(
            jax.tree.map(lambda t: t.float(), params),
            jax.tree.map(lambda a: a.astype(jnp.float32), jparams),
            rtol=0, atol=0)
        _assert_trees_close(state, jstate, **TOL)


@pytest.mark.parametrize("floor", [0.1, 0.0])
def test_schedules_match_reference(floor):
    steps = np.arange(0, 1100, 7, dtype=np.int32)
    want = JS.cosine_schedule(1e-3, 100, 1000, floor)(jnp.asarray(steps))
    got = PS.cosine_schedule(1e-3, 100, 1000, floor)(torch.from_numpy(steps))
    # float32 cos differs between the libraries by an ulp: 1e-6 of the peak
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-9)
    assert got.dtype == torch.float32
    want = JS.linear_warmup(1e-3, 10)(jnp.asarray(steps))
    got = PS.linear_warmup(1e-3, 10)(steps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert float(PS.cosine_schedule(1e-3, 100, 1000)(1000)) == \
        pytest.approx(1e-4, rel=1e-5)


def test_global_norm_and_clip_match_reference():
    rng = np.random.default_rng(3)
    tree = _tree(SHAPES, lambda s: rng.standard_normal(s, dtype=np.float32))
    jt = jax.tree.map(jnp.asarray, tree)
    pt = jax.tree.map(lambda a: torch.from_numpy(a.copy()), tree)
    np.testing.assert_allclose(float(P.global_norm(pt)),
                               float(J.global_norm(jt)), rtol=1e-6)
    jclipped, jnorm = J.clip_by_global_norm(jt, 1.0)
    clipped, norm = P.clip_by_global_norm(pt, 1.0)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    _assert_trees_close(clipped, jclipped, **TOL)
