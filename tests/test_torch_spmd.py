"""The port's intra-op SPMD layer on a world of 8 gloo ranks, against the JAX
package's ``tests/test_spmd.py``.

One world runs every multi-rank check once (a module-scoped fixture): 8
spawned processes, each a rank (``parallel.mesh.spawn_world``), meeting
through a file store under ``tmp_path``, one thread each, and killed
together if they have not ended within 240 s.  Each rank writes a report;
the tests below assert on it, one check a test, on every rank.  The ranks
import only the port; the JAX references they are held to (the pipeline's
layer scan) are computed here and handed over as numpy files.

- ``MeshExecutor`` on the (4, 2) mesh against ``execute_sequential`` at
  rtol and atol 1e-5 (``tests/test_spmd.py:37-77``), its ``mul`` bodies
  the port's matmul on each rank's rows; its op log (``hlo_text``) gives
  the counted collectives, its memory record a peak; a task of
  ``torch.matmul`` on DTensors counts the rank's local FLOPs;
- the pipeline (``pods=4, model_parallel=2``) on yi-9b reduced to 4 layers
  in float32, B 8, S 16, 4 microbatches, with the JAX package's parameters,
  against the JAX ``_layer_body`` scan at 2e-4 (:80-110); and on dbrx-132b
  reduced to 4 MoE layers, whose aux is not zero, against the scan run on
  each microbatch (routing is per microbatch), the aux averaged over them:
  every stage's aux counts, not only the last stage's as in the reference;
- the collective helpers against dense references, exactly (:141-199);
- ``dp_gradient_sync`` plain and int8-compressed (:113-138);
- ``_fit_sharding`` (:202-215), ``make_mesh_for``'s ``ValueError`` on a
  world too small, ``ShardingCtx.constrain`` and the flash entry on
  DTensors.
"""
import json
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro_torch.parallel.mesh import spawn_world  # noqa: E402
from repro_torch.tree import tree_flatten_with_paths  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD, WORLD_TIMEOUT_S = 8, 240.0
PIPE_B, PIPE_S, PIPE_LAYERS = 8, 16, 4

_RANK_SCRIPT = r'''
import json, sys, traceback
from pathlib import Path
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.parallel.mesh import init_world, destroy_world

WORK = Path(sys.argv[1])
init_world(device="cpu")
import torch.distributed as dist
RANK = dist.get_rank()
report = {}


def check(fn):
    try:
        report[fn.__name__] = fn()
    except Exception:
        report[fn.__name__] = {"ok": False, "error": traceback.format_exc()}
    dist.barrier()     # a rank that failed a check still meets the others
    return fn


@check
def mesh_executor():
    from repro_torch.core import (task, trace, placeholder, MeshExecutor,
                                  execute_sequential, standard_rules,
                                  ValueInfo)
    from repro_torch.kernels import ops
    from repro_torch.parallel.mesh import make_mesh_for

    @task(cost=1.0)
    def gen(seed):
        g = torch.Generator().manual_seed(seed)
        return torch.randn((64, 64), generator=g)

    @task(cost=2.0)
    def mul(a, b):
        return ops.matmul(a, b)

    @task(cost=1.0)
    def add(a, b):
        return a + b

    def driver():
        x = placeholder("x")
        a = gen(0); b = gen(1)
        return add(mul(a, x), mul(b, x))

    graph, _ = trace(driver)
    x = torch.randn((64, 64), generator=torch.Generator().manual_seed(9))
    want = execute_sequential(graph, inputs={"x": x})[graph.outputs[0]]
    mesh = make_mesh_for(8, model_parallel=2)
    info = {t: ValueInfo((64, 64), 4, ("batch", "d_model"))
            for t in graph.nodes}
    ex = MeshExecutor(graph, mesh, standard_rules("dp_tp", pod_axis=None),
                      value_info=info, input_axes={"x": ("batch", "d_model")})
    ex.compile({"x": x})
    out = ex({"x": x})[0]
    again = ex({"x": x})[0]
    cost = ex.cost_analysis()
    from repro_torch.launch.dryrun import parse_collectives
    log = ex.hlo_text()
    # the op log's collectives are the counted ones, with their groups
    logged = parse_collectives(log) == parse_collectives(
        cost["collective_events"]) and sum(
            line.startswith("collective ") for line in
            log.splitlines()) == cost["collectives"]
    peak = ex.memory_analysis().peak_memory_in_bytes
    close = torch.allclose(out, want, rtol=1e-5, atol=1e-5)
    return {"ok": bool(close and torch.equal(out, again) and logged
                       and peak > 0 and cost["flops"] > 0 and mesh.shape ==
                       {"data": 4, "model": 2}),
            "max_err": float((out - want).abs().max()),
            "flops": cost["flops"], "collectives": cost["collectives"],
            "peak": peak, "logged": logged,
            "specs": {str(t): list(s) for t, s in ex.specs.items()}}


@check
def mesh_executor_torch_matmul():
    """A task that multiplies DTensors with torch.matmul: the count is the
    rank's local product (x's 16 rows of 64 on the (4, 2) mesh by the
    replicated 64 x 64 w), not the global one FlopCounterMode sees."""
    from repro_torch.core import (task, trace, placeholder, MeshExecutor,
                                  standard_rules)
    from repro_torch.parallel.mesh import make_mesh_for

    @task(cost=1.0)
    def tmm(a, b):
        return torch.matmul(a, b)

    def driver():
        return tmm(placeholder("x"), placeholder("w"))

    graph, _ = trace(driver)
    g = torch.Generator().manual_seed(3)
    x, w = torch.randn((64, 64), generator=g), torch.randn((64, 64),
                                                           generator=g)
    mesh = make_mesh_for(8, model_parallel=2)
    ex = MeshExecutor(graph, mesh, standard_rules("dp_tp", pod_axis=None),
                      input_axes={"x": ("batch", "d_model"), "w": ()})
    out = ex({"x": x, "w": w})[0]
    cost = ex.cost_analysis()
    local = 2 * (64 // 4) * 64 * 64
    return {"ok": bool(cost["flops"] == local
                       and torch.allclose(out, x @ w, rtol=1e-5, atol=1e-5)),
            "flops": cost["flops"], "local": local,
            "global": 2 * 64 * 64 * 64}


def _pipeline(arch, npz):
    from repro_torch.configs import get_config
    from repro_torch.interop import params_from_numpy
    from repro_torch.parallel.mesh import make_mesh_for
    from repro_torch.parallel.pipeline import (bubble_fraction,
                                               pipelined_forward,
                                               split_stages)
    ref = np.load(WORK / npz)
    tree = {}
    for key in ref.files:
        if key.startswith("layers/"):
            node = tree
            *path, leaf = key.split("/")[1:]
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = ref[key]
    cfg = get_config(arch).reduced(n_layers=4, compute_dtype="float32",
                                   param_dtype="float32", remat="none")
    lay = params_from_numpy(tree, "cpu")
    mesh = make_mesh_for(8, model_parallel=2, pods=4)
    fn = pipelined_forward(cfg, mesh, n_microbatch=4, stage_axis="pod")
    with torch.no_grad():
        y, aux = fn(split_stages(lay, 4, 4), torch.from_numpy(ref["x"]))
    ok = np.allclose(y.numpy(), ref["y"], rtol=2e-4, atol=2e-4)
    return {"ok": bool(ok and mesh.axis_index("pod") == RANK // 2
                       and bubble_fraction(4, 4) == 3 / 7),
            "max_err": float(np.abs(y.numpy() - ref["y"]).max()),
            "aux": float(aux), "ref_aux": float(ref["aux"])}


@check
def pipeline():
    got = _pipeline("yi-9b", "pipeline.npz")
    got["ok"] = got["ok"] and got["aux"] == got["ref_aux"]
    return got


@check
def pipeline_moe():
    got = _pipeline("dbrx-132b", "pipeline_moe.npz")
    got["ok"] = got["ok"] and got["ref_aux"] != 0 and bool(np.isclose(
        got["aux"], got["ref_aux"], rtol=2e-4, atol=0))
    return got


@check
def collectives():
    from repro_torch.parallel.collectives import (all_gather_seq,
                                                  dp_gradient_sync, pmax,
                                                  pmean_tree, psum_tree,
                                                  reduce_scatter,
                                                  ring_permute)
    from repro_torch.parallel.mesh import make_mesh_for
    mesh = make_mesh_for(8)                   # data 8, model 1
    i = mesh.axis_index("data")
    x = torch.arange(8 * 4, dtype=torch.float32).reshape(8, 4)
    mine = x[i:i + 1]
    got = {}
    for shift in (1, 3):
        got[f"ring_{shift}"] = torch.equal(
            ring_permute(mine, mesh, "data", shift),
            torch.roll(x, shift, 0)[i:i + 1])
    got["ring_0_mod_n"] = ring_permute(mine, mesh, "data", 8) is mine
    got["ring_size_1_axis"] = ring_permute(mine, mesh, "model", 1) is mine
    got["all_gather_dim1"] = torch.equal(
        all_gather_seq(mine, mesh, "data", dim=1), x.reshape(1, -1))
    got["all_gather_dim0"] = torch.equal(
        all_gather_seq(mine, mesh, "data", dim=0), x)
    w = torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16)
    got["reduce_scatter_dim1"] = torch.equal(
        reduce_scatter(w[i:i + 1], mesh, "data", dim=1),
        w.sum(0, keepdim=True)[:, 2 * i:2 * i + 2])
    got["reduce_scatter_dim0"] = torch.equal(
        reduce_scatter(w, mesh, "data"), 8.0 * w[i:i + 1])
    tree = {"a": mine, "b": {"c": torch.full((3,), float(i))}}
    s = psum_tree(tree, mesh, "data")
    got["psum_tree"] = (torch.equal(s["a"], x.sum(0, keepdim=True))
                        and torch.equal(s["b"]["c"], torch.full((3,), 28.)))
    got["pmean_tree"] = torch.equal(pmean_tree(tree, mesh, "data")["b"]["c"],
                                    torch.full((3,), 3.5))
    got["pmax"] = torch.equal(pmax(mine, mesh, "data"), x[7:8])
    g = {"w": x}
    got["sync_identity_without_axis"] = \
        dp_gradient_sync(g, mesh, ("tensor",)) is g
    return {"ok": all(got.values()), **got}


@check
def dp_gradient_sync():
    from repro_torch.parallel.collectives import dp_gradient_sync
    from repro_torch.parallel.compression import Int8BlockCompressor
    from repro_torch.parallel.mesh import make_mesh_for
    mesh = make_mesh_for(8)
    gen = torch.Generator().manual_seed(0)
    g = {"w": torch.randn((8, 64, 32), generator=gen) * 0.01}
    plain = dp_gradient_sync(g, mesh, ("data",))
    comp = Int8BlockCompressor(block=64)
    cz = dp_gradient_sync(g, mesh, ("data",), compressor=comp)
    err = float((cz["w"] - plain["w"]).abs().max())
    scale = float(plain["w"].abs().max())
    # each rank's own gradient: the mean over ranks, plain and compressed
    mine = [torch.randn((1000,), generator=torch.Generator().manual_seed(
        100 + r)) * (r + 1) for r in range(8)]
    got = dp_gradient_sync({"g": mine[RANK]}, mesh, ("data",))["g"]
    gz = dp_gradient_sync({"g": mine[RANK]}, mesh, ("data",),
                          compressor=comp)["g"]
    blocks = [comp._blocks(m) for m in mine]
    gscale = torch.stack([comp.quantize(m)[1] for m in mine]).amax(0)
    codes = sum(torch.round(b / gscale).clamp(-127, 127).to(torch.int32)
                for b in blocks)
    dense_z = comp.dequantize(codes.float(), gscale, (1000,)) / 8
    mean = torch.stack(mine).mean(0)
    got = {"replicated": torch.allclose(plain["w"], g["w"], rtol=1e-6,
                                        atol=0),
           "compressed_within_step": err <= scale / 127.0 + 1e-6,
           "mean": torch.allclose(got, mean, rtol=0, atol=1e-6),
           "compressed_is_dense_formula": torch.equal(gz, dense_z),
           "compressed_near_mean": float((gz - mean).abs().max())
           <= float(gscale.max()) / 2 + 1e-6}
    return {"ok": all(got.values()), **got,
            "replicated_err": err, "scale": scale}


@check
def fit_sharding():
    from repro_torch.launch.steps import (_fit_sharding, fit_case_shardings,
                                          make_rules)
    from repro_torch.parallel.mesh import make_mesh_for
    mesh = make_mesh_for(8, model_parallel=8)       # model axis = 8
    ok = _fit_sharding((1024, 16), ("model", None), mesh) == ("model",)
    bad = _fit_sharding((51865, 16), ("model", None), mesh) == ()
    tree = fit_case_shardings({"a": (1024, 16), "b": (51865, 16)},
                              {"a": ("model",), "b": ("model",)}, mesh)
    rules = make_rules(make_mesh_for(8), "dp_tp", global_batch=1)
    return {"ok": ok and bad and tree == {"a": ("model",), "b": ()}
            and rules[0] == ("batch", None)}


@check
def mesh_sizes():
    from repro_torch.parallel.mesh import make_mesh_for, make_production_mesh
    raised = []
    for build in (lambda: make_mesh_for(16),
                  lambda: make_production_mesh(multi_pod=True)):
        try:
            build()
        except ValueError as e:
            raised.append(str(e))
    prefix = make_mesh_for(4)
    inside = prefix.device_mesh.get_coordinate() is not None
    return {"ok": raised == ["need 16 devices for mesh (16, 1), have 8",
                             "need 512 devices for mesh (2, 16, 16), have 8"]
            and prefix.shape == {"data": 4, "model": 1}
            and inside == (RANK < 4), "errors": raised}


@check
def dtensor_kernels():
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.kernels import ops, ref
    from repro_torch.parallel import ShardingCtx
    from repro_torch.parallel.mesh import make_mesh_for
    mesh = make_mesh_for(8, model_parallel=2)
    ctx = ShardingCtx.make(mesh, "dp_tp")
    gen = torch.Generator().manual_seed(5)
    q = torch.randn((4, 8, 6, 16), generator=gen)
    k = torch.randn((4, 2, 6, 16), generator=gen)
    v = torch.randn((4, 2, 6, 16), generator=gen)
    dq = ctx.constrain(q, ("batch", "heads", None, None))
    dk = ctx.constrain(k, ("batch", "kv_heads", None, None))
    dv = ctx.constrain(v, ("batch", "kv_heads", None, None))
    out = ops.flash_attention(dq, dk, dv, causal=True)
    want = ref.attention(q, k, v, causal=True)
    a = torch.randn((10, 12), generator=gen)
    b = torch.randn((12, 6), generator=gen)
    prod = ops.matmul(ctx.constrain(a, ("batch", None)), b)
    return {"ok": isinstance(dq, DTensor)
            and tuple(dq.placements) == (Shard(0), Shard(1))
            and tuple(out.placements) == (Shard(0), Shard(1))
            and torch.allclose(out.full_tensor(), want, atol=1e-6)
            and tuple(prod.placements) == (Shard(0), Replicate())
            and torch.allclose(prod.full_tensor(), a @ b, atol=1e-5)
            and ctx.constrain(q, ("batch",)).full_tensor().equal(q)}


@check
def no_jax():
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax",
                                                               "repro"))
    return {"ok": not bad, "loaded": bad}


(WORK / f"report{RANK}.json").write_text(json.dumps(report))
destroy_world()
'''

CHECKS = ["mesh_executor", "mesh_executor_torch_matmul", "pipeline", "pipeline_moe", "collectives", "dp_gradient_sync",
          "fit_sharding", "mesh_sizes", "dtensor_kernels", "no_jax"]


def _pipeline_reference(work: Path, npz: str, arch: str,
                        n_micro: int) -> None:
    """The JAX layer scan of tests/test_spmd.py's pipeline check, with its
    inputs, saved for the ranks: the scan runs on each of ``n_micro``
    microbatches (1: the whole batch), and its aux is their mean."""
    cfg = jax_config(arch).reduced(n_layers=PIPE_LAYERS,
                                   compute_dtype="float32",
                                   param_dtype="float32", remat="none")
    lay = JTF.init_params(cfg, jax.random.PRNGKey(0))["layers"]
    x = jax.random.normal(jax.random.PRNGKey(1), (PIPE_B, PIPE_S,
                                                  cfg.d_model))
    mb = PIPE_B // n_micro
    positions = jnp.broadcast_to(jnp.arange(PIPE_S)[None], (mb, PIPE_S))
    body = JTF._layer_body(cfg, None, use_cache=False, train=True,
                           positions=positions, cache_pos=None,
                           shared_params=None, shared_norm=None)
    xs = {"params": lay, "idx": jnp.arange(PIPE_LAYERS)}
    ys, auxes = [], []
    for m in range(n_micro):
        (y, aux, _, _), _ = jax.lax.scan(
            body, (x[m * mb:(m + 1) * mb], jnp.zeros(()), None, None), xs)
        ys.append(np.asarray(y))
        auxes.append(np.asarray(aux))
    leaves = {f"layers/{k}": v for k, v in
              tree_flatten_with_paths(jax.device_get(lay))}
    np.savez(work / npz, x=np.asarray(x), y=np.concatenate(ys),
             aux=np.mean(auxes, dtype=np.float32), **leaves)


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    work = tmp_path_factory.mktemp("spmd_world")
    _pipeline_reference(work, "pipeline.npz", "yi-9b", 1)
    _pipeline_reference(work, "pipeline_moe.npz", "dbrx-132b", 4)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    spawn_world(["-c", _RANK_SCRIPT, str(work)], WORLD,
                timeout_s=WORLD_TIMEOUT_S, env=env, cwd=str(ROOT),
                workdir=str(work))
    return [json.loads((work / f"report{r}.json").read_text())
            for r in range(WORLD)]


@pytest.mark.parametrize("name", CHECKS)
def test_every_rank_passes(report, name):
    for rank, rep in enumerate(report):
        assert rep[name]["ok"], (rank, rep[name])


def test_mesh_executor_refines_and_counts_collectives(report):
    """Every rank resolves the same specs (the rule table's, which the
    refinement keeps on a uniform graph) and sees the same collective
    count; the ``mul`` bodies replicate their right operand (an
    all-gather each), as the reference's partitioned program does."""
    reps = [r["mesh_executor"] for r in report]
    assert all(r["specs"] == reps[0]["specs"] for r in reps)
    assert set(map(tuple, reps[0]["specs"].values())) == {("data",)}
    assert {r["collectives"] for r in reps} == {reps[0]["collectives"]}
    assert reps[0]["collectives"] >= 2
    assert max(r["max_err"] for r in reps) <= 1e-5
