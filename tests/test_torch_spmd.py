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
- the pipeline's gradient, under autograd, on both: each rank's gradient,
  summed over ``pod``, and its dx against ``jax.grad`` of the JAX scan run
  on each microbatch, the loss ``sum(y · w) + c · aux`` (``w`` drawn from
  a seed, ``c`` = PIPE_AUX_WEIGHT), each leaf within 2e-4 of its largest
  entry; the same comparison must fail on the gradient 4 times over and on
  one whose stage slices are rolled by one stage;
- 3 AdamW steps through the pipeline on yi-9b: the losses those of the
  same steps through ``layer_stack`` on each microbatch in this process,
  and the parameters the same bits on every rank after each step;
- the collective helpers against dense references, exactly (:141-199),
  and the gradients of the three that carry one;
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
PIPE_B, PIPE_S, PIPE_LAYERS, PIPE_MICRO = 8, 16, 4, 4
# the loss the pipeline's gradient checks differentiate: sum(y · w) +
# PIPE_AUX_WEIGHT · aux, w drawn from PIPE_W_SEED; the weight makes the aux
# term move dbrx-132b's router gradient far past the tolerance
PIPE_AUX_WEIGHT, PIPE_W_SEED = 1000.0, 2
# of each gradient leaf's largest entry: the forward check's tolerance
PIPE_GRAD_TOL = 2e-4
# the training check: AdamW steps through the pipeline on yi-9b, their
# losses held to layer_stack's at this relative tolerance
PIPE_STEPS, PIPE_LR, PIPE_LOSS_TOL = 3, 1e-3, 2e-4

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


def _load(npz):
    """The npz's arrays, and its ``layers/`` leaves as a tree."""
    ref = np.load(WORK / npz)
    tree = {}
    for key in ref.files:
        if key.startswith("layers/"):
            node = tree
            *path, leaf = key.split("/")[1:]
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = ref[key]
    return ref, tree


def _config(arch):
    from repro_torch.configs import get_config
    return get_config(arch).reduced(n_layers=4, compute_dtype="float32",
                                    param_dtype="float32", remat="none")


def _pipeline(arch, npz):
    from repro_torch.interop import params_from_numpy
    from repro_torch.parallel.mesh import make_mesh_for
    from repro_torch.parallel.pipeline import (bubble_fraction,
                                               pipelined_forward,
                                               split_stages)
    ref, tree = _load(npz)
    cfg = _config(arch)
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


def _pipeline_loss(fn, lay, x, w, n_stages):
    """The loss sum(y · w) + c · aux through ``fn``, and its gradient: of
    x, and of each layer leaf on this rank."""
    from repro_torch.parallel.pipeline import split_stages
    from repro_torch.tree import tree_leaves, tree_unflatten
    y, aux = fn(split_stages(lay, n_stages, 4), x)
    loss = (y * w).sum() + PIPE_AUX_WEIGHT * aux
    leaves = tree_leaves(lay)
    grads = torch.autograd.grad(loss, [x] + leaves)
    return loss.detach(), grads[0], tree_unflatten(lay, grads[1:])


def _gap(got, want):
    """Each gradient's largest |difference| over its largest |entry|."""
    return {p: float((g - want[p]).abs().max() / want[p].abs().max())
            for p, g in got.items()}


def _pipeline_grad(arch, npz):
    from repro_torch.interop import params_from_numpy
    from repro_torch.parallel.collectives import psum_tree
    from repro_torch.parallel.mesh import make_mesh_for
    from repro_torch.parallel.pipeline import pipelined_forward
    from repro_torch.tree import tree_flatten_with_paths, tree_map
    ref, tree = _load(npz)
    lay = tree_map(lambda a: a.requires_grad_(),
                   params_from_numpy(tree, "cpu"))
    x = torch.from_numpy(ref["x"]).requires_grad_()
    mesh = make_mesh_for(8, model_parallel=2, pods=4)
    fn = pipelined_forward(_config(arch), mesh, n_microbatch=PIPE_MICRO,
                           stage_axis="pod")
    _, dx, g = _pipeline_loss(fn, lay, x, torch.from_numpy(ref["w"]), 4)
    g = psum_tree(g, mesh, "pod")
    want = {p: torch.from_numpy(ref[f"grad/{p}"]) for p in
            ["x"] + [f"layers/{q}" for q, _ in tree_flatten_with_paths(g)]}

    def gradients(scale=1.0, roll=0):
        out = {"x": dx * scale}
        for q, a in tree_flatten_with_paths(g):
            # the layer dim split into stages, rolled by `roll` stages
            s = a.reshape((4, -1) + tuple(a.shape[1:])).roll(roll, 0)
            out[f"layers/{q}"] = s.reshape(a.shape) * scale
        return out

    gap = _gap(gradients(), want)
    controls = {"four_times": _gap(gradients(4.0), want),
                "wrong_stage": _gap(gradients(roll=1), want)}
    return {"ok": max(gap.values()) <= PIPE_GRAD_TOL and all(
        max(c.values()) > PIPE_GRAD_TOL for c in controls.values()),
            "gap": gap, "controls": {k: max(c.values())
                                     for k, c in controls.items()}}


@check
def pipeline_grad():
    return _pipeline_grad("yi-9b", "pipeline.npz")


@check
def pipeline_moe_grad():
    return _pipeline_grad("dbrx-132b", "pipeline_moe.npz")


@check
def pipeline_train():
    """PIPE_STEPS AdamW steps through the pipeline: each step's loss, and
    a digest of the parameters' bytes after it."""
    import hashlib
    from repro_torch.interop import params_from_numpy
    from repro_torch.optim import AdamW
    from repro_torch.parallel.collectives import psum_tree
    from repro_torch.parallel.mesh import make_mesh_for
    from repro_torch.parallel.pipeline import pipelined_forward
    from repro_torch.tree import tree_leaves, tree_map
    ref, tree = _load("pipeline.npz")
    lay = params_from_numpy(tree, "cpu")
    x, w = torch.from_numpy(ref["x"]), torch.from_numpy(ref["w"])
    mesh = make_mesh_for(8, model_parallel=2, pods=4)
    fn = pipelined_forward(_config("yi-9b"), mesh, n_microbatch=PIPE_MICRO,
                           stage_axis="pod")
    opt = AdamW(lr=PIPE_LR)
    state = opt.init(lay)
    losses, digests = [], []
    for _ in range(PIPE_STEPS):
        alias = tree_map(lambda a: a.detach().requires_grad_(), lay)
        loss, _, g = _pipeline_loss(fn, alias, x.clone().requires_grad_(),
                                    w, 4)
        opt.update(psum_tree(g, mesh, "pod"), state, lay)
        losses.append(float(loss))
        digest = hashlib.sha256()
        for a in tree_leaves(lay):
            digest.update(a.numpy().tobytes())
        digests.append(digest.hexdigest())
    want = np.load(WORK / "pipeline_train.npy").tolist()
    return {"ok": bool(np.allclose(losses, want, rtol=PIPE_LOSS_TOL, atol=0)),
            "losses": losses, "want": want, "digests": digests}


@check
def collectives():
    from repro_torch.parallel.collectives import (all_gather_seq, copy_to,
                                                  dp_gradient_sync, pmax,
                                                  pmean_tree, psum_tree,
                                                  reduce_from,
                                                  reduce_scatter, ring_hop,
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
    # the Functions' gradients, of the sum over ranks of each rank's loss:
    # a hop's goes back to the sender; reduce_from's is its own (each rank
    # takes the same loss of the sum); copy_to's sums the ranks'
    w = x + 100.0                             # rank r's weights: w[r]
    xg = mine.clone().requires_grad_()
    (dx,) = torch.autograd.grad((ring_hop(xg, mesh, "data", 3)
                                 * w[i:i + 1]).sum(), xg)
    got["ring_hop_grad"] = torch.equal(dx, torch.roll(w, -3, 0)[i:i + 1])
    (dx,) = torch.autograd.grad((reduce_from(xg, mesh, "data")
                                 * w[0:1]).sum(), xg)
    got["reduce_from_grad"] = torch.equal(dx, w[0:1])
    cg = x[0:1].clone().requires_grad_()
    (dc,) = torch.autograd.grad((copy_to(cg, mesh, "data")
                                 * w[i:i + 1]).sum(), cg)
    got["copy_to_grad"] = torch.equal(dc, w.sum(0, keepdim=True))
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

CHECKS = ["mesh_executor", "mesh_executor_torch_matmul", "pipeline",
          "pipeline_moe", "pipeline_grad", "pipeline_moe_grad",
          "pipeline_train", "collectives", "dp_gradient_sync",
          "fit_sharding", "mesh_sizes", "dtensor_kernels", "no_jax"]


def _pipeline_reference(work: Path, npz: str, arch: str,
                        n_micro: int) -> None:
    """The JAX layer scan of tests/test_spmd.py's pipeline check, with its
    inputs, saved for the ranks: the scan runs on each of ``n_micro``
    microbatches (1: the whole batch), and its aux is their mean.  Beside
    it, ``jax.grad`` of sum(y · w) + PIPE_AUX_WEIGHT · aux over x and every
    layer leaf, the scan run on each of PIPE_MICRO microbatches."""
    cfg = jax_config(arch).reduced(n_layers=PIPE_LAYERS,
                                   compute_dtype="float32",
                                   param_dtype="float32", remat="none")
    lay = JTF.init_params(cfg, jax.random.PRNGKey(0))["layers"]
    x = jax.random.normal(jax.random.PRNGKey(1), (PIPE_B, PIPE_S,
                                                  cfg.d_model))
    w = np.random.default_rng(PIPE_W_SEED).standard_normal(
        x.shape).astype(np.float32)
    xs = {"params": lay, "idx": jnp.arange(PIPE_LAYERS)}

    def scan(lay, x, n_micro):
        mb = PIPE_B // n_micro
        positions = jnp.broadcast_to(jnp.arange(PIPE_S)[None], (mb, PIPE_S))
        body = JTF._layer_body(cfg, None, use_cache=False, train=True,
                               positions=positions, cache_pos=None,
                               shared_params=None, shared_norm=None)
        ys, auxes = [], []
        for m in range(n_micro):
            (y, aux, _, _), _ = jax.lax.scan(
                body, (x[m * mb:(m + 1) * mb], jnp.zeros(()), None, None),
                {**xs, "params": lay})
            ys.append(y)
            auxes.append(aux)
        return jnp.concatenate(ys), jnp.mean(jnp.stack(auxes))

    def loss(lay, x):
        y, aux = scan(lay, x, PIPE_MICRO)
        return jnp.sum(y * w) + PIPE_AUX_WEIGHT * aux

    y, aux = scan(lay, x, n_micro)
    g_lay, g_x = jax.grad(loss, argnums=(0, 1))(lay, x)
    leaves = {f"layers/{k}": v for k, v in
              tree_flatten_with_paths(jax.device_get(lay))}
    grads = {f"grad/layers/{k}": v for k, v in
             tree_flatten_with_paths(jax.device_get(g_lay))}
    np.savez(work / npz, x=np.asarray(x), y=np.asarray(y),
             aux=np.asarray(aux, dtype=np.float32), w=w,
             **{"grad/x": np.asarray(g_x)}, **leaves, **grads)


def _sequential_losses(npz: Path) -> list:
    """The losses of PIPE_STEPS AdamW steps of the port's ``layer_stack``
    on each of PIPE_MICRO microbatches, from the npz's yi-9b parameters
    and inputs: what the ranks' steps through the pipeline must meet."""
    from repro_torch.configs import get_config
    from repro_torch.interop import params_from_numpy
    from repro_torch.models import transformer as TF
    from repro_torch.optim import AdamW
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten
    ref = np.load(npz)
    cfg = get_config("yi-9b").reduced(n_layers=PIPE_LAYERS,
                                      compute_dtype="float32",
                                      param_dtype="float32", remat="none")
    tree = {}
    for key in ref.files:
        if key.startswith("layers/"):
            node = tree
            *path, leaf = key.split("/")[1:]
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = ref[key]
    lay = params_from_numpy(tree, "cpu")
    x, w = torch.from_numpy(ref["x"]), torch.from_numpy(ref["w"])
    mb = PIPE_B // PIPE_MICRO
    positions = torch.arange(PIPE_S).expand(mb, PIPE_S)
    opt = AdamW(lr=PIPE_LR)
    state = opt.init(lay)
    losses = []
    for _ in range(PIPE_STEPS):
        alias = tree_map(lambda a: a.detach().requires_grad_(), lay)
        loss, aux = 0.0, 0.0
        for m in range(PIPE_MICRO):
            y, a, _ = TF.layer_stack(alias, x[m * mb:(m + 1) * mb], cfg,
                                     positions=positions, train=True)
            loss = loss + (y * w[m * mb:(m + 1) * mb]).sum()
            aux = aux + a
        loss = loss + PIPE_AUX_WEIGHT * aux / PIPE_MICRO
        g = torch.autograd.grad(loss, tree_leaves(alias))
        opt.update(tree_unflatten(alias, g), state, lay)
        losses.append(float(loss.detach()))
    return losses


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    work = tmp_path_factory.mktemp("spmd_world")
    _pipeline_reference(work, "pipeline.npz", "yi-9b", 1)
    _pipeline_reference(work, "pipeline_moe.npz", "dbrx-132b", 4)
    np.save(work / "pipeline_train.npy",
            np.array(_sequential_losses(work / "pipeline.npz")))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    # the ranks read the pipeline checks' constants from this module
    consts = "".join(f"{k} = {globals()[k]!r}\n" for k in (
        "PIPE_MICRO", "PIPE_AUX_WEIGHT", "PIPE_GRAD_TOL", "PIPE_STEPS",
        "PIPE_LR", "PIPE_LOSS_TOL"))
    spawn_world(["-c", consts + _RANK_SCRIPT, str(work)], WORLD,
                timeout_s=WORLD_TIMEOUT_S, env=env, cwd=str(ROOT),
                workdir=str(work))
    return [json.loads((work / f"report{r}.json").read_text())
            for r in range(WORLD)]


@pytest.mark.parametrize("name", CHECKS)
def test_every_rank_passes(report, name):
    for rank, rep in enumerate(report):
        assert rep[name]["ok"], (rank, rep[name])


def test_pipeline_training_keeps_every_rank_on_the_same_bits(report):
    """After each AdamW step through the pipeline, the gradient summed over
    the stage axis, every rank holds the same parameter bits."""
    digests = [r["pipeline_train"]["digests"] for r in report]
    assert len(digests[0]) == PIPE_STEPS
    assert all(d == digests[0] for d in digests), digests
    assert len(set(digests[0])) == PIPE_STEPS      # each step moved them


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


@pytest.mark.parametrize("arch", ["yi-9b", "dbrx-132b"])
def test_a_pipeline_of_one_rank_gives_layer_stacks_gradient(tmp_path, arch):
    """A world of one gloo rank, in this process: ``pipelined_forward``
    under autograd (one stage, PIPE_MICRO microbatches, selective remat,
    as the card's training runs) against ``layer_stack`` run on each
    microbatch, the same loss, every gradient leaf and dx within
    PIPE_GRAD_TOL of its largest entry."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TF
    from repro_torch.parallel.mesh import (destroy_world, init_world,
                                           make_mesh_for)
    from repro_torch.parallel.pipeline import pipelined_forward, split_stages
    from repro_torch.tree import tree_flatten_with_paths, tree_leaves, tree_map
    cfg = get_config(arch).reduced(n_layers=PIPE_LAYERS,
                                   compute_dtype="float32",
                                   param_dtype="float32", remat="selective")
    lay = tree_map(lambda a: a.requires_grad_(),
                   TF.init_params(cfg, 0, "cpu")["layers"])
    gen = torch.Generator().manual_seed(PIPE_W_SEED)
    x = torch.randn((PIPE_B, PIPE_S, cfg.d_model),
                    generator=gen).requires_grad_()
    w = torch.randn(x.shape, generator=gen)
    leaves = [x] + tree_leaves(lay)
    mb = PIPE_B // PIPE_MICRO
    positions = torch.arange(PIPE_S).expand(mb, PIPE_S)
    loss, aux = 0.0, 0.0
    for m in range(PIPE_MICRO):
        y, a, _ = TF.layer_stack(lay, x[m * mb:(m + 1) * mb], cfg,
                                 positions=positions, train=True)
        loss = loss + (y * w[m * mb:(m + 1) * mb]).sum()
        aux = aux + a
    want = torch.autograd.grad(loss + PIPE_AUX_WEIGHT * aux / PIPE_MICRO,
                               leaves)
    assert not dist.is_initialized()
    init_world(0, 1, str(tmp_path / "store"), device="cpu")
    try:
        fn = pipelined_forward(cfg, make_mesh_for(1), stage_axis="data",
                               n_microbatch=PIPE_MICRO)
        y, aux = fn(split_stages(lay, 1, PIPE_LAYERS), x)
        got = torch.autograd.grad((y * w).sum() + PIPE_AUX_WEIGHT * aux,
                                  leaves)
    finally:
        destroy_world()
    names = ["x"] + [p for p, _ in tree_flatten_with_paths(lay)]
    gap = {p: float((g - h).abs().max() / h.abs().max())
           for p, g, h in zip(names, got, want)}
    assert max(gap.values()) <= PIPE_GRAD_TOL, gap
    if arch == "dbrx-132b":
        assert float(aux.detach()) != 0.0
