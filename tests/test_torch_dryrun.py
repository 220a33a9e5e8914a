"""The port's dry-run (``repro_torch.launch.dryrun``, ``launch/steps.py``'s
cases, ``launch/costs.py``'s counter) against the JAX package's
``repro/launch/dryrun.py`` and ``tests/test_roofline.py``.

The port's helpers are held to the reference's on the same inputs:
``_wire_bytes`` on a grid, ``_probe_depths`` for every arch, and
``parse_collectives`` of events written from the reference test's HLO
lines.  The reference's "promoted" half-width rule is XLA:CPU's (a bf16
all-reduce computed in f32 on the host) and has no counterpart in the
port, whose events carry the bytes the card moves: the promoted
all-reduce's event is written at its bf16 width.  A case's per-device
bytes are held to ``NamedSharding.shard_shape`` of the reference's
``build_case`` on a (16, 16) mesh (computed in a subprocess with 256 forced
host devices, nothing compiled).  The counts are held to numbers written
out from the shapes: a reduced prefill's FLOPs, and a ``torch.matmul`` on
DTensors of a fake (16, 16) mesh, whose rank's share is 1/256 of what
``FlopCounterMode`` counts.  Every fake world lives in this process only
inside ``dryrun.fake_world``, which destroys it on exit.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.launch.costs import Counter  # noqa: E402
from repro_torch.models.config import SHAPES, ShapeSpec  # noqa: E402
from repro_torch.tree import tree_flatten_with_paths  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _reference_dryrun():
    """``repro.launch.dryrun``, whose import sets 512 forced host devices in
    ``XLA_FLAGS``: the variable is put back, so no later JAX start in this
    process sees it."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as ref
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref


def _reduced_overrides(arch, **kw):
    """The config fields in which ``get_config(arch).reduced(**kw)`` differs
    from the published config, as ``build_case`` overrides."""
    full = get_config(arch)
    red = full.reduced(**kw)
    return {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
            if f.name != "layer_plan"
            and getattr(red, f.name) != getattr(full, f.name)}


# --------------------------------------------------------------------------
# the reference's helpers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["all-gather", "all-reduce", "reduce-scatter",
                                "all-to-all", "collective-permute",
                                "collective-broadcast"])
def test_wire_bytes_equal_the_references(op):
    ref = _reference_dryrun()
    for b in (0.0, 1.0, 1000.0, 3.5e9):
        for g in (1, 2, 4, 16, 256):
            assert dryrun._wire_bytes(op, b, g) == ref._wire_bytes(op, b, g)


def test_probe_depths_equal_the_references():
    ref = _reference_dryrun()
    assert ARCHS == JAX_ARCHS
    for arch in ARCHS:
        assert dryrun._probe_depths(get_config(arch)) == \
            ref._probe_depths(jax_config(arch)), arch


_HLO = [
    "%ar = f32[256] all-reduce(%x), replica_groups={{0,1,2,3}}, "
    "to_apply=%add",
    "%arp = f32[256] all-reduce(%y), replica_groups={{0,1,2,3}}, "
    "to_apply=%add.clone_promoted",
    "%ag = bf16[512] all-gather(%z), replica_groups=[2,2]<=[4], "
    "dimensions={0}",
    "%cp = f32[64] collective-permute(%w), "
    "source_target_pairs={{0,1},{1,0}}",
]
# the same operations as the counter's events; the promoted all-reduce at
# the bf16 width the card moves (the reference halves XLA:CPU's f32)
_EVENTS = [
    {"op": "all-reduce", "bytes": 1024, "groups": [[0, 1, 2, 3]]},
    {"op": "all-reduce", "bytes": 512, "groups": [[0, 1, 2, 3]]},
    {"op": "all-gather", "bytes": 1024, "groups": [[0, 1], [2, 3]]},
    {"op": "collective-permute", "bytes": 256, "pairs": [[0, 1], [1, 0]]},
]


def test_parse_collectives_equals_the_references():
    ref = _reference_dryrun()
    want = ref.parse_collectives("\n".join(_HLO))
    got = dryrun.parse_collectives(_EVENTS)
    assert {k: got[k] for k in want} == want
    assert want["_n_ops"] == 4 and want["all-reduce"] == 1024 + 512
    # every group lies inside one node of 8: all of it on NVLink
    assert got["_wire_nvlink_bytes"] == got["_wire_ici_bytes"]
    assert got["_wire_ib_bytes"] == 0.0


def test_dcn_attribution_equals_the_references():
    ref = _reference_dryrun()
    hlo = ("%ar = f32[256] all-reduce(%x), replica_groups={{0,300}}, "
           "to_apply=%add")
    events = [{"op": "all-reduce", "bytes": 1024, "group": [0, 300]}]
    for boundary in (256, 512):
        want = ref.parse_collectives(hlo, pod_boundary=boundary)
        got = dryrun.parse_collectives(events, pod_boundary=boundary)
        assert {k: got[k] for k in want} == want
        # ranks 0 and 300 are on different nodes: InfiniBand either way
        assert got["_wire_ib_bytes"] == got["_wire_ici_bytes"] + \
            got["_wire_dcn_bytes"] > 0
    assert dryrun.parse_collectives(events, 256)["_wire_dcn_bytes"] > 0
    assert dryrun.parse_collectives(events, 512)["_wire_dcn_bytes"] == 0


def test_a_fake_meshs_first_axis_groups_are_the_references():
    """The (2, 2) mesh's groups over its first axis, as the reference's
    transposed iota case gives them; rank 0's collective over that axis
    carries its group, and the op log round-trips it."""
    ref = _reference_dryrun()
    want = ref._parse_groups("x = f32[4] all-reduce(y), "
                             "replica_groups=[2,2]<=[2,2]T(1,0), "
                             "to_apply=add")
    assert want == [[0, 2], [1, 3]]
    from torch.distributed.tensor import Partial, Replicate
    from torch._subclasses.fake_tensor import FakeTensorMode
    with dryrun.fake_world(4):
        from repro_torch.parallel.mesh import make_mesh_for
        mesh = make_mesh_for(4, model_parallel=2, device="cpu")
        dm = mesh.device_mesh
        assert dm.mesh.T.tolist() == want        # every group of axis 0
        from torch.distributed.tensor import DTensor
        with FakeTensorMode(), Counter(log=True) as c:
            x = DTensor.from_local(torch.empty(8, 4), dm,
                                   [Partial(), Replicate()],
                                   run_check=False)
            x.redistribute(dm, [Replicate(), Replicate()])
    assert [e["group"] for e in c.collectives] == [want[0]]
    assert dryrun.events_from_text(c.text()) == c.collectives


# --------------------------------------------------------------------------
# the counts
# --------------------------------------------------------------------------

def test_a_torch_matmul_on_dtensors_counts_the_ranks_local_product():
    """x (4096 x 3584, Shard(0), Replicate()) @ w (3584 x 18944, Shard(0),
    Shard(1)) on a fake (16, 16) mesh: the rank multiplies 4096 x 224 by
    224 x 1184 (x's rows moved to its columns by an all-to-all); the
    FlopCounterMode of the parent tree counted the global product."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    with dryrun.fake_world(256):
        dm = dryrun.make_mesh("single").device_mesh
        with FakeTensorMode():
            x = distribute_tensor(torch.empty(4096, 3584), dm,
                                  [Shard(0), Replicate()],
                                  src_data_rank=None)
            w = distribute_tensor(torch.empty(3584, 18944), dm,
                                  [Shard(0), Shard(1)], src_data_rank=None)
            with Counter() as c:
                torch.matmul(x, w)
    assert sum(c.flops_by_dtype.values()) == 2_172_649_472 \
        == 2 * 4096 * 224 * 1184
    assert c.flops_by_dtype == {"float32": 2_172_649_472}
    assert [e["op"] for e in c.collectives] == ["all-to-all"]


def test_a_fake_tensor_routes_to_the_operator_a_real_one_to_the_plain():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import operator_route, operators, ops, ref
    q = torch.randn(1, 2, 8, 16, generator=torch.Generator().manual_seed(0))
    assert operators.counting == 0
    assert operator_route(q) is None
    assert torch.equal(ops.flash_attention(q, q, q),
                       ref.attention(q, q, q, causal=True))
    with FakeTensorMode():
        fq = torch.empty(1, 2, 8, 16)
        assert operator_route(fq) is torch.ops.repro_torch
        with Counter() as c:
            ops.flash_attention(fq, fq, fq)
    # the kernel's work: 4 D a visible pair (36 of 64 under the causal
    # mask) and head, not the plain version's S x S products
    assert dict(c.flops_by_op) == {"repro_torch.flash_attention":
                                   4 * 16 * 36 * 2}
    with Counter() as c:
        out = ops.flash_attention(q, q, q)
    assert dict(c.flops_by_op) == {"repro_torch.flash_attention":
                                   4 * 16 * 36 * 2}
    assert torch.equal(out, ref.attention(q, q, q, causal=True))


def test_a_reduced_prefill_counts_the_flops_of_its_shapes():
    arch = "qwen2-7b"
    over = dict(_reduced_overrides(arch), compute_dtype="bfloat16")
    B, S = 2, 16
    with dryrun.fake_world(1):
        case = steps.build_case(arch, ShapeSpec("p", S, B, "prefill"),
                                dryrun.make_mesh("one"), overrides=over)
        cost = steps.lower_case(case).compile().cost_analysis()
    cfg = case.cfg
    d, H, KH, hd, ff, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                           cfg.head_dim, cfg.d_ff, cfg.vocab_size)
    T = B * S
    layer = (2 * T * d * H * hd            # q
             + 2 * 2 * T * d * KH * hd     # k, v
             + 2 * T * H * hd * d          # o
             + 3 * 2 * T * d * ff          # swiglu: gate, up, down
             + 4 * hd * (S * (S + 1) // 2) * B * H)   # attention
    unembed = 2 * T * d * V
    assert cost["flops"] == cfg.n_layers * layer + unembed
    # bf16 products on the tensor cores, the float32 logits on the CUDA
    # cores
    assert cost["flops_by_dtype"] == {"bfloat16": cfg.n_layers * layer,
                                      "float32": unembed}
    assert cost["collectives"] == 0                  # a mesh of one device


def test_a_reduced_train_step_counts_the_flash_backward_once_a_layer():
    """A reduced qwen2-7b training step on fake tensors: the flash
    backward runs as the operator ``repro_torch::flash_attention_backward``
    once a layer, counted at ``flash_backward_flops`` (the kernels' seven
    products, 14 D a visible pair) in the inputs' dtype, beside the
    forward's two launches a layer (the forward and the remat recompute);
    the backward's products are no longer float32 torch ops."""
    from repro_torch.kernels import operators
    arch = "qwen2-7b"
    over = dict(_reduced_overrides(arch), compute_dtype="bfloat16")
    B, S = 2, 16
    with dryrun.fake_world(1):
        case = steps.build_case(arch, ShapeSpec("t", S, B, "train"),
                                dryrun.make_mesh("one"), overrides=over)
        compiled = steps.lower_case(case).compile()
    cfg = case.cfg
    cost = compiled.cost_analysis()
    ops = [line.split(" ")[0] for line in compiled.as_text().splitlines()]
    L, H, hd = cfg.n_layers, cfg.n_heads, cfg.head_dim
    assert ops.count("repro_torch.flash_attention_backward.default") == L
    assert ops.count("repro_torch.flash_attention.default") == 2 * L
    per_layer = operators.flash_backward_flops(B, H, S, S, hd, True)
    assert per_layer == 14 * hd * (S * (S + 1) // 2) * B * H
    assert cost["flops_by_op"]["repro_torch.flash_attention_backward"] == \
        L * per_layer
    assert cost["flops_by_op"]["repro_torch.flash_attention"] == \
        2 * L * operators.flash_flops(B, H, S, S, hd, True)
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        q = torch.empty(B, H, S, hd, dtype=torch.bfloat16)
        k = torch.empty(B, cfg.n_kv_heads, S, hd, dtype=torch.bfloat16)
        lse = torch.empty(B, H, S)
        args = (q, k, k, q, q, lse, True)
        cost_fn = operators.FLOPS[
            torch.ops.repro_torch.flash_attention_backward.default]
        assert cost_fn(args, None) == (per_layer, "bfloat16")
        grads = torch.ops.repro_torch.flash_attention_backward(*args)
    assert [tuple(g.shape) for g in grads] == [tuple(q.shape),
                                              tuple(k.shape), tuple(k.shape)]
    assert all(g.dtype == torch.bfloat16 for g in grads)


@pytest.mark.parametrize("arch,kw,L", [
    ("qwen2-7b", {}, 6),
    ("zamba2-7b", {"shared_attn_every": 2}, 6),
])
def test_the_probe_extrapolation_equals_the_full_depth_count(arch, kw, L):
    """The reference extrapolates from two probe depths because XLA counts
    a scanned layer once; the port counts every layer, so the extrapolation
    must equal its count where cost is affine in depth: the FLOPs and the
    collectives exactly, the bytes to a few bytes in 10^8 (a few 0-d
    operations per shared-attention site do not scale with it)."""
    over = dict(_reduced_overrides(arch, **kw), n_layers=L)
    shape = ShapeSpec("t", 32, 2, "train")
    with dryrun.fake_world(4):
        mesh = dryrun.make_mesh("one")
        full = dryrun._cost_record(steps.lower_case(steps.build_case(
            arch, shape, mesh, overrides=over)).compile())
        corr = dryrun.probe_correction(arch, shape, mesh, "fsdp_tp", over)
    assert corr["probe_depths"][1] < L
    assert corr["flops_per_device"] == full["flops_per_device"]
    assert corr["flops_by_dtype"] == full["flops_by_dtype"]
    assert corr["bytes_per_device"] == pytest.approx(
        full["bytes_per_device"], rel=1e-6)
    assert corr["collectives"]["_n_ops"] == \
        dryrun.parse_collectives(full["events"])["_n_ops"]


@pytest.mark.parametrize("arch", ARCHS)
def test_every_serving_case_runs_on_fake_tensors(arch):
    """A prefill and a decode case of each arch, reduced in width, on a
    fake (2, 2) mesh: each reads the cache's write position on fake
    tensors (the parent tree's forward raised there), and the decode case
    writes at the last slot."""
    over = _reduced_overrides(arch)
    with dryrun.fake_world(4):
        from repro_torch.parallel.mesh import make_mesh_for
        mesh = make_mesh_for(4, model_parallel=2, device="cpu")
        for kind in ("prefill", "decode"):
            case = steps.build_case(arch, ShapeSpec("s", 16, 4, kind), mesh,
                                    overrides=over)
            compiled = steps.lower_case(case).compile()
            logits, cache = compiled.outputs
            assert tuple(logits.shape) == (4, case.cfg.vocab_size)
            assert int(cache["pos"]) == 16     # 16 tokens, or slot 15 + 1
            assert compiled.cost_analysis()["flops"] > 0


# --------------------------------------------------------------------------
# the cases' layouts against the reference's
# --------------------------------------------------------------------------

_REF_SHARDS = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
import jax
import numpy as np
from repro.launch.mesh import make_production_mesh
from repro.launch import steps

def key(path):
    out = []
    for k in path:
        out.append(str(getattr(k, "key", getattr(k, "idx", k))))
    return "/".join(out)

mesh = make_production_mesh(multi_pod=False)
out = {}
for arch, shape in json.loads(sys.argv[1]):
    case = steps.build_case(arch, shape, mesh)
    shs = jax.tree.map(steps._fit_sharding, case.args, case.in_shardings)
    leaves = jax.tree_util.tree_flatten_with_path(case.args)[0]
    sh = jax.tree.leaves(shs)
    out[f"{arch}/{shape}"] = {
        key(p): int(np.prod(s.shard_shape(leaf.shape))) * leaf.dtype.itemsize
        for (p, leaf), s in zip(leaves, sh)}
print(json.dumps(out))
"""

_SHARD_CELLS = [("qwen2-7b", "train_4k"), ("dbrx-132b", "decode_32k"),
                ("whisper-tiny", "prefill_32k")]


def test_case_leaves_hold_the_references_per_device_bytes():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _REF_SHARDS,
                           json.dumps(_SHARD_CELLS)], capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    with dryrun.fake_world(256):
        mesh = dryrun.make_mesh("single")
        for arch, shape in _SHARD_CELLS:
            case = steps.build_case(arch, shape, mesh)
            got = {}
            for i, arg in enumerate(case.args):
                for path, t in (tree_flatten_with_paths(arg)
                                if isinstance(arg, dict) else [("", arg)]):
                    loc = t.to_local() if hasattr(t, "to_local") else t
                    got["/".join(filter(None, (str(i), path)))] = \
                        loc.numel() * loc.element_size()
            assert got == want[f"{arch}/{shape}"], (arch, shape)
            assert case.kind == SHAPES[shape].kind
