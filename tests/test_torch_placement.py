"""The port's placement (rule tables, spec derivation, the greedy cost
refinement) against the JAX package's, every case of
``tests/test_placement.py``.

One duck-typed ``FakeMesh`` (``axis_names`` and ``shape``) is handed to
both packages: placement never touches devices.  A JAX ``PartitionSpec``
is compared to the port's spec tuple by its entries, and results are
equal, not approximately equal: the specs, the byte counts and the
refinement's choices.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.core import TaskGraph as JGraph, TaskKind as JKind  # noqa: E402
from repro.core import placement as JPL  # noqa: E402
from repro_torch.core import TaskGraph as PGraph  # noqa: E402
from repro_torch.core import TaskKind as PKind  # noqa: E402
from repro_torch.core import placement as PL  # noqa: E402


class FakeMesh:
    """Duck-typed mesh (axis_names + shape)."""
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESH = FakeMesh({"data": 16, "model": 16})
POD_MESH = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESHES = pytest.mark.parametrize("mesh", [MESH, POD_MESH],
                                 ids=["16x16", "2x16x16"])
MODES = ("dp", "dp_tp", "fsdp_tp", "dp_tp_ep", "dp_tp_kvseq", "fsdp_tp_sp")


def _spec(jspec):
    return tuple(jspec)


def _specs(jspecs):
    return {t: _spec(s) for t, s in jspecs.items()}


def _both_specs(axes, rules, mesh):
    want = _spec(JPL.logical_to_spec(axes, rules, mesh))
    return PL.logical_to_spec(axes, rules, mesh.axis_names), want


@MESHES
@pytest.mark.parametrize("mode", MODES)
def test_rule_table_modes(mesh, mode):
    pod = "pod" if "pod" in mesh.axis_names else None
    rules = PL.standard_rules(mode, pod_axis=pod)
    assert rules == JPL.standard_rules(mode, pod_axis=pod)
    for axes in [("batch", "seq", "d_model"), ("batch", "heads", None),
                 ("embed", "d_ff"), ("experts", "embed", "d_ff"),
                 ("layers", "batch", "kv_seq", "kv_heads", None)]:
        got, want = _both_specs(axes, rules, mesh)
        assert got == want, axes
    if mode in ("dp", "dp_tp", "fsdp_tp", "dp_tp_ep"):
        got, _ = _both_specs(("batch", "seq", "d_model"),
                             PL.standard_rules(mode, pod_axis=None), MESH)
        assert got[0] == "data"
    with pytest.raises(ValueError):
        PL.standard_rules("nope")


@MESHES
def test_first_match_wins_and_no_axis_reuse(mesh):
    rules = [("batch", ("data",)), ("heads", "model"), ("batch", None),
             ("weird", ("data", "model"))]
    for axes, want in [(("batch", "heads"), ("data", "model")),
                       (("batch", "weird"), ("data", "model"))]:
        got, ref = _both_specs(axes, rules, mesh)
        assert got == ref == want


def test_pod_axis_extends_batch():
    rules = PL.standard_rules("fsdp_tp", pod_axis="pod")
    assert _both_specs(("batch", "seq"), rules, POD_MESH) == \
        ((("pod", "data"),), (("pod", "data"),))
    # without pod in the mesh the pod axis is dropped
    assert _both_specs(("batch", "seq"), rules, MESH) == \
        (("data",), ("data",))


@MESHES
def test_sequence_parallel_rules(mesh):
    base = PL.standard_rules("dp_tp", pod_axis=None)
    rules = PL.sequence_parallel_rules(base)
    assert rules == JPL.sequence_parallel_rules(
        JPL.standard_rules("dp_tp", pod_axis=None))
    got, want = _both_specs(("batch", "seq", "d_model"), rules, mesh)
    assert got == want == ("data", "model")
    got, want = _both_specs(("batch", "seq", "heads"), rules, mesh)
    assert got == want == ("data", None, "model")


@pytest.mark.parametrize("spec,n", [(("data", "model"), 256),
                                    ((("data", "model"),), 256),
                                    ((None, "model"), 16), ((), 1),
                                    ((("pod", "data"), None, "model"), 512)])
def test_spec_shards(spec, n):
    assert PL.spec_shards(spec, POD_MESH) == \
        JPL.spec_shards(P(*spec), POD_MESH) == n


@MESHES
@pytest.mark.parametrize("src,dst", [
    (("data", None), ("data", None)), ((), ("data",)), (("data",), ()),
    (("data",), ("model",)), (("data",), ("data", None)),
    (("data", "model"), ("model",)), ((("data", "model"),), ())])
def test_resharding_cost_model_properties(mesh, src, dst):
    info = PL.ValueInfo((1024, 1024), 4, ("batch", "d_model"))
    jinfo = JPL.ValueInfo((1024, 1024), 4, ("batch", "d_model"))
    got = PL.resharding_bytes(info, src, dst, mesh)
    assert got == JPL.resharding_bytes(jinfo, P(*src), P(*dst), mesh)
    if src == dst or PL.spec_shards(src, mesh) == 1:
        assert got == 0.0          # equal, or replicated -> sliced locally
    elif not dst:
        assert 0 < got <= 1024 * 1024 * 4      # sharded -> replicated


def _diamond(G, K):
    g = G()
    a = g.add_node("a", None, (), {}, K.PURE, deps=[])
    b = g.add_node("b", None, (), {}, K.PURE, deps=[a])
    c = g.add_node("c", None, (), {}, K.PURE, deps=[a])
    d = g.add_node("d", None, (), {}, K.PURE, deps=[b, c])
    g.mark_output(d)
    return g


def _random_dag(G, K, seed, n=24):
    rng = np.random.default_rng(seed)
    g = G()
    for i in range(n):
        deps = sorted(set(rng.choice(i, size=min(i, rng.integers(0, 4)),
                                     replace=False).tolist())) if i else []
        g.add_node(f"t{i}", None, (), {}, K.PURE, deps=deps)
    g.mark_output(n - 1)
    return g


def _random_info(seed, n=24):
    rng = np.random.default_rng(seed + 1000)
    names = ["batch", "seq", "d_model", "heads", "d_ff", "vocab", None]
    info = {}
    for t in range(n):
        if rng.random() < 0.15:
            continue                     # a task with no value info
        ndim = int(rng.integers(1, 4))
        shape = tuple(int(rng.choice([16, 32, 48, 256, 1000, 4096]))
                      for _ in range(ndim))
        axes = tuple(names[int(i)] for i in rng.integers(0, len(names),
                                                         ndim))
        info[t] = (shape, int(rng.choice([2, 4])), axes)
    return info


def _refine_both(jg, pg, raw, rules, mesh):
    jinfo = {t: JPL.ValueInfo(*v) for t, v in raw.items()}
    pinfo = {t: PL.ValueInfo(*v) for t, v in raw.items()}
    jref = JPL.refine_placements(jg, jinfo, rules, mesh)
    pref = PL.refine_placements(pg, pinfo, rules, mesh)
    assert pref == _specs(jref)
    assert PL.total_resharding_bytes(pg, pinfo, pref, mesh) == \
        JPL.total_resharding_bytes(jg, jinfo, jref, mesh)
    init = {t: PL.logical_to_spec(pinfo[t].logical_axes, rules,
                                  mesh.axis_names) for t in pinfo}
    jinit = {t: JPL.logical_to_spec(jinfo[t].logical_axes, rules, mesh)
             for t in jinfo}
    for t in pg.nodes:
        init.setdefault(t, ())
        jinit.setdefault(t, P())
    before = PL.total_resharding_bytes(pg, pinfo, init, mesh)
    assert before == JPL.total_resharding_bytes(jg, jinfo, jinit, mesh)
    assert PL.total_resharding_bytes(pg, pinfo, pref, mesh) <= before + 1e-9
    return pref


@MESHES
def test_refinement_never_worse_than_rules(mesh):
    rules = PL.standard_rules("dp_tp", pod_axis=None)
    raw = {t: ((256, 4096), 4, ("batch", "d_model")) for t in range(4)}
    # make node b's natural layout conflict: logical axes transposed
    raw[1] = ((4096, 256), 4, ("d_model", "batch"))
    _refine_both(_diamond(JGraph, JKind), _diamond(PGraph, PKind), raw,
                 rules, mesh)


@MESHES
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", ["dp_tp", "fsdp_tp"])
def test_refinement_on_a_seeded_random_dag(mesh, seed, mode):
    pod = "pod" if "pod" in mesh.axis_names else None
    rules = PL.standard_rules(mode, pod_axis=pod)
    raw = _random_info(seed)
    specs = _refine_both(_random_dag(JGraph, JKind, seed),
                         _random_dag(PGraph, PKind, seed), raw, rules, mesh)
    assert set(specs) == set(range(24))


@MESHES
@pytest.mark.parametrize("shape,axes", [((256, 4096), ("batch", "d_model")),
                                        ((30, 4096), ("batch", "heads")),
                                        ((8, 32, 16), ("batch", None, "d_ff")),
                                        ((), ())])
def test_candidate_specs_contains_rule_spec_and_replicated(mesh, shape, axes):
    rules = PL.standard_rules("dp_tp", pod_axis=None)
    cands = PL.candidate_specs(PL.ValueInfo(shape, 4, axes), rules, mesh)
    assert cands == [_spec(c) for c in JPL.candidate_specs(
        JPL.ValueInfo(shape, 4, axes), rules, mesh)]
    assert () in cands
    assert PL.logical_to_spec(axes, rules, mesh.axis_names) in cands
    # the single-axis candidates' shard counts divide the dims, and for the
    # reference's shape the rule table's spec's do too
    for c in (cands if shape == (256, 4096) else cands[2:]):
        parts = list(c) + [None] * (len(shape) - len(c))
        for dim, part in zip(shape, parts):
            if part is None:
                continue
            parts_ = (part,) if isinstance(part, str) else part
            assert dim % int(np.prod([mesh.shape[a] for a in parts_])) == 0


def test_placements_and_tree_specs_follow_the_specs():
    """A spec as DTensor placements, and a tree of logical axes as specs:
    the counterparts of ``NamedSharding`` and ``tree_specs``."""
    from torch.distributed.tensor import Replicate, Shard
    assert PL.placements(("data", None, "model"), ("data", "model")) == \
        (Shard(0), Shard(2))
    assert PL.placements(((("pod", "data")),), ("pod", "data", "model")) == \
        (Shard(0), Shard(0), Replicate())
    with pytest.raises(ValueError, match="out of the mesh's order"):
        PL.placements((("data", "pod"),), ("pod", "data", "model"))
    rules = PL.standard_rules("fsdp_tp", pod_axis=None)
    tree = {"w": ("embed", "d_ff"), "b": {"n": ("norm_dim",)}}
    jspecs = JPL.tree_specs(tree, rules, MESH)
    assert PL.tree_specs(tree, rules, MESH) == {
        "w": _spec(jspecs["w"]), "b": {"n": _spec(jspecs["b"]["n"])}}
    assert PL.tree_shardings(tree, rules, MESH) == {
        "w": (Shard(0), Shard(1)), "b": {"n": (Replicate(), Replicate())}}
