"""The port's checkpoint store, and checkpoints crossing between the two
packages bit for bit (a bf16 leaf and an int32 step among them), as
``tests/test_checkpoint.py`` checks the reference's store."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import store as J  # noqa: E402
from repro_torch.checkpoint import store as P  # noqa: E402
from repro_torch.interop import tensor_from_numpy, tensor_to_numpy  # noqa: E402
from repro_torch.tree import tree_flatten_with_paths  # noqa: E402


def tree():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "b": torch.ones(4, dtype=torch.bfloat16)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def _random_tree(seed):
    """numpy leaves: float32, bf16 (random bits) and an int32 step."""
    rng = np.random.default_rng(seed)
    bf16 = jnp.asarray(rng.standard_normal((5, 7), dtype=np.float32),
                       jnp.bfloat16)
    return {"params": {"layers": {"w": rng.standard_normal(
                           (2, 3, 4), dtype=np.float32)},
                       "embed": np.asarray(bf16)},
            "opt": {"step": np.asarray(41, np.int32),
                    "m": {"w": rng.standard_normal((2, 3, 4),
                                                   dtype=np.float32)}}}


def _bits(a):
    a = np.asarray(a)
    return a.tobytes(), a.shape, str(a.dtype)


def test_roundtrip(tmp_path):
    d = str(tmp_path)
    P.save_checkpoint(d, 42, tree(), extra={"data_step": 42})
    assert P.latest_step(d) == 42
    out, extra = P.restore_checkpoint(d, target=tree())
    assert extra == {"data_step": 42}
    assert torch.equal(out["params"]["w"], torch.arange(12.0).reshape(3, 4))
    assert out["params"]["b"].dtype == torch.bfloat16
    assert out["opt"]["step"].dtype == torch.int32
    assert int(out["opt"]["step"]) == 7


def test_restore_without_target_returns_flat(tmp_path):
    d = str(tmp_path)
    P.save_checkpoint(d, 1, tree())
    values, _ = P.restore_checkpoint(d)
    assert sorted(values) == ["opt/step", "params/b", "params/w"]
    assert values["params/b"].dtype == torch.bfloat16


def test_restore_rejects_shape_mismatch(tmp_path):
    d = str(tmp_path)
    P.save_checkpoint(d, 1, tree())
    bad = tree()
    bad["params"]["w"] = torch.zeros(5, 5)
    with pytest.raises(ValueError):
        P.restore_checkpoint(d, target=bad)


def test_restore_takes_the_targets_dtype(tmp_path):
    d = str(tmp_path)
    P.save_checkpoint(d, 1, tree())
    target = tree()
    target["params"]["w"] = torch.zeros(3, 4, dtype=torch.bfloat16)
    out, _ = P.restore_checkpoint(d, target=target)
    assert out["params"]["w"].dtype == torch.bfloat16
    assert out["params"]["w"].device == target["params"]["w"].device


def test_latest_and_explicit_step(tmp_path):
    d = str(tmp_path)
    for s in (10, 20, 30):
        t = tree()
        t["opt"]["step"] = torch.tensor(s, dtype=torch.int32)
        P.save_checkpoint(d, s, t)
    assert P.latest_step(d) == 30
    out, _ = P.restore_checkpoint(d, step=20, target=tree())
    assert int(out["opt"]["step"]) == 20
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]


def test_async_checkpointer_gc_and_snapshot(tmp_path):
    d = str(tmp_path)
    ck = P.AsyncCheckpointer(d, keep=2)
    for s in range(5):
        ck.save(s, tree())
    ck.wait()
    assert sorted(int(x.split("_")[1]) for x in os.listdir(d)) == [3, 4]
    t = {"w": torch.zeros(256, 256)}
    ck.save(9, t)
    t["w"].fill_(999.0)          # changed after the snapshot
    ck.wait()
    out, _ = P.restore_checkpoint(d, 9)
    assert float(out["w"].abs().max()) == 0.0


def test_manager_saves_every_n(tmp_path):
    mgr = P.CheckpointManager(str(tmp_path), every=5, keep=3)
    saved = [s for s in range(12) if mgr.maybe_save(s, tree(), {"step": s})]
    mgr.finish()
    assert saved == [0, 5, 10]
    _, extra = mgr.restore_latest(tree())
    assert extra == {"step": 10}


def test_manifest_and_files_match_the_references(tmp_path):
    """The same tree written by both packages: the same manifest (paths in
    the same order, shapes, dtypes, files, keys) and the same payload
    bytes."""
    src = _random_tree(0)
    jd, pd = str(tmp_path / "jax"), str(tmp_path / "torch")
    J.save_checkpoint(jd, 3, jax.tree.map(jnp.asarray, src), chunk_leaves=2)
    P.save_checkpoint(pd, 3, jax.tree.map(lambda a: tensor_from_numpy(
        a, "cpu"), src), chunk_leaves=2)
    man = [json.load(open(os.path.join(d, "step_000000003",
                                       "manifest.json"))) for d in (jd, pd)]
    assert man[0] == man[1]
    assert [leaf["path"] for leaf in man[1]["leaves"]] == [
        "opt/m/w", "opt/step", "params/embed", "params/layers/w"]
    # the payload bytes; the bf16 bits are stored as void (V2) by the
    # reference and as uint16 by the port, which both packages decode
    for leaf in man[1]["leaves"]:
        arrs = [np.load(os.path.join(d, "step_000000003", leaf["file"])
                        )[leaf["key"]] for d in (jd, pd)]
        assert _bits(arrs[0])[:2] == _bits(arrs[1])[:2]
        assert arrs[1].dtype == (np.uint16 if leaf["dtype"] == "bfloat16"
                                 else arrs[0].dtype)


def test_checkpoints_cross_both_ways_bit_for_bit(tmp_path):
    src = _random_tree(1)
    # JAX package -> port
    jd = str(tmp_path / "from_jax")
    J.save_checkpoint(jd, 5, jax.tree.map(jnp.asarray, src), {"step": 5})
    target = jax.tree.map(lambda a: torch.zeros(
        a.shape, dtype=tensor_from_numpy(a, "cpu").dtype), src)
    got, extra = P.restore_checkpoint(jd, target=target)
    assert extra == {"step": 5}
    for (path, t), (_, a) in zip(tree_flatten_with_paths(got),
                                 tree_flatten_with_paths(src)):
        assert _bits(tensor_to_numpy(t)) == _bits(a), path
    # port -> JAX package
    pd = str(tmp_path / "from_torch")
    P.save_checkpoint(pd, 6, got, {"step": 6})
    back, extra = J.restore_checkpoint(
        pd, target=jax.tree.map(jnp.asarray, src))
    assert extra == {"step": 6}
    for (path, b), (_, a) in zip(
            tree_flatten_with_paths(jax.device_get(back)),
            tree_flatten_with_paths(src)):
        assert _bits(b) == _bits(a), path
