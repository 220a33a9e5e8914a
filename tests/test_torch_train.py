"""The port's training half against the JAX package: the rule tables, the
one-device mesh, loss and gradients, a train-step trajectory, the remat
modes, bf16 cotangents and the training launcher.

Parameters come from ``repro.models.transformer.init_params`` on the
reduced configs (float32 params and compute) and cross through
``interop.params_from_numpy``; batches are the data pipeline's (the same
numpy draw in both packages).  Gradients are held to 2e-5 of each leaf's
largest magnitude (float32 on both sides, differing only in summation
order; measured under 2e-6); losses over steps to ``rtol 1e-4``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import placement as JPL  # noqa: E402
from repro.launch import steps as JST  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro.optim.schedules import cosine_schedule as jax_cosine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import placement as PL  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMDataset  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import flash_attention as pt_flash  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import transformer as PTF  # noqa: E402
from repro_torch.optim.schedules import cosine_schedule  # noqa: E402
from repro_torch.parallel import (ShardingCtx, make_mesh_for,  # noqa: E402
                                  single_device_mesh)
from repro_torch.tree import tree_flatten_with_paths, tree_leaves  # noqa: E402

GRAD_TOL = 2e-5
CPU = ["--device", "cpu"]


def _setup(arch, seed=0, **overrides):
    jcfg = dataclasses.replace(jax_config(arch).reduced(), **overrides)
    cfg = dataclasses.replace(get_config(arch).reduced(), **overrides)
    jparams = JTF.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, cfg, jparams, params_from_numpy(jax.device_get(jparams),
                                                 "cpu")


def _batch(cfg, step=0, seq=16, batch=2):
    b = SyntheticLMDataset(cfg.vocab_size, seq, batch, seed=1).batch_at(step)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _assert_grads_close(got, want):
    want = dict(tree_flatten_with_paths(jax.device_get(want)))
    got = tree_flatten_with_paths(got)
    assert sorted(p for p, _ in got) == sorted(want)
    for path, g in got:
        w = np.asarray(want[path])
        err = np.abs(g.numpy() - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= GRAD_TOL, (path, err)


@pytest.mark.parametrize("mode", ["dp", "dp_tp", "fsdp_tp", "dp_tp_ep",
                                  "dp_tp_kvseq", "fsdp_tp_sp"])
@pytest.mark.parametrize("pod", [None, "pod"])
def test_rule_tables_are_the_references(mode, pod):
    rules = PL.standard_rules(mode, pod_axis=pod)
    assert rules == JPL.standard_rules(mode, pod_axis=pod)
    for axes in [("batch", "seq", "heads", None), ("embed", "d_ff"),
                 ("layers", "embed", "vocab"), ("seq", "heads", "kv_seq"),
                 ("expert_group", "experts", "embed", "d_ff"), ()]:
        want = tuple(JPL.logical_to_spec(axes, rules))
        assert PL.logical_to_spec(axes, rules) == want
        assert PL.logical_to_spec(axes, rules, ("data", "model")) == \
            tuple(p for p in _drop_axes(want, ("data", "model")))


def _drop_axes(spec, keep):
    """A spec with the mesh axes outside ``keep`` dropped, trailing Nones
    cut, as the reference's logical_to_spec does given a mesh."""
    out = []
    for part in spec:
        axes = (part,) if isinstance(part, str) else (part or ())
        axes = tuple(a for a in axes if a in keep)
        out.append(None if not axes else axes[0] if len(axes) == 1 else axes)
    while out and out[-1] is None:
        out.pop()
    return out


def test_one_device_mesh_and_identity_constraint():
    mesh = single_device_mesh("cpu")
    assert mesh.axis_names == ("data", "model") and mesh.sizes == (1, 1)
    assert make_mesh_for(1, device="cpu") == mesh
    ctx = ShardingCtx.make(mesh)
    assert ctx.spec(("batch", "seq", "heads")) == ("data", None, "model")
    x = torch.ones(2, 3)
    assert ctx.constrain(x, ("batch", None)) is x
    # a world of one (none initialised) is too small, as in the reference
    with pytest.raises(ValueError, match="need 4 devices for mesh"):
        make_mesh_for(4)


# the Mamba1 path, and the dense path's configurations: qwen2-7b (GQA with
# qkv biases), granite-20b (MQA, one kv head, with the 2-matrix gelu MLP),
# qwen3-14b (per-head RMS qk_norm) and yi-9b (GQA at rope theta 5e6)
TRAIN_ARCHS = ["qwen2-7b", "falcon-mamba-7b", "granite-20b", "qwen3-14b",
               "yi-9b"]


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_loss_and_grads_match_the_references(arch):
    jcfg, cfg, jparams, params = _setup(arch)
    jb, pb = _batch(cfg)
    (jtotal, jm), jgrads = jax.value_and_grad(
        JTF.make_loss_fn(jcfg), has_aux=True)(jparams, jb)
    (total, m), grads = PTF.value_and_grad(PTF.make_loss_fn(cfg))(params, pb)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert not any(p.requires_grad for p in tree_leaves(params))
    _assert_grads_close(grads, jgrads)


def _three_steps(arch, move=0):
    """launch/steps.py's train step with make_optimizer's AdamW (weight
    decay 0.1, clipping, a cosine schedule) for three steps on three
    batches in both packages, from the reference's draw (with ``move`` 1
    or -1, the reference's parameters moved one ulp up or down first): the
    reference's losses and parameters after, then the port's."""
    jcfg, cfg, jparams, params = _setup(arch, seed=2)
    if move:
        jparams = jax.tree.map(
            lambda x: jnp.nextafter(x, move * jnp.inf), jparams)
    jopt = JST.make_optimizer(jcfg, lr=jax_cosine(1e-2, 1, 3))
    opt = ST.make_optimizer(cfg, lr=cosine_schedule(1e-2, 1, 3))
    jstep = jax.jit(JST.make_train_step(jcfg, jopt, None))
    step = ST.make_train_step(cfg, opt)
    jstate, state = jopt.init(jparams), opt.init(params)
    jlosses, losses = [], []
    for s in range(3):
        jb, pb = _batch(cfg, step=s)
        jparams, jstate, jm = jstep(jparams, jstate, jb)
        params, state, m = step(params, state, pb)
        jlosses.append(float(jm["total_loss"]))
        losses.append(float(m["total_loss"]))
    assert int(state["step"]) == 3
    return (jlosses, dict(tree_flatten_with_paths(jax.device_get(jparams))),
            losses, tree_flatten_with_paths(params))


@pytest.mark.parametrize("arch", ["qwen2-7b", "falcon-mamba-7b",
                                  "granite-20b", "yi-9b"])
def test_three_train_steps_match_the_references(arch):
    """Three train steps: the losses at rtol 1e-4, the parameters after."""
    jlosses, want, losses, params = _three_steps(arch)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    # Adam divides by sqrt(v): where a gradient entry is near 0, a
    # rounding-level difference in it moves that entry's step by up to a
    # fraction of lr (1e-2); such entries are a few in 10^4.  The key bias
    # is all such entries: its gradient is 0 in exact arithmetic (q·bk
    # shifts every key's score alike, which the softmax ignores), so its
    # steps follow rounding noise in either package and are not compared.
    for path, p in params:
        if path.endswith("/bk"):
            continue
        diff = np.abs(p.numpy() - want[path])
        assert diff.max() < 1e-3 and np.mean(diff > 1e-5) < 1e-3, path


def test_qwen3_three_train_steps_stay_within_the_references_own_spread():
    """qwen3-14b (per-head RMS qk_norm) through the same three steps.  Its
    steps amplify rounding about ten times more than qwen2-7b's: the
    reference against itself, its parameters moved one ulp up, leaves
    mixer/wo up to 1.7e-3 apart and 0.31 % of mixer/wq more than 1e-5
    apart, past both of the test above's limits on the parameters, which
    no float32 implementation that rounds otherwise can meet here (the
    port's first gradients are as close to the reference's as qwen2-7b's,
    within 1e-6 of each leaf's largest).  So the losses are held to rtol
    1e-4 as above, and each parameter leaf after to the reference's own
    spread on that leaf, measured here over the pairs of its three runs
    (its draw, and the draw moved one ulp up and one down): the port's
    share of the leaf more than 1e-5 apart at most the largest of those
    pairs' shares, and its largest difference at most the largest of
    theirs or the test above's 1e-3, whichever is larger (a leaf's largest
    difference is one entry whose gradient is near 0, where Adam's step
    follows rounding, as the test above says)."""
    jlosses, want, losses, params = _three_steps("qwen3-14b")
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    up, down = (_three_steps("qwen3-14b", move)[1] for move in (1, -1))
    for path, p in params:
        spread = [np.abs(a[path] - b[path])
                  for a, b in ((up, want), (down, want), (up, down))]
        diff = np.abs(p.numpy() - want[path])
        assert diff.max() <= max(1e-3, *(d.max() for d in spread)), path
        assert np.mean(diff > 1e-5) <= \
            max(np.mean(d > 1e-5) for d in spread), path


def test_remat_modes_give_the_same_gradients(monkeypatch):
    """none, selective and full give the same loss and gradients; with
    impl="kernel" the flash Function's forward runs once a layer without
    remat and twice (forward and recompute) under either remat mode."""
    runs = {}
    calls = []
    forward = pt_flash.FlashAttention.forward

    def counted(ctx, *args):
        calls.append(1)
        return forward(ctx, *args)
    monkeypatch.setattr(pt_flash.FlashAttention, "forward",
                        staticmethod(counted))
    for remat in ("none", "selective", "full"):
        _, cfg, _, params = _setup("qwen2-7b", remat=remat)
        calls.clear()
        (total, _), grads = PTF.value_and_grad(PTF.make_loss_fn(cfg))(
            params, _batch(cfg)[1])
        runs[remat] = (total, grads, len(calls))
    assert runs["none"][2] == cfg.n_layers
    assert runs["selective"][2] == runs["full"][2] == 2 * cfg.n_layers
    for remat in ("selective", "full"):
        assert float(runs[remat][0]) == float(runs["none"][0])
        for (path, a), (_, b) in zip(tree_flatten_with_paths(runs[remat][1]),
                                     tree_flatten_with_paths(runs["none"][1])):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7,
                                       msg=f"{remat} {path}")


def test_ref_impl_gives_the_kernel_impls_gradients():
    _, cfg, _, params = _setup("qwen2-7b")
    pb = _batch(cfg)[1]
    out = {impl: PTF.value_and_grad(PTF.make_loss_fn(cfg, impl=impl))(
        params, pb) for impl in ("kernel", "ref")}
    assert float(out["kernel"][0][0]) == float(out["ref"][0][0])
    for a, b in zip(tree_leaves(out["kernel"][1]), tree_leaves(out["ref"][1])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_bf16_cotangents_match_the_references():
    rng = np.random.default_rng(5)
    logits = 4 * rng.standard_normal((2, 9, 512), dtype=np.float32)
    labels = rng.integers(0, 512, (2, 9)).astype(np.int32)
    jg = jax.grad(lambda z: JTF._xent_with_bwd_dtype("bfloat16")(
        z, jnp.asarray(labels)))(jnp.asarray(logits))
    z = torch.from_numpy(logits).requires_grad_()
    loss = PTF.xent_with_bwd_dtype(z, torch.from_numpy(labels),
                                   torch.bfloat16)
    (g,) = torch.autograd.grad(loss, z)
    np.testing.assert_allclose(float(loss.detach()), float(JTF.softmax_xent(
        jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-6)
    want = np.asarray(jg, np.float32)
    # bf16 values: each entry is a bf16 number, the reference's
    assert torch.equal(g.to(torch.bfloat16).float(), g)
    np.testing.assert_array_equal(g.numpy(), want)


def test_launcher_checkpoint_resume_exact(tmp_path):
    """tests/test_launchers.py's resume check through the port's launcher:
    8 steps with a checkpoint every 5, an uninterrupted run to 12 in its own
    directory, and a run resumed from step 5 that replays 6..11."""
    ck = str(tmp_path / "ck")
    base = ["--arch", "qwen2-7b", "--reduced", "--batch", "2", "--seq", "16",
            "--ckpt-every", "5", "--log-every", "100"] + CPU
    r1 = train_mod.main(base + ["--ckpt-dir", ck, "--steps", "8"])
    assert len(r1["losses"]) == 8 and np.isfinite(r1["losses"]).all()
    r_full = train_mod.main(base + ["--ckpt-dir", str(tmp_path / "ref"),
                                    "--steps", "12"])
    # it learns: the last four steps' mean below the first four's
    assert np.mean(r_full["losses"][-4:]) < np.mean(r_full["losses"][:4])
    np.testing.assert_allclose(r1["losses"], r_full["losses"][:8],
                               rtol=1e-4, atol=1e-5)
    r2 = train_mod.main(base + ["--ckpt-dir", ck, "--steps", "12",
                                "--resume"])
    assert r2["start_step"] == 6
    np.testing.assert_allclose(r2["losses"], r_full["losses"][6:12],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("backend", ["thread", "process"])
def test_launcher_show_graph_executes_on_backend(capsys, backend):
    """The traced-step loss equals the main loop's step-0 loss (same
    recipe, seed and batch); on the process backend the step runs in a
    worker that rebuilt the runtime from the recipe."""
    r = train_mod.main(["--arch", "qwen2-7b", "--reduced", "--steps", "1",
                        "--batch", "2", "--seq", "16", "--log-every", "100",
                        "--show-graph", "--backend", backend] + CPU)
    out = capsys.readouterr().out
    assert f"[{backend} backend" in out and "executed 4 tasks" in out
    traced = float(out.split("traced-driver step loss:")[1].split()[0])
    assert traced == pytest.approx(r["losses"][0], rel=1e-4)


def test_launcher_refuses_what_it_cannot_train(monkeypatch):
    # the encoder-decoder and the VLM train since their port
    # (tests/test_torch_encdec.py, tests/test_torch_vlm.py hold their
    # losses to the JAX launcher's): one step of each; --tp 2 without a
    # world raises (tests/test_torch_tp.py trains at --tp 2 in a world)
    for arch in ("whisper-tiny", "llava-next-34b"):
        r = train_mod.main(["--arch", arch, "--reduced", "--steps", "1",
                            "--batch", "2", "--seq", "16"] + CPU)
        assert len(r["losses"]) == 1 and np.isfinite(r["losses"]).all()
    with pytest.raises(ValueError, match="world of size 0.*spawn_world"):
        train_mod.main(["--arch", "qwen2-7b", "--reduced", "--tp", "2"] + CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_mod.main(["--arch", "qwen2-7b", "--reduced", "--steps", "1"])


_SPAWN_MAIN = r"""
import runpy, sys
import torch
torch.cuda.is_initialized = lambda: True   # as on the card: workers spawn
sys.argv = ["train", "--arch", "qwen2-7b", "--reduced", "--device", "cpu",
            "--steps", "1", "--batch", "2", "--seq", "16", "--show-graph",
            "--backend", "process", "--graph-workers", "1",
            "--log-every", "1"]
runpy.run_module("repro_torch.launch.train", run_name="__main__",
                 alter_sys=True)
"""


def test_launcher_run_as_main_ships_its_recipe_to_spawned_workers(tmp_path):
    """Run as ``python -m``, the launcher's module is ``__main__``; the
    traced tasks must still pickle by their importable name, so a spawned
    worker (the card's start method) can load them."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    script = tmp_path / "spawn_main.py"
    script.write_text(_SPAWN_MAIN)
    src = Path(__file__).resolve().parents[1] / "src"
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=str(src)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert "[process backend" in out
    traced = float(out.split("traced-driver step loss:")[1].split()[0])
    step0 = float(out.split("step     0 loss")[1].split()[0])
    assert traced == pytest.approx(step0, rel=1e-4)
