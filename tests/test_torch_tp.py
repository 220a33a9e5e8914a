"""Tensor parallelism in the port's launchers on a world of 4 gloo ranks,
against the port's one-device launchers and the JAX package's launchers.

One world runs every multi-rank case once (a module-scoped fixture): 4
spawned processes, each a rank (``parallel.mesh.spawn_world``), meeting
through a file store under ``tmp_path``, one thread each, and killed
together if they have not ended within WORLD_TIMEOUT_S.  Each rank runs
``repro_torch.launch.train.main`` / ``serve.main`` with ``--tp`` (the
launchers join the world the caller initialised) and writes a report; rank
0 also writes the full values of the parameters after the steps (and of
the gradients) as numpy files.  The tests below assert on every rank's
report.  The ranks import only the port; the JAX package's parameter draws
(qwen2-7b and falcon-mamba-7b reduced, seed 0) are handed over as numpy
files, and the references are computed here while the world runs: the
port's one-device launcher on the same parameters and the JAX launcher.

- training, 3 steps of batch 4 x 16 (reduced float32 configs, the
  launcher's AdamW and cosine schedule): every family at ``--tp 2``
  (a (2, 2) (data, model) mesh under ``fsdp_tp``; llama4-maverick's
  interleaved MoE through Adafactor, whose factored state follows the
  parameters' shards), qwen2-7b also with ``shard_grads`` and with
  ``--remat none``, and at ``--tp 4`` (a (1, 4) mesh: its 2 kv heads do
  not split 4 ways); the losses at rtol 1e-4 of
  the one-device launcher's, the parameters after the steps at rtol 1e-4,
  atol 1e-5; qwen2-7b and falcon-mamba-7b also at rtol 1e-4 of the JAX
  launcher's losses;
- falcon-mamba-7b's gradients leaf by leaf at ``--tp 2`` against one
  device's at rtol 1e-5, atol 1e-6: the scan's ``B``, ``C`` and ``A``
  gradients are sums over channels or batch rows that each rank holds a
  share of (``Partial``);
- serving qwen2-7b and falcon-mamba-7b at ``--tp 2`` (the ``dp_tp``
  rules): the default traffic's tokens equal the one-device launcher's;
- elastic resume: qwen2-7b at ``--tp 2`` with a checkpoint every step,
  its step-1 checkpoint resumed at ``--tp 4`` in the same world and on one
  device here; the remaining losses equal the uninterrupted run's;
- ``--tp 3`` in the world of 4 and ``--tp 2`` without a world raise
  ``ValueError``; the flash and scan wrappers (their plain versions on the
  CPU) are called through ``kernels/sharded.py`` on each rank's local
  shapes: H / T heads where T divides the kv heads, the scan on d_inner /
  T channels.
"""
import json
import os
import shutil
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMDataset  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import transformer as PTF  # noqa: E402
from repro_torch.parallel.mesh import spawn_world  # noqa: E402
from repro_torch.tree import tree_flatten_with_paths  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD, WORLD_TIMEOUT_S = 4, 420.0
TRAIN_ARGV = ["--reduced", "--device", "cpu", "--steps", "3", "--batch", "4",
              "--seq", "16", "--log-every", "100"]
# name: (arch, --tp, extra argv, variant); variant "jax" trains the JAX
# package's draw, "shard_grads" sets cfg.shard_grads, "hybrid" builds
# zamba2 with a shared-attention site after every 2nd of 4 layers
TRAIN_CASES = {
    "qwen2_tp2": ("qwen2-7b", 2, [], "jax"),
    "qwen2_tp2_shard_grads": ("qwen2-7b", 2, [], "jax+shard_grads"),
    "qwen2_tp2_remat_none": ("qwen2-7b", 2, ["--remat", "none"], "jax"),
    "qwen2_tp4": ("qwen2-7b", 4, [], "jax"),
    "falcon_mamba_tp2": ("falcon-mamba-7b", 2, [], "jax"),
    "dbrx_tp2": ("dbrx-132b", 2, [], ""),
    "llama4_maverick_tp2": ("llama4-maverick-400b-a17b", 2, [], ""),
    "whisper_tp2": ("whisper-tiny", 2, [], ""),
    "zamba2_hybrid_tp2": ("zamba2-7b", 2, [], "hybrid"),
    "llava_tp2": ("llava-next-34b", 2, [], ""),
}
SERVE_CASES = {"serve_qwen2_tp2": "qwen2-7b",
               "serve_falcon_mamba_tp2": "falcon-mamba-7b"}
JAX_ARCHS = ("qwen2-7b", "falcon-mamba-7b")
RESUME_STEPS, RESUME_FROM = 4, 1

# shared by the ranks and the references here: how a case's config and
# parameters are made
_SETUP = r'''
import dataclasses
import numpy as np
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.launch import train as train_mod
from repro_torch.models import model_module
from repro_torch.models import transformer as PTF


def tree_from(npz):
    """A parameter tree from a numpy file keyed by leaf paths."""
    tree = {}
    for key in npz.files:
        node = tree
        *path, leaf = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = npz[key]
    return tree


def setup(work, arch, variant):
    """Patch the launcher for a case: the config (``shard_grads``, the
    zamba2 hybrid) and, for ``jax``, the JAX package's parameter draw."""
    def config(arch_, reduced, remat):
        cfg = get_config(arch_)
        cfg = (cfg.reduced(n_layers=4, shared_attn_every=2)
               if "hybrid" in variant else cfg.reduced())
        cfg = dataclasses.replace(cfg, remat=remat,
                                  shard_grads="shard_grads" in variant)
        model_module(cfg).check_supported(cfg)
        return cfg
    train_mod._config = config
    if "jax" in variant:
        tree = tree_from(np.load(work / f"jax_{arch}.npz"))
        PTF.init_params = lambda cfg, seed, device: params_from_numpy(
            tree, device)
'''

_RANK_SCRIPT = _SETUP + r'''
import json, shutil, sys, time, traceback
from pathlib import Path
import torch
torch.set_num_threads(1)
from repro_torch.parallel.mesh import destroy_world, init_world

WORK = Path(sys.argv[1])
init_world(device="cpu")
import torch.distributed as dist
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import sharded
from repro_torch.kernels import ssm_scan as sc
from repro_torch.launch import serve as serve_mod
from repro_torch.parallel.sharding import full_value
from repro_torch.tree import tree_flatten_with_paths

RANK = dist.get_rank()
CASES = json.loads(sys.argv[2])
TRAIN_ARGV = CASES["argv"]
report = {}
ORIG = (train_mod._config, PTF.init_params)

# the wrappers' calls with their local shapes (their plain versions run on
# the CPU): what ops hands each kernel on this rank
SEEN = {"flash": set(), "scan": set()}


def _recording(mod, name, key, shapes):
    real = getattr(mod, name)

    def wrapper(*args, **kwargs):
        SEEN[key].add(shapes(*args))
        return real(*args, **kwargs)
    setattr(mod, name, wrapper)


_recording(fa, "flash_attention", "flash",
           lambda q, k, v, **_: (tuple(q.shape), tuple(k.shape)))
_recording(sc, "ssm_scan", "scan",
           lambda x, dt, B, *_, **__: (tuple(x.shape), tuple(B.shape)))


def check(fn):
    t0 = time.perf_counter()
    try:
        report[fn.__name__] = fn()
    except Exception:
        report[fn.__name__] = {"ok": False, "error": traceback.format_exc()}
    report[fn.__name__]["seconds"] = time.perf_counter() - t0
    train_mod._config, PTF.init_params = ORIG
    dist.barrier()     # a rank that failed a check still meets the others
    return fn


def digest(tree):
    """Each leaf's float64 sum and largest magnitude: the same on every
    rank when every rank holds the same full values."""
    return {p: [float(v.double().sum()), float(v.abs().max())]
            for p, v in tree}


def full(tree):
    return [(p, full_value(v).detach().float())
            for p, v in tree_flatten_with_paths(tree)]


def save(name, leaves):
    if RANK == 0:
        np.savez(WORK / f"{name}.npz", **{p: v.numpy() for p, v in leaves})


def train_case(name):
    """One training case: its losses, rank 0's full parameters after the
    steps, their digest, and the wrappers' local shapes."""
    arch, tp, extra, variant = CASES["train"][name]
    setup(WORK, arch, variant)
    for k in SEEN:
        SEEN[k].clear()
    calls = dict(sharded.local_calls)
    r = train_mod.main(["--arch", arch, "--tp", str(tp)] + TRAIN_ARGV
                       + extra)
    leaves = full(r["params"])
    save(name, leaves)
    through = {k: sharded.local_calls[k] - calls[k] for k in calls}
    return {"ok": True, "losses": r["losses"], "digest": digest(leaves),
            "flash_shapes": sorted(SEEN["flash"]),
            "scan_shapes": sorted(SEEN["scan"]), "through_sharded": through,
            "dtensor_params": all(type(v).__name__ == "DTensor" for _, v in
                                  tree_flatten_with_paths(r["params"]))}


for _name in CASES["train"]:
    def _train(name=_name):
        return train_case(name)
    _train.__name__ = _name
    check(_train)


@check
def falcon_mamba_grads():
    from repro_torch.core.placement import standard_rules
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.launch.steps import BATCH_AXES
    from repro_torch.parallel.mesh import launcher_mesh
    from repro_torch.parallel.sharding import ShardingCtx, distribute_params
    cfg = get_config("falcon-mamba-7b").reduced()
    tree = tree_from(np.load(WORK / "jax_falcon-mamba-7b.npz"))
    ctx = ShardingCtx(launcher_mesh(2, "cpu"),
                      standard_rules("fsdp_tp", pod_axis=None))
    params = distribute_params(params_from_numpy(tree, "cpu"),
                               PTF.logical_axes(cfg), ctx)
    batch = {k: ctx.fit(torch.from_numpy(v), BATCH_AXES[k])
             for k, v in SyntheticLMDataset(cfg.vocab_size, 16, 4, seed=0)
             .batch_at(0).items()}
    (total, _), grads = PTF.value_and_grad(PTF.make_loss_fn(cfg, ctx))(
        params, batch)
    leaves = full(grads)
    save("falcon_mamba_grads", leaves)
    return {"ok": True, "loss": float(total), "digest": digest(leaves)}


for _name, _arch in CASES["serve"].items():
    def _serve(arch=_arch):
        r = serve_mod.main(["--arch", arch, "--reduced", "--device", "cpu",
                            "--tp", "2"])
        return {"ok": True, "tokens": {str(q.rid): q.out
                                       for q in r["finished"]}}
    _serve.__name__ = _name
    check(_serve)


@check
def elastic_resume():
    """--tp 2 with a checkpoint every step; its step-1 checkpoint copied
    out (rank 0) and resumed at --tp 4."""
    setup(WORK, "qwen2-7b", "jax")
    argv = ["--arch", "qwen2-7b", "--tp", "2", "--reduced", "--device",
            "cpu", "--steps", str(CASES["resume"][0]), "--batch", "4",
            "--seq", "16", "--log-every", "100"]
    full_run = train_mod.main(argv + ["--ckpt-dir", str(WORK / "ckpt"),
                                      "--ckpt-every", "1"])
    name = f"step_{CASES['resume'][1]:09d}"
    if RANK == 0:
        shutil.copytree(WORK / "ckpt" / name, WORK / "resume" / name)
    dist.barrier()
    argv[argv.index("--tp") + 1] = "4"
    resumed = train_mod.main(argv + ["--ckpt-dir", str(WORK / "resume"),
                                     "--ckpt-every", "100", "--resume"])
    return {"ok": resumed["start_step"] == CASES["resume"][1] + 1,
            "losses": full_run["losses"], "resumed": resumed["losses"]}


@check
def refuses_tp3():
    try:
        train_mod.main(["--arch", "qwen2-7b", "--tp", "3"] + TRAIN_ARGV)
    except ValueError as e:
        return {"ok": "world of 4" in str(e), "error": str(e)}
    return {"ok": False}


@check
def no_jax():
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax",
                                                               "repro"))
    return {"ok": not bad, "loaded": bad}


(WORK / f"report{RANK}.json").write_text(json.dumps(report))
destroy_world()
'''

exec(compile(_SETUP, "<setup>", "exec"))   # setup() and tree_from() here


def _jax_draw(work: Path, arch: str) -> dict:
    """The JAX package's reduced draw of ``arch`` from seed 0, saved for
    the ranks; returns it as a numpy tree."""
    cfg = jax_config(arch).reduced()
    tree = jax.device_get(JTF.init_params(cfg, jax.random.PRNGKey(0)))
    np.savez(work / f"jax_{arch}.npz", **dict(tree_flatten_with_paths(tree)))
    return tree


def _one_device(work: Path, arch: str, variant: str, argv: list) -> dict:
    """The port's one-device launcher on a case's config and parameters."""
    saved = (train_mod._config, PTF.init_params)
    try:
        setup(work, arch, variant)
        return train_mod.main(["--arch", arch] + argv)
    finally:
        train_mod._config, PTF.init_params = saved


def _grads_one_device(work: Path) -> dict:
    cfg = get_config("falcon-mamba-7b").reduced()
    tree = tree_from(np.load(work / "jax_falcon-mamba-7b.npz"))
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLMDataset(
        cfg.vocab_size, 16, 4, seed=0).batch_at(0).items()}
    (total, _), grads = PTF.value_and_grad(PTF.make_loss_fn(cfg))(
        params_from_numpy(tree, "cpu"), batch)
    return {"loss": float(total),
            "grads": {p: g.numpy() for p, g in
                      tree_flatten_with_paths(grads)}}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    work = tmp_path_factory.mktemp("tp_world")
    for arch in JAX_ARCHS:
        _jax_draw(work, arch)
    cases = {"argv": TRAIN_ARGV, "train": TRAIN_CASES, "serve": SERVE_CASES,
             "resume": [RESUME_STEPS, RESUME_FROM]}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    failure = []

    def run():
        try:
            spawn_world(["-c", _RANK_SCRIPT, str(work), json.dumps(cases)],
                        WORLD, timeout_s=WORLD_TIMEOUT_S, env=env,
                        cwd=str(ROOT), workdir=str(work))
        except Exception as e:      # raised again below, in the fixture
            failure.append(e)

    ranks = threading.Thread(target=run)
    ranks.start()
    # the references, computed here while the world runs
    ref = {"train": {}, "jax": {}, "serve": {}}
    for name, (arch, _, extra, variant) in TRAIN_CASES.items():
        r = _one_device(work, arch, variant, TRAIN_ARGV + extra)
        ref["train"][name] = {
            "losses": r["losses"],
            "params": {p: v.numpy() for p, v in
                       tree_flatten_with_paths(r["params"])}}
    for arch in JAX_ARCHS:
        ref["jax"][arch] = jax_train.main(
            ["--arch", arch] + [a for a in TRAIN_ARGV
                                if a not in ("--device", "cpu")])["losses"]
    ref["grads"] = _grads_one_device(work)
    for name, arch in SERVE_CASES.items():
        r = serve_mod.main(["--arch", arch, "--reduced", "--device", "cpu"])
        ref["serve"][name] = {str(q.rid): q.out for q in r["finished"]}
    ranks.join()
    if failure:
        raise failure[0]
    # one device resumes the world's step-1 checkpoint, copied out by rank 0
    one = work / "resume_one"
    name = f"step_{RESUME_FROM:09d}"
    shutil.copytree(work / "resume" / name, one / name)
    ref["resumed_one_device"] = _one_device(
        work, "qwen2-7b", "jax",
        ["--reduced", "--device", "cpu", "--steps", str(RESUME_STEPS),
         "--batch", "4", "--seq", "16", "--log-every", "100",
         "--ckpt-dir", str(one), "--ckpt-every", "100", "--resume"])
    reports = [json.loads((work / f"report{r}.json").read_text())
               for r in range(WORLD)]
    return {"work": work, "reports": reports, "ref": ref}


CHECKS = (list(TRAIN_CASES) + ["falcon_mamba_grads"] + list(SERVE_CASES)
          + ["elastic_resume", "refuses_tp3", "no_jax"])


@pytest.mark.parametrize("name", CHECKS)
def test_every_rank_passes(world, name):
    for rank, rep in enumerate(world["reports"]):
        assert rep[name]["ok"], (rank, rep[name])


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_training_matches_one_device(world, name):
    """The losses at rtol 1e-4 of the one-device launcher's on the same
    parameters, on every rank; the parameters after the steps (rank 0's
    full values) at rtol 1e-4, atol 1e-5, and every rank holding the same
    full values; the parameters are DTensors."""
    ref = world["ref"]["train"][name]
    reps = [r[name] for r in world["reports"]]
    for rank, rep in enumerate(reps):
        np.testing.assert_allclose(rep["losses"], ref["losses"], rtol=1e-4,
                                   err_msg=f"rank {rank}")
        assert rep["digest"] == reps[0]["digest"], rank
        assert rep["dtensor_params"], rank
    got = np.load(world["work"] / f"{name}.npz")
    assert sorted(got.files) == sorted(ref["params"])
    for path, want in ref["params"].items():
        np.testing.assert_allclose(got[path], want, rtol=1e-4, atol=1e-5,
                                   err_msg=path)


@pytest.mark.parametrize("name", ["qwen2_tp2", "falcon_mamba_tp2"])
def test_training_matches_the_jax_launcher(world, name):
    arch = TRAIN_CASES[name][0]
    for rep in world["reports"]:
        np.testing.assert_allclose(rep[name]["losses"],
                                   world["ref"]["jax"][arch], rtol=1e-4)


def test_falcon_mamba_gradients_leaf_by_leaf(world):
    """Every gradient leaf at rtol 1e-5, atol 1e-6 of one device's: a share
    of a sum over channels or batch rows dropped (a missing ``Partial`` on
    the scan's B, C or A) would show here in one step."""
    want = world["ref"]["grads"]
    got = np.load(world["work"] / "falcon_mamba_grads.npz")
    assert sorted(got.files) == sorted(want["grads"])
    for path, g in want["grads"].items():
        np.testing.assert_allclose(got[path], g, rtol=1e-5, atol=1e-6,
                                   err_msg=path)
    reps = [r["falcon_mamba_grads"] for r in world["reports"]]
    for rep in reps:
        assert rep["digest"] == reps[0]["digest"]
        assert rep["loss"] == pytest.approx(want["loss"], rel=1e-6)


def _top2_gap(arch: str, rid: str, pos: int, tokens: list) -> float:
    """The one-device logit gap between the top two tokens where request
    ``rid`` picked its ``pos``-th token: a tie-near pick, if that is where
    the world path differs."""
    cfg = get_config(arch).reduced()
    req = serve_mod.synth_requests(6, cfg.vocab_size)[int(rid)]
    seq = np.concatenate([req.prompt, np.asarray(tokens[:pos], np.int32)])
    params = PTF.init_params(cfg, 0, "cpu")
    last, _ = PTF.make_prefill_step(cfg, max_len=64)(
        params, torch.from_numpy(seq)[None])
    top = torch.topk(last[0], 2).values
    return float(top[0] - top[1])


@pytest.mark.parametrize("name", list(SERVE_CASES))
def test_served_tokens_equal_one_device(world, name):
    """The default traffic's tokens on every rank equal one device's; where
    one differs, the message gives the one-device top-two logit gap
    there."""
    want = world["ref"]["serve"][name]
    for rank, rep in enumerate(world["reports"]):
        got = rep[name]["tokens"]
        for rid, toks in want.items():
            pos = next((i for i, (a, b) in enumerate(zip(got[rid], toks))
                        if a != b), None)
            gap = (None if pos is None else
                   _top2_gap(SERVE_CASES[name], rid, pos, toks))
            assert got[rid] == toks, (rank, rid, pos, f"top-2 gap {gap}")


def test_elastic_resume_across_meshes(world):
    """The step-1 checkpoint of the --tp 2 run, resumed at --tp 4 in the
    world and on one device here: steps 2 and 3 give the uninterrupted
    run's losses."""
    tail = slice(RESUME_FROM + 1, RESUME_STEPS)
    one = world["ref"]["resumed_one_device"]
    assert one["start_step"] == RESUME_FROM + 1
    for rep in world["reports"]:
        r = rep["elastic_resume"]
        assert len(r["losses"]) == RESUME_STEPS
        np.testing.assert_allclose(r["resumed"], r["losses"][tail],
                                   rtol=1e-4)
        np.testing.assert_allclose(one["losses"], r["losses"][tail],
                                   rtol=1e-4)


def test_kernels_run_through_sharded_on_local_shapes(world):
    """On the (2, 2) mesh each rank's flash call takes its 2 of 4 batch
    rows and 2 of 4 heads (1 of 2 kv heads); on the (1, 4) mesh the 2 kv
    heads do not split 4 ways, so the heads stay whole and only the mesh's
    (absent) batch split applies; the scan takes 2 batch rows and 128 of
    falcon-mamba's 256 channels, B and C whole on the channels.  Every
    wrapper call came through ``kernels/sharded.py``, and each backward of
    the attention and of the scan too."""
    cfg = get_config("qwen2-7b").reduced()
    H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    fm = get_config("falcon-mamba-7b").reduced()
    for rep in world["reports"]:
        tp2, tp4 = rep["qwen2_tp2"], rep["qwen2_tp4"]
        assert [tuple(map(tuple, s)) for s in tp2["flash_shapes"]] == [
            ((2, H // 2, 16, D), (2, KH // 2, 16, D))]
        assert [tuple(map(tuple, s)) for s in tp4["flash_shapes"]] == [
            ((4, H, 16, D), (4, KH, 16, D))]
        scan = rep["falcon_mamba_tp2"]
        assert [tuple(map(tuple, s)) for s in scan["scan_shapes"]] == [
            ((2, 16, fm.d_inner // 2), (2, 16, fm.ssm_state))]
        # forward and remat recompute a layer a step, a backward each
        layers, steps = cfg.n_layers, 3
        assert tp2["through_sharded"]["flash_attention"] == \
            2 * layers * steps
        assert tp2["through_sharded"]["flash_attention_backward"] == \
            layers * steps
        assert scan["through_sharded"]["ssm_scan"] == 2 * layers * steps
        assert scan["through_sharded"]["ssm_scan_backward"] == \
            layers * steps


def test_a_launcher_run_as_main_joins_the_world_its_environment_names(
        tmp_path):
    """``python -m repro_torch.launch.train --tp 2`` as the 2 ranks of
    ``spawn_world`` (``RANK``, ``WORLD_SIZE``, ``REPRO_WORLD_STORE``): the
    launcher joins that world itself, trains on the (1, 2) mesh, and only
    rank 0 prints; its losses are the one-device launcher's."""
    argv = ["--arch", "qwen2-7b", "--reduced", "--device", "cpu", "--steps",
            "2", "--batch", "2", "--seq", "16", "--log-every", "1"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = spawn_world(["-m", "repro_torch.launch.train", "--tp", "2"] + argv,
                      2, timeout_s=WORLD_TIMEOUT_S, env=env, cwd=str(ROOT),
                      workdir=str(tmp_path))
    assert out[1] == "" and "done: steps 0..1" in out[0], out
    losses = [float(line.split()[3]) for line in out[0].splitlines()
              if line.startswith("step ")]
    want = train_mod.main(argv)["losses"]
    np.testing.assert_allclose(losses, want, rtol=1e-4)


def test_tp_without_a_world_raises():
    """The reference ignores --tp on one device; the port refuses it,
    naming the world's size and how to start one."""
    for launcher in (train_mod, serve_mod):
        with pytest.raises(ValueError, match="world of size 0.*spawn_world"):
            launcher.main(["--arch", "qwen2-7b", "--reduced", "--device",
                           "cpu", "--tp", "2"])


def test_one_device_resume_takes_no_world(world):
    """The one-device run here restored the world's checkpoint onto plain
    tensors: no world, no DTensor."""
    one = world["ref"]["resumed_one_device"]
    assert all(type(v) is torch.Tensor for _, v in
               tree_flatten_with_paths(one["params"]))
