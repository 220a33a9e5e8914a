"""The port's examples (``examples/torch_*.py``) on the CPU against the
reference's (``examples/{quickstart,train_lm,serve_lm,
autoparallel_cluster}.py``).

Each reference example runs as it is (``runpy``), beside the port's with
``--device cpu``.  The language-model examples draw their parameters in
the launchers; the port's launcher is handed the reference's draw
(``repro.models.transformer.init_params`` from the same seed, carried
across with ``interop.params_from_numpy``), so both compute with the same
numbers: losses at rtol 1e-4, tokens exactly.  The training example runs
at 10 steps of 2 × 16 tokens, which still takes its crash (at step 6) and
its resume (from the step-0 checkpoint) through its arguments.
"""
import os
import re
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import transformer as PTF  # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
CPU = ["--device", "cpu"]


def _port(name):
    """The port's example module ``name``, loaded without running it."""
    return runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name=name)


def _reference_params(monkeypatch, arch):
    """Have the port's launchers draw the reference launcher's parameters
    (``init_params(cfg, PRNGKey(0))`` of the reduced config)."""
    tree = jax.device_get(JTF.init_params(jax_config(arch).reduced(),
                                          jax.random.PRNGKey(0)))
    monkeypatch.setattr(PTF, "init_params",
                        lambda cfg, seed, device: params_from_numpy(tree,
                                                                    device))


def test_quickstart_prints_and_computes_the_references(capsys):
    want = runpy.run_path(str(EXAMPLES / "quickstart.py"),
                          run_name="__main__")
    want_out = capsys.readouterr().out
    got = _port("torch_quickstart")["main"](CPU)
    assert capsys.readouterr().out == want_out
    assert got["device"] == "cpu"
    y, z = got["outputs"]
    assert isinstance(y, torch.Tensor) and y.device.type == "cpu"
    assert [float(y), int(z)] == [want["seq"][t]
                                  for t in want["graph"].outputs]
    assert got["schedule"].makespan == want["sched"].makespan
    assert got["simulated"].makespan == want["r"].makespan


def test_train_lm_crashes_resumes_and_matches_the_reference(tmp_path,
                                                            monkeypatch):
    argv = ["--steps", "10", "--batch", "2", "--seq", "16"]
    # the reference example, run as it is: record its launcher's results
    ref_example = runpy.run_path(str(EXAMPLES / "train_lm.py"),
                                 run_name="train_lm")
    train_main, want = ref_example["train_mod"].main, []
    monkeypatch.setattr(ref_example["train_mod"], "main",
                        lambda a: want.append(train_main(a)) or want[-1])
    monkeypatch.setattr(sys, "argv", ["train_lm.py", *argv, "--ckpt",
                                      str(tmp_path / "ref")])
    try:
        ref_example["main"]()
    except AssertionError as e:
        # its 20 % loss-drop check needs the default 200 steps
        assert str(e) == "no learning?"
    _reference_params(monkeypatch, "qwen2-7b")
    example = _port("torch_train_lm")
    got = example["crash_and_resume"](example["parse"](
        argv + CPU + ["--ckpt", str(tmp_path / "port")]))
    assert len(want) == len(got) == 2
    # phase 1: steps 0-5, the crash; phase 2: resumed from the step-0
    # checkpoint, steps 1-9
    assert [len(r["losses"]) for r in got] == [6, 9]
    assert [r["start_step"] for r in got] == [0, 1] == \
        [r["start_step"] for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["losses"], w["losses"], rtol=1e-4)
    assert got[1]["device"] == "cpu"


def test_serve_lm_gives_the_references_tokens(monkeypatch):
    want = runpy.run_path(str(EXAMPLES / "serve_lm.py"),
                          run_name="__main__")["out"]
    _reference_params(monkeypatch, "yi-9b")
    got = _port("torch_serve_lm")["main"](CPU)
    assert got["decode_steps"] == want["decode_steps"] > 0
    assert {r.rid: r.out for r in got["finished"]} == \
        {r.rid: r.out for r in want["finished"]}
    assert len(got["finished"]) == 8 and got["device"] == "cpu"


def _stages(out):
    """The printed lines of each numbered stage, by stage number."""
    stages, cur = {}, None
    for text in out.splitlines():
        m = re.match(r"(\d)\) ", text)
        if m:
            cur = int(m.group(1))
        if cur is not None and text.strip():
            stages.setdefault(cur, []).append(text)
    return stages


def test_autoparallel_cluster_prints_the_references_stages(capsys):
    """Stages 1-3 (trace, simulated cluster, simulated faults) print the
    reference's lines exactly; stage 4 (the real cluster with a SIGKILL and
    a join) its counts; stage 5 (the DAG on an 8-device mesh: 8 gloo ranks
    here, 8 forced host devices there) the same mesh and the same number of
    collectives, counted by launch.costs.Counter where the reference counts its
    partitioned HLO's."""
    env = dict(os.environ, PYTHONPATH=str(EXAMPLES.parent / "src"))
    ref = subprocess.run([sys.executable,
                          str(EXAMPLES / "autoparallel_cluster.py")],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert ref.returncode == 0, ref.stderr[-2000:]
    got = _port("torch_autoparallel_cluster")["main"](CPU)
    want, mine = _stages(ref.stdout), _stages(capsys.readouterr().out)
    assert [mine[i] for i in (1, 2, 3)] == [want[i] for i in (1, 2, 3)]
    assert mine[4][:2] == want[4][:2] and mine[5][0] == want[5][0]
    counts = r"failures (\d+) \(recomputed (\d+) = lineage plan \[(\d+)\]\) " \
        r"\| joins (\d+)"
    assert re.search(counts, mine[4][2]).groups() == \
        re.search(counts, want[4][2]).groups()
    assert mine[4][2].endswith("matches sequential oracle ✓")
    spmd = r"SPMD lowering on .*'data': (\d+), 'model': (\d+).*: output " \
        r"matches sequential; (\d+) collectives"
    assert re.search(spmd, mine[5][1]).groups() == \
        re.search(spmd, want[5][1]).groups() == ("4", "2", "4")
    assert mine[5][-1] == want[5][-1] == "all stages OK  ✓"
    assert got["device"] == "cpu" and got["cluster_stats"]["failures"] == 1


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_serve_lm",
                                  "torch_train_lm",
                                  "torch_autoparallel_cluster"])
def test_examples_need_a_card_unless_the_cpu_is_named(name, monkeypatch,
                                                      tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _port(name)["main"](["--steps", "2", "--ckpt", str(tmp_path)]
                            if "train" in name else [])
