"""CPU tests of the benchmark's harness: everything ``BENCHMARK.json``
names is found by name, the result's last line has its keys, the run
refuses a machine without a card and a checkout without the port, and
nothing the benchmark runs loads JAX or the JAX package."""
import ast
import io
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from portbench import compare, harness

ROOT = harness.ROOT
BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
MODULES = sorted(
    os.path.relpath(os.path.join(d, f), ROOT)[:-3].replace(os.sep, ".")
    for d, _, files in os.walk(harness.HERE) for f in files
    if f.endswith(".py") and "." not in f[:-3]
    and not f.startswith(("test_", "conftest")))


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files_by_name(workload):
    cell = harness.cell(BENCH, workload)
    assert cell["config"]["name"] == cell["workload"]["config"]
    assert harness.driver(cell["traffic"]["kind"]).run
    assert {m["name"] for m in cell["end_to_end"]} == {
        "train_tokens_per_s", "setup_s"}
    assert cell["per_layer"], workload
    for m in cell["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
    limits = json.load(open(os.path.join(
        harness.HERE, "limits", f"{workload}.json")))["limits"]
    assert set(limits) <= set(compare.NUMBERS)


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/configs/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]}
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


def test_the_feed_is_the_seeds_and_every_step_its_own():
    from portbench.traffic.train import tokens_at
    mix = {"batch": 2, "seq": 64, "zipf_a": 1.3}
    for seed in (0, 2 ** 31 + 11, -5, 3 ** 45):
        a, b = tokens_at(mix, 1000, seed, 0), tokens_at(mix, 1000, seed, 1)
        assert a.shape == (2, 64) and a.dtype == np.int32
        assert np.array_equal(a, tokens_at(mix, 1000, seed, 0))
        assert not np.array_equal(a, b)
        assert a.min() >= 1 and a.max() <= 998


def test_the_last_line_has_the_contracts_keys(tiny_cell):
    import torch
    from portbench import run
    from portbench.traffic import train
    cell = tiny_cell("granite-20b.train-s8k")
    result = train.run(cell, 2 ** 31 + 3, 0.2, False, "cpu", 0.0)
    out, err = io.StringIO(), io.StringIO()
    real, harness.emit = harness.emit, (
        lambda line, checks: real(line, checks, out, err))
    try:
        run.report(cell, result, False, torch)
    finally:
        harness.emit = real
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert list(line)[-1] == "limits"
    assert set(line["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert {"platform", "kind", "count",
            "memory_peak_bytes"} <= set(line["device"])
    assert err.getvalue().strip().splitlines()[-1].startswith(
        compare.NUMBERS[-1] + " ")


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "granite-20b.train-s8k", "--seed", "1", "--seconds", "1", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_without_a_card_the_run_fails_and_prints_no_result():
    p = _run(ROOT)
    assert p.returncode != 0 and p.stdout == "", (p.returncode, p.stdout)


def test_a_checkout_of_the_benchmark_alone_fails_and_prints_no_result(
        tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout == "", (p.returncode, p.stdout)


@pytest.mark.parametrize("module", MODULES)
def test_importing_a_benchmark_module_loads_no_jax(module):
    code = ("import sys; sys.path[:0] = [{root!r}, {src!r}]; "
            "import {m}; print(sorted({{n.split('.')[0] for n in "
            "sys.modules}} & {{'jax', 'jaxlib', 'flax', 'repro', "
            "'repro_torch'}}))"
            ).format(root=ROOT, src=os.path.join(ROOT, "src"), m=module)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env={k: v for k, v in os.environ.items()
                            if k != "PYTHONPATH"})
    assert p.returncode == 0, p.stderr
    loaded = set(json.loads(p.stdout.replace("'", '"')))
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}, loaded
    if module.startswith(("portbench.reference", "portbench.counts")):
        assert "repro_torch" not in loaded, loaded


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("part", ["reference", "counts"])
def test_the_reference_and_the_counts_import_nothing_of_the_program(part):
    root = os.path.join(harness.HERE, part)
    for f in os.listdir(root):
        if f.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(root, f))}
            assert not tops & {"repro_torch", "repro", "jax", "jaxlib",
                               "flax"}, (f, tops)
