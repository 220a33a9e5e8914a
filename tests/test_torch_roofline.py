"""The port's roofline and hill-climb tools (``repro_torch.launch.roofline``,
``repro_torch.launch.hillclimb``) against the JAX package's
``benchmarks/roofline.py`` and ``benchmarks/hillclimb.py``.

``_param_counts`` and ``model_flops`` equal the reference's, as integers,
for every arch and shape; a record's three terms are the H100's
data-sheet rates applied to its counts (each dtype's FLOPs at its own
peak); the dry-run's command line writes records the roofline reads (in
a subprocess: a fake world is one a process); and the hill-climb's
``search`` picks what the reference's picks on the same workloads.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from benchmarks import roofline as ref_roofline  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.launch import costs, hillclimb, roofline  # noqa: E402
from repro_torch.models.config import SHAPES  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_and_model_flops_equal_the_references(arch):
    assert roofline._param_counts(arch) == ref_roofline._param_counts(arch)
    for shape in SHAPES:
        got = roofline.model_flops(arch, shape)
        want = ref_roofline.model_flops(arch, shape)
        assert got == want and got == int(got), (arch, shape)


def test_model_flops_sane():
    total, active = roofline._param_counts("qwen2-7b")
    assert 6e9 < total < 9e9 and total == active
    t_moe, a_moe = roofline._param_counts("dbrx-132b")
    assert 1.2e11 < t_moe < 1.45e11
    assert 3.0e10 < a_moe < 4.5e10          # top-4 of 16 experts
    assert roofline.model_flops("qwen2-7b", "train_4k") == \
        6 * total * 4096 * 256
    assert roofline.model_flops("qwen2-7b", "decode_32k") == 2 * total * 128


def _record(**kw):
    rec = {"arch": "qwen2-7b", "shape": "train_4k", "mesh": "single",
           "chips": 256, "tag": "", "status": "OK",
           "flops_per_device": 3.0e14,
           "flops_by_dtype": {"bfloat16": 2.0e14, "float32": 1.0e14},
           "bytes_per_device": 6.7e12, "peak_memory_in_bytes": 90 * 2 ** 30,
           "collectives": {"all-gather": 1e9, "all-reduce": 3e9,
                           "_wire_nvlink_bytes": 9.0e9,
                           "_wire_ib_bytes": 1.0e9, "_n_ops": 2}}
    rec.update(kw)
    return rec


def test_a_records_terms_are_the_h100s_rates_on_its_counts():
    row = roofline.analyse_record(_record())
    assert row["t_compute_s"] == pytest.approx(2.0e14 / 989e12
                                               + 1.0e14 / 67e12)
    assert row["t_memory_s"] == pytest.approx(6.7e12 / 3.35e12)
    assert row["t_collective_s"] == pytest.approx(9.0e9 / 450e9
                                                  + 1.0e9 / 50e9)
    assert row["dominant"] == "memory"
    assert row["bound_s"] == row["t_memory_s"]
    mf = roofline.model_flops("qwen2-7b", "train_4k") / 256
    assert row["useful_flops_ratio"] == pytest.approx(mf / 3.0e14)
    assert row["mfu_bound"] == pytest.approx(mf / 989e12 / row["bound_s"])
    assert row["f32_compute_share"] == pytest.approx(
        (1.0e14 / 67e12) / row["t_compute_s"])
    assert row["top_collective"] == "all-reduce"
    assert not row["fits_hbm"]                  # 90 GiB on an 80 GB card
    assert costs.HBM_BYTES < 90 * 2 ** 30
    assert roofline.analyse_record(_record(status="SKIP")) is None


def test_the_lever_names_float32_products_where_they_dominate():
    rec = _record(bytes_per_device=1.0, collectives={})
    row = roofline.analyse_record(rec)
    assert row["dominant"] == "compute"
    assert "float32" in row["lever"] and row["f32_compute_share"] > 0.5
    assert roofline.lever("memory", {"shape": "decode_32k"}, 1.0, "-") \
        == ref_roofline.lever("memory", {"shape": "decode_32k"}, 1.0, "-")
    assert roofline.lever("collective", {"shape": "train_4k"}, 1.0,
                          "all-gather") == ref_roofline.lever(
        "collective", {"shape": "train_4k"}, 1.0, "all-gather")


def test_load_cells_reads_records_of_one_mesh_and_tag(tmp_path):
    for i, (mesh, tag, status) in enumerate([("single", "", "OK"),
                                             ("single", "x", "OK"),
                                             ("multi", "", "OK"),
                                             ("single", "", "SKIP")]):
        rec = _record(mesh=mesh, tag=tag, status=status,
                      shape=["train_4k", "prefill_32k", "decode_32k",
                             "long_500k"][i], reason="out of scope")
        (tmp_path / f"c{i}.json").write_text(json.dumps(rec))
    rows = roofline.load_cells("single", path=str(tmp_path))
    assert [r["shape"] for r in rows] == ["train_4k"]
    assert [r["shape"] for r in roofline.load_cells(
        "single", "x", path=str(tmp_path))] == ["prefill_32k"]
    assert roofline.skip_cells("single", path=str(tmp_path)) == [
        {"arch": "qwen2-7b", "shape": "long_500k", "reason": "out of scope"}]
    md = roofline.to_markdown(rows).splitlines()
    assert md[0].startswith("| arch | shape | Tcomp (ms)")
    assert md[2].startswith("| qwen2-7b | train_4k |") and "✗" in md[2]


def test_the_dryrun_command_writes_records_the_roofline_reads(
        tmp_path, capsys, monkeypatch):
    """``python -m repro_torch.launch.dryrun`` on one small cell of the
    pool and one it skips: exit 0, the reference's keys, and a row of the
    roofline's table."""
    out = tmp_path / "dryrun"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-tiny", "--shape", "decode_32k", "--no-probes", "--out",
         str(out)], capture_output=True, text=True, env=env, timeout=300,
        cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2-7b", "--shape", "long_500k", "--out", str(out)],
        capture_output=True, text=True, env=env, timeout=300,
        cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads((out / "whisper-tiny__decode_32k__single.json")
                     .read_text())
    for key in ("arch", "shape", "mesh", "chips", "mode", "tag", "status",
                "flops_per_device", "bytes_per_device",
                "argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes", "peak_memory_in_bytes", "collectives",
                "hlo_lines", "compile_seconds"):
        assert key in rec, key
    assert rec["status"] == "OK" and rec["chips"] == 256
    assert rec["flops_per_device"] == sum(rec["flops_by_dtype"].values())
    skip = json.loads((out / "qwen2-7b__long_500k__single.json").read_text())
    assert skip["status"] == "SKIP" and "512k" in skip["reason"]
    monkeypatch.chdir(tmp_path)           # its CSVs go under ./results
    rows = roofline.main(["--dir", str(out), "--markdown"])
    assert [(r["arch"], r["shape"]) for r in rows] == [("whisper-tiny",
                                                        "decode_32k")]
    text = capsys.readouterr().out
    assert "| whisper-tiny | decode_32k |" in text
    assert "qwen2-7b,long_500k" in text


@pytest.mark.parametrize("workload", ["lopsided", "random:3,40,0.2"])
def test_search_picks_what_the_references_picks(workload, capsys):
    from benchmarks import hillclimb as ref_hillclimb
    argv = ["search", "--knob", "keep_parallelism", "--grid", "1,2,4,8",
            "--workload", workload, "--workers", "4"]
    hillclimb.main(argv)
    mine = capsys.readouterr().out
    saved = sys.argv
    sys.argv = ["hillclimb"] + argv
    try:
        ref_hillclimb.main()
    finally:
        sys.argv = saved
    want = capsys.readouterr().out
    assert mine.splitlines()[-1] == want.splitlines()[-1]
    assert mine.splitlines()[-1].startswith("best keep_parallelism = ")


def test_flashsim_counts_what_the_kernels_keep_out_of_hbm(capsys):
    """The plain attention (``impl="ref"``, on each rank's local heads)
    against the kernels on whisper-tiny's prefill_32k cell: the S x S
    scores move more bytes than the kernel's output."""
    hillclimb.main(["flashsim", "--arch", "whisper-tiny", "--shape",
                    "prefill_32k"])
    out = capsys.readouterr().out.splitlines()
    kept = next(line for line in out if "kept out of HBM" in line)
    share = float(kept.split("(")[1].split("%")[0])
    assert 0.0 < share < 100.0
