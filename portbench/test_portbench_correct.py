"""The comparison that decides ``correct``, shown to refuse what it must:
a run driven as the benchmark drives it (everything but the look for a
card), at a CPU's size, with a fault planted underneath the timed path,
comes out not correct under the cell's own limits; and so does the
control, the reference with fp8 operands put in the program's place.  A
sound run at the same size comes out correct."""
import contextlib
import io
import json

import pytest
import torch

from portbench import compare, faults, harness, run
from portbench.traffic import train

CELLS = ("granite-20b.train-s8k", "falcon-mamba-7b.train-s2k")


def _line(cell, result):
    out, err = io.StringIO(), io.StringIO()
    real = harness.emit
    harness.emit = lambda line, checks: real(line, checks, out, err)
    try:
        run.report(cell, result, False, torch)
    finally:
        harness.emit = real
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("fault", [None] + list(faults.FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_a_fault_under_the_timed_path_makes_the_run_not_correct(
        workload, fault, tiny_cell):
    cell = tiny_cell(workload)
    with (faults.FAULTS[fault]() if fault else contextlib.nullcontext()):
        result = train.run(cell, 2 ** 31 + 17, 0.1, False, "cpu", 0.0)
    line = _line(cell, result)
    assert line["correct"] is (fault is None), line["limits"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_fp8_control_in_the_programs_place_is_not_correct(
        workload, tiny_cell):
    cell = tiny_cell(workload)
    dev = torch.device("cpu")
    ref = train.follow(cell, 5, dev)
    control = train.follow(cell, 5, dev, precision="fp8")
    checks = compare.judge(compare.numbers(control, ref),
                           compare.limits(workload))
    assert not all(c["ok"] for c in checks.values()), checks
