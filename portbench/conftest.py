"""Fixtures of the benchmark's CPU tests: the benchmark's cells cut to a
CPU's size (the port's ``reduced()`` widths, two layers, float32 compute,
short sequences), with the port's config lookup patched to give them."""
import dataclasses
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import harness  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; the test skips itself "
        "when none is present")


def tiny(workload: str, compute_dtype: str = "float32", layers: int = 2,
         batch: int = 2, seq: int = 24):
    """``(cell, port config)``: the cell with the port's reduced widths of
    its architecture at ``layers`` layers, ``batch`` × ``seq`` tokens."""
    from repro_torch.configs import get_config
    cell = harness.cell(harness.benchmark(), workload)
    config = dict(cell["config"])
    small = get_config(config["port_arch"]).reduced(
        n_layers=layers, compute_dtype=compute_dtype)
    for key in set(config) & {f.name for f in dataclasses.fields(small)}:
        if key not in ("name", "remat"):
            config[key] = getattr(small, key)
    mix = dict(cell["traffic"], batch=batch, seq=seq)
    return dict(cell, config=config, traffic=mix), small


@pytest.fixture
def tiny_cell(monkeypatch):
    """Makes a tiny cell (see :func:`tiny`) and patches the port's config
    lookup to give its architecture at the tiny widths."""
    from repro_torch import configs

    def make(workload, **kw):
        cell, small = tiny(workload, **kw)
        real = configs.get_config
        monkeypatch.setattr(
            configs, "get_config",
            lambda name: small if name == cell["config"]["port_arch"]
            else real(name))
        return cell
    return make

