"""The port stands alone: no module of ``repro_torch``, and neither
``chip_smoke.py`` nor ``kernel_ab.py``, imports JAX or the JAX package
``repro``."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_IMPORT_SCRIPT = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print(len(names), ",".join(bad))
"""


def test_importing_every_port_module_loads_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _IMPORT_SCRIPT],
                          capture_output=True, text=True, env=env,
                          cwd=str(ROOT), timeout=120)
    assert proc.returncode == 0, proc.stderr
    count, bad = proc.stdout.strip().split(" ", 1) \
        if " " in proc.stdout.strip() else (proc.stdout.strip(), "")
    assert int(count) >= 37          # every module of the slices was imported
    assert bad == "", f"port imports pulled in {bad}"


_BAD_IMPORT = re.compile(
    r"^\s*(?:import\s+(?:jax|repro)\b(?!_)|from\s+(?:jax|repro)\b(?!_))",
    re.MULTILINE)


def test_port_sources_name_no_jax_or_repro_import():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "kernel_ab.py"]
    assert len(files) >= 38          # the 37 modules and chip_smoke.py
    offenders = {str(f.relative_to(ROOT)): _BAD_IMPORT.findall(f.read_text())
                 for f in files}
    assert {f: m for f, m in offenders.items() if m} == {}


def test_import_pattern_catches_what_it_should():
    for src in ("import jax", "import jax.numpy as jnp", "from jax import x",
                "    from repro.core import task", "import repro",
                "from repro import kernels"):
        assert _BAD_IMPORT.search(src), src
    for src in ("import repro_torch", "from repro_torch.core import task",
                "from .core import task", "# see repro.core.graph"):
        assert not _BAD_IMPORT.search(src), src
