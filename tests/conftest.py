"""Make ``repro`` importable from a plain ``pytest`` invocation (no
PYTHONPATH needed) and keep the tests directory itself importable so suites
can share helpers like ``_propcheck``."""
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_HERE), "src")
for p in (_SRC, _HERE):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; the test skips itself "
        "when none is present")
