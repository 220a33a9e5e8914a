"""What the benchmark reads of the port's optimizers, one module each,
named by the configuration's ``optimizer["kind"]`` in lower case: its
``first_grad(state, opt)``, the first step's gradient as the optimizer
took it, worked out from its state after that step."""
from __future__ import annotations

import importlib
from typing import Dict


def reader(settings: Dict):
    """The module of the optimizer ``settings["kind"]``."""
    return importlib.import_module(f"{__name__}.{settings['kind'].lower()}")
