"""The plain reference of the benchmark's configurations: each model's
forward, its loss, its gradients and AdamW, in float32 PyTorch with TF32
off, written from the configuration file's sizes.  It imports nothing of
the program and nothing of the JAX package, and calls no kernel of either.

``precision="fp8"`` computes where the configurations compute in bf16 in
float8 e4m3 instead (a per-tensor scale): every operand of every product,
and every product's result that the model keeps as an activation, are
rounded to it; products still sum in float32 and the logits stay float32.
That is the control, the step below the configurations' precision, which
the comparison must refuse.

Each model family is a module of its own, ``<family>.py``, named by the
configuration file's ``family``: its ``leaves(cfg)`` (the parameter tree)
and its ``loss(params, tokens, labels, cfg, precision, run_layer)``.  Each
optimizer is one too, named by the configuration's ``optimizer["kind"]``
in lower case: its ``Optimizer(params, settings)`` with ``step(params,
grads)``.  A new family or optimizer arrives as a new module.
"""
from __future__ import annotations

import importlib
from typing import Dict


def family(cfg: Dict):
    """The module of ``cfg``'s model family."""
    return importlib.import_module(f"{__name__}.{cfg['family']}")


def optimizer(settings: Dict):
    """The module of the optimizer ``settings["kind"]``."""
    return importlib.import_module(f"{__name__}.{settings['kind'].lower()}")
