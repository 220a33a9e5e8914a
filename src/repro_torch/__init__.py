"""repro_torch — the auto-parallelizing task-graph runtime, on PyTorch and CUDA.

Port of ``repro/__init__.py``.  The port is a package of its own beside the
JAX package ``repro``: it imports ``torch`` and numpy, never ``jax`` and
nothing of ``repro``.  Top-level convenience surface::

    import repro_torch

    g, _ = repro_torch.trace(driver)      # or build a TaskGraph by hand
    repro_torch.run_graph(g, n_workers=4)

Everything is imported lazily: ``import repro_torch`` must stay cheap (no
torch import, no CUDA initialisation) because launchers and worker threads
pay it on startup.  Only the names ported so far are exposed.
"""
from typing import Any

__all__ = ["TaskGraph", "task", "io_task", "trace", "run_graph",
           "make_executor", "execute_sequential"]

_LAZY = {
    "TaskGraph": ("repro_torch.core.graph", "TaskGraph"),
    "task": ("repro_torch.core.tracing", "task"),
    "io_task": ("repro_torch.core.tracing", "io_task"),
    "trace": ("repro_torch.core.tracing", "trace"),
    "run_graph": ("repro_torch.core.executor", "run_graph"),
    "make_executor": ("repro_torch.core.executor", "make_executor"),
    "execute_sequential": ("repro_torch.core.executor", "execute_sequential"),
}


def __getattr__(name: str) -> Any:
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module 'repro_torch' has no attribute {name!r}") from None
    import importlib
    value = getattr(importlib.import_module(mod_name), attr)
    globals()[name] = value      # cache: __getattr__ runs once per name
    return value


def __dir__() -> list:
    return sorted(set(globals()) | set(_LAZY))
