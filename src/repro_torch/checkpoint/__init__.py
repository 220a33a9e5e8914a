"""Checkpointing: the tensor-tree store and the control-plane run log.

Port of ``repro/checkpoint/__init__.py``.  The cluster driver and its
workers need only :mod:`repro_torch.checkpoint.runlog`; the store's names
(:mod:`repro_torch.checkpoint.store`, which imports torch) are re-exported
lazily (PEP 562), as in the reference.
"""
from .runlog import (RunLog, RunState, load_run, latest_run,  # noqa: F401
                     graph_fingerprint, plan_fingerprint)

_STORE_NAMES = ("save_checkpoint", "restore_checkpoint", "latest_step",
                "AsyncCheckpointer", "CheckpointManager")

__all__ = list(_STORE_NAMES) + [
    "RunLog", "RunState", "load_run", "latest_run",
    "graph_fingerprint", "plan_fingerprint",
]


def __getattr__(name):
    if name in _STORE_NAMES:
        from . import store
        return getattr(store, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
