"""Checkpointing: the control-plane run log.

Port of ``repro/checkpoint/__init__.py``, without the array-tree store
(``repro/checkpoint/store.py``), which is ROADMAP §1 item 6.  The cluster
driver and its workers need only :mod:`repro_torch.checkpoint.runlog`.
"""
from .runlog import (RunLog, RunState, load_run, latest_run,  # noqa: F401
                     graph_fingerprint, plan_fingerprint)

__all__ = ["RunLog", "RunState", "load_run", "latest_run",
           "graph_fingerprint", "plan_fingerprint"]
