"""Runtime-backend selection for the port's launchers.

Port of ``repro/launch/backend.py``.  ``--backend thread`` executes a traced
driver DAG with the in-process work-stealing
:class:`~repro_torch.core.executor.ThreadedExecutor`.  ``--backend process``
(the multi-process cluster runtime) and the cluster flags the reference
generates from ``ClusterConfig`` (``--transport``, ``--channel``,
``--fuse``, ...) are accepted so that a reference command line parses, and
raise ``NotImplementedError``: that runtime is ROADMAP §1 item 3.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Optional

from ..core import TaskGraph, make_executor

#: the reference launchers' cluster flags (``BACKEND_FLAG_FIELDS`` there)
CLUSTER_FLAGS = ("transport", "channel", "speculate_after", "fuse",
                 "collectives", "adaptive", "keep_parallelism",
                 "refuse_skew")

_NOT_PORTED = ("the multi-process cluster runtime is not ported yet: "
               "ROADMAP §1 item 3")


def add_backend_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--backend", default="thread",
                    choices=["thread", "process"],
                    help="runtime for --show-graph driver execution: "
                         "in-process threads (process: not ported)")
    ap.add_argument("--graph-workers", type=int, default=2,
                    help="worker count for the traced-driver dry-run")
    for name in CLUSTER_FLAGS:
        ap.add_argument("--" + name.replace("_", "-"), dest=name,
                        default=None, metavar="VALUE",
                        help="cluster runtime flag (not ported)")


def validate_backend_args(args) -> None:
    """Raise ``NotImplementedError`` for what only the unported cluster
    runtime could do."""
    if getattr(args, "backend", "thread") == "process":
        raise NotImplementedError(f"--backend process: {_NOT_PORTED}")
    given = [n for n in CLUSTER_FLAGS if getattr(args, n, None) is not None]
    if given:
        flags = ", ".join("--" + n.replace("_", "-") for n in given)
        raise NotImplementedError(f"{flags}: {_NOT_PORTED}")


def execute_traced(graph: TaskGraph, args,
                   inputs: Optional[Dict[str, Any]] = None) -> Dict[int, Any]:
    """Run a traced driver DAG on the selected backend and report stats."""
    validate_backend_args(args)
    ex = make_executor(args.backend, args.graph_workers)
    results = ex.run(graph, inputs)
    print(f"[{args.backend} backend] executed {len(graph.nodes)} tasks "
          f"on {args.graph_workers} workers in {ex.wall_time:.3f}s "
          f"(stats {ex.stats})", flush=True)
    return results
