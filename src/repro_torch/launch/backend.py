"""Runtime-backend selection for the port's launchers.

Port of ``repro/launch/backend.py``.  ``--backend thread`` executes a traced
driver DAG with the in-process work-stealing
:class:`~repro_torch.core.executor.ThreadedExecutor`; ``--backend process``
uses the multi-process :class:`~repro_torch.cluster.ClusterExecutor`
(driver-side object store, lineage fault tolerance).

The cluster knobs themselves (``--transport``, ``--channel``, ``--fuse``,
``--collectives``, ``--speculate-after``, ...) are generated from
:class:`repro_torch.ClusterConfig` field metadata, as in the reference.
Only ``--backend`` / ``--graph-workers`` stay local: they select the
runtime, they are not runtime configuration.

The process backend leaves the start method to the cluster executor: a
launcher on the card has initialised CUDA by the time it runs the traced
graph, so its workers spawn (a forked child cannot initialise CUDA once the
launcher has); on the CPU they fork.  A spawned worker is a fresh
interpreter and the graph is pickled across, which is why the launcher demo
tasks are module-level functions parameterized by literals (arch name,
seed, device) that rebuild their model lazily inside the worker — ship the
*recipe*, not the weights.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Tuple

from ..config import ClusterConfig
from ..core import TaskGraph, make_executor
from ..core.collectives import parse_collectives_spec
from ..core.executor import Executor
from ..core.fusion import parse_fuse_spec

#: ClusterConfig fields exposed as launcher backend flags (the subset a
#: single-run launcher exercises)
BACKEND_FLAG_FIELDS = ("transport", "channel", "speculate_after",
                       "fuse", "collectives", "adaptive",
                       "keep_parallelism", "refuse_skew")

#: launcher-facing defaults that differ from the library defaults: the
#: demo drivers trace fine-grained graphs, so fusion pays for itself
_LAUNCHER_DEFAULTS = {"fuse": "auto"}

_CFG_CHOICES: Dict[str, tuple] = {
    f.name: tuple(f.metadata["choices"] or ())
    for f in ClusterConfig.flag_fields()}

#: data-plane transports and control channels each runtime backend
#: supports, derived from the config metadata.  The thread backend shares
#: one address space, so anything but the default is a user error worth
#: naming at the flag.
BACKEND_TRANSPORTS: Dict[str, tuple] = {
    "thread": ("auto",),
    "process": _CFG_CHOICES["transport"],
}

BACKEND_CHANNELS: Dict[str, tuple] = {
    "thread": ("auto",),
    "process": _CFG_CHOICES["channel"],
}


def add_backend_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--backend", default="thread",
                    choices=["thread", "process"],
                    help="runtime for --show-graph driver execution: "
                         "in-process threads or spawned cluster workers")
    ap.add_argument("--graph-workers", type=int, default=2,
                    help="worker count for the traced-driver dry-run")
    ClusterConfig.add_flags(ap, names=BACKEND_FLAG_FIELDS,
                            defaults=_LAUNCHER_DEFAULTS)


def validate_backend_args(args) -> None:
    """Fail fast, with the flag's own vocabulary, when ``--transport`` /
    ``--channel`` / ``--speculate-after`` / ``--fuse`` / ``--collectives``
    name something the chosen ``--backend`` cannot do."""
    backend = getattr(args, "backend", "thread")
    transport = getattr(args, "transport", "auto")
    # the config-generated --channel parses "auto" to None (the config's
    # "infer from pool shape" spelling); both mean the default here
    channel = getattr(args, "channel", "auto") or "auto"
    if transport not in BACKEND_TRANSPORTS.get(backend, ("auto",)):
        raise SystemExit(
            f"--transport {transport} is not supported by --backend "
            f"{backend}: the thread backend runs in one address space "
            f"(no data plane to choose); use --backend process for "
            f"{BACKEND_TRANSPORTS['process'][1:]}")
    if channel not in BACKEND_CHANNELS.get(backend, ("auto",)):
        raise SystemExit(
            f"--channel {channel} is not supported by --backend {backend}: "
            f"only the process backend has a worker control plane; use "
            f"--backend process for {BACKEND_CHANNELS['process'][1:]}")
    speculate = getattr(args, "speculate_after", None)
    if speculate is not None and backend != "process":
        raise SystemExit(
            f"--speculate-after {speculate} is not supported by --backend "
            f"{backend}: only the process backend duplicates stragglers "
            f"onto idle workers; use --backend process")
    fuse = getattr(args, "fuse", "auto")
    try:
        parsed = parse_fuse_spec(fuse)
    except ValueError as e:
        raise SystemExit(f"--fuse {fuse}: {e}") from None
    if parsed not in ("off", "auto") and backend != "process":
        raise SystemExit(
            f"--fuse {fuse} is not supported by --backend {backend}: only "
            f"the process backend pays per-task dispatch round-trips worth "
            f"fusing away; use --backend process")
    coll = getattr(args, "collectives", "auto")
    try:
        cparsed = parse_collectives_spec(coll)
    except ValueError as e:
        raise SystemExit(f"--collectives {coll}: {e}") from None
    if cparsed not in ("off", "auto") and backend != "process":
        raise SystemExit(
            f"--collectives {coll} is not supported by --backend {backend}: "
            f"the thread backend shares one address space, so there is no "
            f"data plane to shape a tree over (collective nodes run their "
            f"dense fallback); use --backend process")


def execute_traced(graph: TaskGraph, args,
                   inputs: Optional[Dict[str, Any]] = None
                   ) -> Tuple[Dict[int, Any], Dict[str, Any]]:
    """Run a traced driver DAG on the selected backend, print its stats
    (including the data-plane counters and the workers' kernel launches
    for the process backend) and return ``(results, stats)``."""
    validate_backend_args(args)
    if args.backend == "process":
        cfg = ClusterConfig.from_flags(
            args, names=BACKEND_FLAG_FIELDS,
            n_workers=args.graph_workers, progress_timeout=300.0)
        ex: Executor = make_executor("process", args.graph_workers,
                                     config=cfg)
    else:
        ex = make_executor("thread", args.graph_workers)
    results = ex.run(graph, inputs)
    transport = getattr(ex, "transport_used", None)
    via = f" via {transport} transport" if transport else ""
    print(f"[{args.backend} backend{via}] executed {len(graph.nodes)} tasks "
          f"on {args.graph_workers} workers in {ex.wall_time:.3f}s "
          f"(stats {ex.stats})", flush=True)
    return results, dict(ex.stats)
