"""``repro-driver`` — run (or resume) a checkpointed cluster driver.

Port of ``repro/launch/driver.py``, unchanged apart from the module paths.

The driver half of the multi-host survivability story
(``docs/driver_recovery.md``).  Where ``repro-worker`` makes *worker*
processes disposable, this entrypoint makes the *driver* disposable: it
runs a :class:`~repro_torch.cluster.ClusterExecutor` with a run-log checkpoint
under ``--checkpoint-dir``, and a SIGKILL'd driver is restarted with
``--resume`` — the new incarnation rebinds the same listening address,
re-adopts the surviving workers (their rejoin loops re-dial it), and
continues the run from the checkpointed frontier.

Start a run (the run id and address print first, flushed, so a supervisor
can capture them before any crash)::

    python -m repro_torch.launch.driver --graph mypkg.graphs:build --arg 500 \
        --workers 8 --checkpoint-dir /var/tmp/ckpt --out results.pkl

Resume after a driver death (``--resume latest`` picks the newest log in
the checkpoint dir)::

    python -m repro_torch.launch.driver --graph mypkg.graphs:build --arg 500 \
        --workers 8 --checkpoint-dir /var/tmp/ckpt --resume latest \
        --out results.pkl

The graph is rebuilt by re-importing ``--graph`` — the run log stores
*metadata*, not code — and the resume path fingerprint-checks that the
rebuilt graph and fusion plan match the interrupted run.  Workers are
fork-started by default: fork children survive their parent's SIGKILL
(the daemon flag only matters at clean interpreter exit), which is
exactly what lets a restarted driver find its old pool still alive.
"""
from __future__ import annotations

import argparse
import importlib
import pickle
import sys
from typing import List, Optional

from repro_torch.checkpoint.runlog import latest_run


def _demo_node(*xs, _i=0):
    return (_i + sum(xs) * 7) % 1_000_003


def demo_graph(n: int = 200, seed: int = 0):
    """Deterministic integer-arithmetic DAG (module-level functions, so it
    pickles): the stock target for smoke tests and the CI driver-kill
    drill — ``--graph repro_torch.launch.driver:demo_graph --arg 200``."""
    import functools
    import random

    from repro_torch.core import TaskGraph, TaskKind
    from repro_torch.core.tracing import RemappedRef as _Ref

    rng = random.Random(seed)
    g = TaskGraph()
    for i in range(n):
        deps = [j for j in range(i) if rng.random() < 0.25][-3:]
        g.add_node(f"t{i}", functools.partial(_demo_node, _i=i),
                   tuple(_Ref(d) for d in deps), {},
                   TaskKind.PURE, deps=deps, cost=rng.uniform(0.1, 1.0))
    g.mark_output(n - 1)
    return g


def build_graph(spec: str, args: List[int]):
    """Import ``module:function`` and call it with the ``--arg`` ints."""
    if ":" not in spec:
        raise ValueError(f"--graph must be MODULE:FUNCTION, got {spec!r}")
    mod_name, _, fn_name = spec.partition(":")
    fn = getattr(importlib.import_module(mod_name), fn_name)
    return fn(*args)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro-driver",
        description="run a checkpointed ClusterExecutor driver; a killed "
                    "driver is restarted with --resume")
    ap.add_argument("--graph", required=True, metavar="MODULE:FN",
                    help="graph builder to import and call")
    ap.add_argument("--arg", type=int, action="append", default=[],
                    help="int argument(s) for the graph builder")
    ap.add_argument("--workers", type=int, default=2,
                    help="local worker processes")
    # shared cluster knobs come from ClusterConfig field metadata — the
    # same group train.py/serve.py/repro-gateway expose (no more
    # per-launcher flag copies); tcp is the resumable channel default
    # here because the whole point of this entrypoint is driver recovery
    from repro_torch.config import ClusterConfig
    ClusterConfig.add_flags(
        ap, names=("channel", "connect", "token", "checkpoint_dir",
                   "checkpoint_interval", "resume", "fuse", "adaptive",
                   "keep_parallelism", "refuse_skew", "outputs_only"),
        defaults={"channel": "tcp"})
    ap.add_argument("--fail-driver", type=int, default=None, metavar="N",
                    help="testing: emulate a driver SIGKILL after N "
                    "cluster completions")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="pickle the {tid: value} results here")
    args = ap.parse_args(argv)
    if not args.checkpoint_dir:
        ap.error("the following arguments are required: --checkpoint-dir")

    resume = args.resume
    if resume == "latest":
        resume = latest_run(args.checkpoint_dir)
        if resume is None:
            print(f"repro-driver: no run logs under {args.checkpoint_dir}",
                  file=sys.stderr, flush=True)
            return 2

    graph = build_graph(args.graph, args.arg)

    from repro_torch.cluster import ClusterExecutor, DriverKilled
    cfg = ClusterConfig.from_flags(
        args, names=("channel", "connect", "token", "checkpoint_dir",
                     "checkpoint_interval", "fuse", "adaptive",
                     "keep_parallelism", "refuse_skew", "outputs_only"),
        n_workers=args.workers, resume=resume,
        fail_driver=args.fail_driver, start_method="fork")
    ex = ClusterExecutor(config=cfg)
    # first line out, flushed: a supervisor needs the run id to relaunch
    # with --resume even if this process dies an instant later
    print(f"repro-driver: {'resuming' if resume else 'run'} "
          f"{resume or 'pending'} listening {ex.address or '-'} "
          f"pid {__import__('os').getpid()}", flush=True)
    try:
        results = ex.run(graph)
    except DriverKilled as e:
        print(f"repro-driver: {e}", file=sys.stderr, flush=True)
        return 3
    print(f"repro-driver: run {ex.run_id} complete "
          f"({ex.stats.get('resumed_clusters', 0)} clusters resumed, "
          f"{ex.stats.get('recomputed', 0)} recomputed, "
          f"wall {ex.wall_time:.2f}s)", flush=True)
    if args.out:
        with open(args.out, "wb") as f:
            pickle.dump(results, f, protocol=5)
        print(f"repro-driver: results -> {args.out}", flush=True)
    ex.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
