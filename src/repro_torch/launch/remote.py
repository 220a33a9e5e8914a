"""``repro-worker`` — start cluster workers on this host and dial a driver.

Port of ``repro/launch/remote.py``, unchanged.

This is the multi-host half of :class:`repro_torch.cluster.ClusterExecutor`'s
TCP control plane.  A driver built with ``channel="tcp"`` (or with
``workers=[..., "remote", ...]``) binds a listening address; this
entrypoint dials it, handshakes (magic / protocol version / optional
shared ``--token`` / host identity), receives its worker id plus the run
configuration and the pickled ``(graph, inputs)`` pair in the welcome
frame, and then serves tasks exactly like a forked in-host worker —
heartbeating so the driver can tell a network partition from an idle
worker, saying an explicit goodbye on clean shutdown.

Usage (one worker per ``--n``, each its own OS process)::

    python -m repro_torch.launch.remote --connect HOST:PORT [--token T] [--n 2]
        [--timeout 60]

Dial a driver that is still starting up: the connect retries until
``--timeout``.  A worker that dials a *live* run joins it elastically —
the driver replans onto the grown pool — so scaling out mid-job is just
starting more of these.

The graph crosses the wire by pickle, so remote runs have the same
constraint as ``start_method="spawn"``: task functions must be picklable
(module-level functions parameterized by literals — ship the recipe, not
the weights).  See ``docs/multihost.md`` for the deployment how-to and
the transport matrix.
"""
from __future__ import annotations

import argparse
import multiprocessing as mp
import sys
from typing import List, Optional

from repro_torch.cluster import serde
from repro_torch.cluster.channel import ChannelClosed
from repro_torch.cluster.worker import tcp_worker_main


def _serve_one(address: str, token: Optional[str], timeout: float) -> int:
    try:
        wid = tcp_worker_main(address, token=token, timeout=timeout)
    except ChannelClosed as e:
        print(f"repro-worker: {e}", file=sys.stderr, flush=True)
        return 1
    print(f"repro-worker: worker {wid} finished cleanly", flush=True)
    return 0


def _serve_one_exit(address: str, token: Optional[str],
                    timeout: float) -> None:
    """Child-process target: a Process target's return value is discarded,
    so the status must go through sys.exit to become the exitcode."""
    sys.exit(_serve_one(address, token, timeout))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro-worker",
        description="dial a ClusterExecutor driver and serve tasks")
    ap.add_argument("--connect", required=True, metavar="HOST:PORT",
                    help="driver address (ClusterExecutor(...).address)")
    ap.add_argument("--token", default=None,
                    help="shared secret, if the driver requires one")
    ap.add_argument("--n", type=int, default=1,
                    help="worker processes to start on this host")
    ap.add_argument("--timeout", type=float, default=60.0,
                    help="seconds to keep retrying the dial/handshake")
    args = ap.parse_args(argv)
    if ":" not in args.connect:
        ap.error(f"--connect must be HOST:PORT, got {args.connect!r}")
    if args.n < 1:
        ap.error("--n must be >= 1")
    # Startup residue sweep: a worker SIGKILL'd on this host never ran its
    # shutdown sweep, so its dead run's rr* segments leak in /dev/shm.
    # Scoped to runs whose driver pid is gone AND whose resume lease (if
    # any) has expired — a checkpointed run inside its rejoin window keeps
    # its segments even though its driver pid is dead, so this worker can
    # no longer race a same-host driver resume out of its recovery inputs
    # (docs/driver_recovery.md §3).
    swept = serde.sweep_stale_segments()
    if swept:
        print(f"repro-worker: swept {swept} stale shm segment(s) from "
              "dead runs", flush=True)
    if args.n == 1:
        return _serve_one(args.connect, args.token, args.timeout)
    # one OS process per worker: each dials, handshakes, and serves its own
    # store — the same isolation the driver's local spawn gives
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_serve_one_exit,
                         args=(args.connect, args.token, args.timeout),
                         name=f"repro-worker-{i}")
             for i in range(args.n)]
    for p in procs:
        p.start()
    rc = 0
    for p in procs:
        p.join()
        rc = rc or (p.exitcode or 0)
    return rc


if __name__ == "__main__":
    sys.exit(main())
