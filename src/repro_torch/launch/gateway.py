"""The gateway launcher: run the cluster as a resident multi-tenant service.

Port of ``repro/launch/gateway.py``.  Brings up one
:class:`~repro_torch.gateway.GatewayService` (a shared worker pool + a
client listener) and serves until interrupted.  Clients submit task graphs
from other processes/hosts with::

    with repro_torch.connect("gw-host:7777", token=tok, tenant="serve") as c:
        results = c.submit(graph, inputs).result()

or the one-liner ``repro_torch.run_graph(graph, connect="gw-host:7777")``.

Start a gateway (the client address prints first, flushed, so a
supervisor can capture it before handing it to clients)::

    python -m repro_torch.launch.gateway --n-workers 8 --token s3cret \\
        --client-address 0.0.0.0:7777 \\
        --quota serve=64 --quota batch=32:1000000000 --weight serve=2

With ``--start-method auto`` (the default) the pool spawns its workers when
a CUDA device is present and forks them otherwise
(:class:`~repro_torch.gateway.GatewayService` says why); the first line
names the method.  ``--start-method spawn`` asks for it on any machine.

Quotas are ``TENANT=MAX_CLUSTERS[:MAX_BYTES]`` (either part empty for
unlimited); ``--weight TENANT=W`` sets fair-share dispatch weights.
With ``--checkpoint-dir`` the pool journals a run log, and a restarted
gateway with ``--resume latest`` re-creates tenant sessions (quotas,
weights) from it — in-flight jobs fail on their clients, which resubmit
(graphs are pure, so the resubmission is bit-identical).

All pool knobs (transport, channel, fusion, fault policy, ...) are the
standard :class:`repro_torch.ClusterConfig` flag group — the operator owns
them; tenants can only set ``repro_torch.config.TENANT_FIELDS`` per job.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from repro_torch.config import ClusterConfig


def _parse_quota(spec: str):
    """``TENANT=CLUSTERS[:BYTES]`` -> (tenant, TenantQuota)."""
    from repro_torch.gateway import TenantQuota
    tenant, sep, rest = spec.partition("=")
    if not sep or not tenant:
        raise argparse.ArgumentTypeError(
            f"quota must be TENANT=MAX_CLUSTERS[:MAX_BYTES], got {spec!r}")
    clusters, _, byts = rest.partition(":")
    try:
        return tenant, TenantQuota(
            max_inflight_clusters=int(clusters) if clusters else None,
            max_store_bytes=int(byts) if byts else None)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"quota limits must be integers, got {spec!r}") from None


def _parse_weight(spec: str):
    tenant, sep, w = spec.partition("=")
    if not sep or not tenant:
        raise argparse.ArgumentTypeError(
            f"weight must be TENANT=FLOAT, got {spec!r}")
    try:
        return tenant, float(w)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"weight must be TENANT=FLOAT, got {spec!r}") from None


def _stats_line(stats: dict) -> str:
    parts = []
    for tenant in sorted(k for k in stats if k != "pool"):
        s = stats[tenant]
        slo = s["slo"]["submit_to_gather_s"]
        p50 = f"{slo['p50'] * 1e3:.0f}ms" if slo["p50"] is not None else "-"
        p99 = f"{slo['p99'] * 1e3:.0f}ms" if slo["p99"] is not None else "-"
        parts.append(
            f"{tenant}[sess {s['sessions']} inflight {s['inflight_jobs']}"
            f" done {s['completed']} fail {s['failed']}"
            f" rej {s['rejected']} p50 {p50} p99 {p99}]")
    return " ".join(parts) or "(no tenants yet)"


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.gateway",
        description="resident multi-tenant cluster gateway: one shared "
                    "worker pool, graph submissions over TCP")
    ap.add_argument("--client-address", default="127.0.0.1:0",
                    metavar="HOST:PORT",
                    help="address to bind for client sessions (port 0 = "
                         "ephemeral; printed on startup).  Distinct from "
                         "--connect, the pool's worker listener")
    ap.add_argument("--quota", action="append", default=[],
                    type=_parse_quota, metavar="TENANT=CLUSTERS[:BYTES]",
                    help="per-tenant admission ceiling (repeatable)")
    ap.add_argument("--default-quota", default=None,
                    metavar="CLUSTERS[:BYTES]",
                    help="admission ceiling for tenants without an "
                         "explicit --quota")
    ap.add_argument("--weight", action="append", default=[],
                    type=_parse_weight, metavar="TENANT=W",
                    help="fair-share dispatch weight (repeatable; "
                         "default 1.0)")
    ap.add_argument("--stats-every", type=float, default=0.0, metavar="S",
                    help="print a per-tenant stats line every S seconds "
                         "(0 = off)")
    ClusterConfig.add_flags(ap)
    args = ap.parse_args(argv)

    resume = args.resume
    if resume == "latest":
        from repro_torch.checkpoint.runlog import latest_run
        resume = latest_run(args.checkpoint_dir or "")
        if resume is None:
            print("gateway: no run logs under "
                  f"{args.checkpoint_dir}", file=sys.stderr, flush=True)
            return 2

    cfg = ClusterConfig.from_flags(args, resume=resume)
    default_quota = None
    if args.default_quota:
        default_quota = _parse_quota(f"*={args.default_quota}")[1]

    from repro_torch.gateway import GatewayService
    gw = GatewayService(cfg, client_address=args.client_address,
                        quotas=dict(args.quota),
                        default_quota=default_quota)
    gw.start()
    for tenant, w in args.weight:
        gw.executor.set_tenant_weight(tenant, w)
    # first line out, flushed: clients need this address
    print(f"gateway: serving clients on {gw.address} "
          f"(pool: {cfg.n_workers} workers, start method "
          f"{gw.executor.start_method}, worker listener "
          f"{gw.executor.address or '-'}) "
          f"pid {__import__('os').getpid()}", flush=True)

    import threading
    stop_stats = threading.Event()
    if args.stats_every > 0:
        def report() -> None:
            while not stop_stats.wait(args.stats_every):
                print(f"gateway: {_stats_line(gw.stats())}",
                      flush=True)
        threading.Thread(target=report, daemon=True,
                         name="gateway-stats").start()
    try:
        gw.serve_forever()
    except KeyboardInterrupt:
        print("gateway: interrupted, draining", flush=True)
    except BaseException as e:
        print(f"gateway: pool died: {e!r}", file=sys.stderr,
              flush=True)
        stop_stats.set()
        gw.stop()
        return 3
    stop_stats.set()
    gw.stop()
    print("gateway: stopped", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
