"""Perf-iteration driver over the dry-run.

Port of ``benchmarks/hillclimb.py``, with the same four subcommands:

  * ``diagnose``: run ONE cell (at a probe depth for speed) and print the
    top collectives and the largest operations, each with the model code
    that issued it (the port's models are functions, so the counter names
    the function and line where the reference prints XLA's ``op_name``):
    the "profile" of the dry-run world.
  * ``run``: run a cell with config overrides under a ``--tag``, so
    ``<out>/<cell>_<tag>.json`` records the variant; print the three
    roofline terms and the delta against the untagged baseline.
  * ``flashsim``: the memory term of the same case with the plain
    attention (``impl="ref"``: the S×S scores materialised, and for the
    Mamba1 archs the plain scan) against the kernels', extrapolated from
    the two probe depths: what the kernels keep out of HBM.
  * ``search``: the distributed-runtime leg: sweep one scheduler or fusion
    knob through ``core.simulator.search_policy`` over a workload
    (``lopsided``: the adaptive benchmark's two-epoch graph, or
    ``random:SEED,N,P``), optionally replaying a recorded ``RunTrace``.

Usage (from the repo root):
  PYTHONPATH=src python -m repro_torch.launch.hillclimb diagnose \\
      --arch qwen3-14b --shape train_4k [--depth 4]
  PYTHONPATH=src python -m repro_torch.launch.hillclimb run \\
      --arch qwen3-14b --shape train_4k --tag remat_none \\
      --override remat=none
  PYTHONPATH=src python -m repro_torch.launch.hillclimb flashsim \\
      --arch qwen2-7b --shape prefill_32k
  PYTHONPATH=src python -m repro_torch.launch.hillclimb search \\
      --knob keep_parallelism --grid 2,4,8,16 --workload lopsided

The compile subcommands make the dry-run's fake world of 256 ranks in
this process (``launch.dryrun.fake_world``); ``search`` makes none.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import time
from typing import Dict, List, Optional

from . import steps
from .dryrun import (DEFAULT_OUT, _probe_depths, build_case_for, fake_world,
                     make_mesh, parse_override, run_cell)

_BYTES_RE = re.compile(r" bytes=(\d+)")
_COLL_RE = re.compile(r"^collective (\S+) bytes=(\d+) group=([0-9,]*)")


def _depth_overrides(cfg, depth: Optional[int], over: Dict) -> Dict:
    over = dict(over)
    if depth:
        over.update(n_layers=depth, layer_plan=())
        if cfg.is_encoder_decoder:
            over["n_enc_layers"] = depth
    return over


def diagnose(args) -> None:
    from ..configs import get_config
    cfg = get_config(args.arch)
    over = _depth_overrides(cfg, args.depth,
                            dict(parse_override(o) for o in
                                 args.override or []))
    with fake_world(256):
        case = build_case_for(args.arch, args.shape, make_mesh("single"),
                              args.mode, over)
        compiled = steps.lower_case(case, where=True).compile()
    cost = compiled.cost_analysis()
    lines = compiled.as_text().splitlines()
    by_dtype = ", ".join(f"{k} {v:.3e}"
                         for k, v in cost["flops_by_dtype"].items())
    print(f"depth={args.depth or 'full'} flops/dev={cost['flops']:.3e} "
          f"({by_dtype}) bytes/dev={cost['bytes accessed']:.3e} "
          f"peak={cost['peak_memory_in_bytes']:.3e}")

    # a collective's line is followed by its operation's, which names the
    # issuing code
    rows = []
    for i, line in enumerate(lines):
        m = _COLL_RE.match(line)
        if not m:
            continue
        where = lines[i + 1].rsplit(" @ ", 1)[-1] if i + 1 < len(lines) \
            else "?"
        g = len([r for r in m.group(3).split(",") if r])
        rows.append((int(m.group(2)), m.group(1), g, where[:110]))
    rows.sort(reverse=True)
    print(f"\ntop collectives (of {len(rows)}), result bytes per device:")
    for b, op, g, name in rows[:args.top]:
        print(f"  {b/1e6:10.1f} MB  {op:<19s} g={g:<4d} {name}")

    big = []
    for line in lines:
        if line.startswith(("collective", "dtensor")):
            continue
        m = _BYTES_RE.search(line)
        if not m or int(m.group(1)) < 1e6:
            continue
        op = line.split(" ", 1)[0]
        big.append((int(m.group(1)), op, line.rsplit(" @ ", 1)[-1][:110]))
    big.sort(reverse=True)
    print("\nlargest operations, bytes moved per device:")
    for b, op, name in big[:args.top]:
        print(f"  {b/1e6:10.1f} MB  {op:<34s} {name}")


def flashsim(args) -> None:
    """The memory term with the plain attention (S×S scores in HBM) against
    the kernels', extrapolated from the two probe depths as the dry-run's
    ``probe_correction`` does."""
    from ..configs import get_config
    from .costs import HBM_BYTES_PER_S
    cfg = get_config(args.arch)
    L1, L2 = _probe_depths(cfg)
    over = dict(parse_override(o) for o in args.override or [])
    got: Dict = {}
    with fake_world(256):
        mesh = make_mesh("single")
        for impl in ("kernel", "ref"):
            for L in (L1, L2):
                case = steps.build_case(
                    args.arch, args.shape, mesh, args.mode,
                    overrides=_depth_overrides(cfg, L, over), impl=impl)
                cost = steps.lower_case(case).compile().cost_analysis()
                got[impl, L] = (float(cost["bytes accessed"]),
                                float(cost["peak_memory_in_bytes"]))
                del case
    L = cfg.n_layers

    def lerp(impl, i):
        a, b = got[impl, L1][i], got[impl, L2][i]
        return a + (b - a) * (L - L1) / (L2 - L1)
    kernel, plain = lerp("kernel", 0), lerp("ref", 0)
    print(f"{args.arch} × {args.shape} [{args.mode}]")
    print(f"  bytes/dev, kernels     {kernel:.4g}  (t_mem "
          f"{kernel / HBM_BYTES_PER_S:.3f} s, peak {lerp('kernel', 1):.4g} B)")
    print(f"  bytes/dev, plain       {plain:.4g}  (t_mem "
          f"{plain / HBM_BYTES_PER_S:.3f} s, peak {lerp('ref', 1):.4g} B)")
    share = (plain - kernel) / plain if plain else 0.0
    print(f"  kept out of HBM        {plain - kernel:.4g}  ({share:.1%} of "
          f"the plain version's bytes)")


def run(args) -> None:
    over = dict(parse_override(o) for o in args.override or [])
    with fake_world(256):
        rec = run_cell(args.arch, args.shape, "single", args.out,
                       mode=args.mode, overrides=over or None, tag=args.tag,
                       probes=False)
    if rec["status"] != "OK":
        print(rec.get("error", rec.get("reason")))
        return
    report(args.arch, args.shape, args.tag, args.out, rec)


def _terms(rec: Dict) -> Optional[Dict]:
    from .roofline import analyse_record
    return analyse_record(rec)


def report(arch: str, shape: str, tag: str, out_dir: str,
           rec: Optional[Dict] = None) -> None:
    if rec is None:
        with open(os.path.join(out_dir,
                               f"{arch}__{shape}__single_{tag}.json")) as f:
            rec = json.load(f)
    row = _terms(rec)
    base_path = os.path.join(out_dir, f"{arch}__{shape}__single.json")
    base = None
    if os.path.exists(base_path):
        with open(base_path) as f:
            base = _terms(json.load(f))
    print(f"\n{arch} × {shape} [{tag or 'baseline'}]")
    for k in ("t_compute_s", "t_memory_s", "t_collective_s", "mfu_bound",
              "useful_flops_ratio"):
        cur = row[k]
        if base:
            d = (cur - base[k]) / base[k] * 100 if base[k] else float("nan")
            print(f"  {k:<18s} {cur:12.6g}   ({d:+7.1f}% vs baseline "
                  f"{base[k]:.6g})")
        else:
            print(f"  {k:<18s} {cur:12.6g}")
    print(f"  dominant           {row['dominant']}")


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------

def heavy_step(x, s):
    time.sleep(s)
    return x * 3 + 1


def cheap_step(x, s):
    time.sleep(s)
    return x + 1


def comb(*xs):
    return sum(int(x) for x in xs) % 1_000_003


def build_workload(*, width: int = 48, n_heavy: int = 8,
                   heavy_s: float = 0.1, cheap_s: float = 0.001,
                   miscosted: bool = True):
    """Two epochs of a ``width``-wide layer, each pinched through a
    two-gate reduction (``ga``/``gb`` fan-ins -> ``gc`` combiner): the
    adaptive benchmark's graph (``benchmarks/bench_adaptive.py:78-125``).

    The first ``n_heavy`` tasks of each layer sleep ``heavy_s``; the rest
    ``cheap_s``.  With ``miscosted`` every task declares ``cost=1.0``, so
    sibling grouping packs heavy and cheap tasks together and the static
    plan is lopsided; with ``miscosted=False`` heavy tasks declare their
    true cost ratio and the static plan is already balanced."""
    from ..core import TaskGraph, TaskKind
    from ..core.tracing import RemappedRef as _Ref
    hc = 1.0 if miscosted else heavy_s / cheap_s
    g = TaskGraph()

    def layer(dep: Optional[int]) -> List[int]:
        tids = []
        for i in range(width):
            heavy = i < n_heavy
            t = len(g.nodes)
            fn = heavy_step if heavy else cheap_step
            s = heavy_s if heavy else cheap_s
            args = (_Ref(dep), s) if dep is not None else (i, s)
            g.add_node(f"w{t}", fn, args, {}, TaskKind.PURE,
                       deps=[dep] if dep is not None else [],
                       cost=hc if heavy else 1.0)
            tids.append(t)
        return tids

    def gatepair(tids: List[int]) -> int:
        a = g.add_node("ga", comb, tuple(_Ref(t) for t in tids), {},
                       TaskKind.PURE, deps=tids, cost=1.0)
        b = g.add_node("gb", comb, tuple(_Ref(t) for t in tids), {},
                       TaskKind.PURE, deps=tids, cost=1.0)
        return g.add_node("gc", comb, (_Ref(a), _Ref(b)), {},
                          TaskKind.PURE, deps=[a, b], cost=1.0)

    gate = gatepair(layer(None))
    g.mark_output(gatepair(layer(gate)))
    return g


def _search_workload(spec: str):
    """``lopsided`` (the adaptive benchmark's two-epoch graph) or
    ``random:SEED,N,P_EDGE`` (the property-test random DAG shape)."""
    if spec == "lopsided":
        return build_workload(heavy_s=0.0, cheap_s=0.0)
    if spec.startswith("random:"):
        import random as _random
        from ..core import TaskGraph, TaskKind
        seed, n, p = spec[len("random:"):].split(",")
        rng = _random.Random(int(seed))
        g = TaskGraph()
        for i in range(int(n)):
            deps = [j for j in range(i) if rng.random() < float(p)][-4:]
            g.add_node(f"t{i}", None, (), {}, TaskKind.PURE, deps=deps,
                       cost=rng.uniform(0.1, 4.0),
                       out_bytes=rng.randint(0, 1 << 20))
            if rng.random() < 0.1:
                g.mark_output(i)
        if not g.outputs:
            g.mark_output(int(n) - 1)
        return g
    raise SystemExit(f"unknown --workload {spec!r} "
                     "(want 'lopsided' or 'random:SEED,N,P')")


def search(args) -> None:
    from ..core.adaptive import RunTrace
    from ..core.simulator import WorkerEvent, search_policy
    from .roofline import print_rows

    graph = _search_workload(args.workload)
    grid = []
    for c in args.grid.split(","):
        c = c.strip()
        grid.append(int(c) if args.knob in ("keep_parallelism",
                                            "collective_arity")
                    else float(c))
    events = []
    for spec in args.partition or []:
        t, w, dur = spec.split(":")
        events.append(WorkerEvent(time=float(t), kind="partition",
                                  worker=int(w), factor=float(dur)))
    trace = RunTrace.load(args.trace) if args.trace else None
    kw: Dict = {"dispatch_overhead": args.dispatch_overhead}
    if args.fuse:
        kw["fuse"] = args.fuse
    best, results = search_policy(
        args.knob, graph, args.workers, grid,
        events=events or None, trace=trace, **kw)
    rows = [{"candidate": c,
             "makespan_s": round(r.makespan, 4),
             "util": round(r.utilization, 3),
             "recomputed": r.n_recomputed,
             "speculative": r.n_speculative,
             "refusions": r.refusions,
             "best": "*" if c == best else ""}
            for c, r in sorted(results.items())]
    print_rows(f"search {args.knob} over {args.workload}"
               + (f" + trace {args.trace}" if args.trace else ""), rows)
    print(f"best {args.knob} = {best}  "
          f"(makespan {results[best].makespan:.4f}s)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("diagnose")
    d.add_argument("--arch", required=True)
    d.add_argument("--shape", required=True)
    d.add_argument("--mode", default="fsdp_tp")
    d.add_argument("--depth", type=int, default=4,
                   help="layers (0: the full depth)")
    d.add_argument("--top", type=int, default=15)
    d.add_argument("--override", action="append")
    r = sub.add_parser("run")
    r.add_argument("--arch", required=True)
    r.add_argument("--shape", required=True)
    r.add_argument("--mode", default="fsdp_tp")
    r.add_argument("--tag", required=True)
    r.add_argument("--out", default=DEFAULT_OUT)
    r.add_argument("--override", action="append")
    f = sub.add_parser("flashsim")
    f.add_argument("--arch", required=True)
    f.add_argument("--shape", required=True)
    f.add_argument("--mode", default="fsdp_tp")
    f.add_argument("--override", action="append")
    s = sub.add_parser("search")
    s.add_argument("--knob", required=True,
                   choices=("suspect_grace", "collective_arity",
                            "speculate_after", "keep_parallelism",
                            "fanin_cost", "group_cost"))
    s.add_argument("--grid", required=True,
                   help="comma-separated candidate values")
    s.add_argument("--workload", default="lopsided",
                   help="'lopsided' or 'random:SEED,N,P'")
    s.add_argument("--workers", type=int, default=4)
    s.add_argument("--trace", default=None,
                   help="RunTrace json from a live run (replay measured "
                        "durations instead of declared costs)")
    s.add_argument("--partition", action="append",
                   help="T:WORKER:DUR partition event (repeatable)")
    s.add_argument("--fuse", default=None)
    s.add_argument("--dispatch-overhead", type=float, default=0.0)
    args = ap.parse_args(argv)
    {"diagnose": diagnose, "flashsim": flashsim, "search": search,
     "run": run}[args.cmd](args)


if __name__ == "__main__":
    main()
