"""Multi-node dry-run: every (arch × shape × mesh) cell run once on fake
tensors in a fake world, each device's FLOPs, bytes, memory and
collectives counted at H100 constants.

Port of ``repro/launch/dryrun.py``.  Run it as a module::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b \\
        --shape train_4k --mesh single

It makes its own world of the ``fake`` backend (``FakeStore``: no peer, no
communication) in this one process: 256 ranks for ``single``, laid out as
the port's ``make_production_mesh`` (16, 16) over (data, model), 512 for
``multi`` ((2, 16, 16) over (pod, data, model)), and ``one``: the (1, 1)
mesh over a world of one.  A ``fake`` process group is one per process,
which is why the dry-run runs as a module of its own.  Each cell's case
(``launch/steps.py::build_case``: fake tensors laid out by the rule table)
runs its step once under ``launch.costs.Counter`` as rank 0 runs it, and
one JSON record is written per cell with the reference's keys
(``<out>/<arch>__<shape>__<mesh>[_<tag>].json``).

The port's layer loop is Python, so the count at full depth is exact and
is what the record's top-level keys hold.  ``corrected`` keeps the
reference's two-probe extrapolation (``_probe_depths``,
``probe_correction``) as a check that cost is affine in depth.

The mesh's tensors are made on ``--device`` (``cpu`` by default; ``cuda``
on a machine with a card): the count is of what the card runs either way.
The kernels' operators stand in for them (``kernels/operators.py``), and
DTensor's shard-to-shard moves are counted as the all-to-all the card's
NCCL runs (gloo has none; DTensor falls back to an all-gather there).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import time
import traceback
from typing import Any, Dict, Iterable, List, Optional, Union

from . import steps
from .costs import IB_BYTES_PER_S, NODE_RANKS, NVLINK_BYTES_PER_S

# the reference's pod: the rank where the second (16, 16) block starts.
# On an H100 cluster both blocks hang off one InfiniBand fabric, so a
# group across it is priced at IB_BYTES_PER_S as any group across nodes;
# the reference's separate DCN attribution is kept in its keys.
POD_RANKS = 256
WORLDS = {"single": 256, "multi": 512, "one": 1}
DEFAULT_OUT = "results/dryrun_torch"


# Ring-algorithm per-device wire-byte factors, as a function of the
# (per-device) RESULT size b and the group size g:
#   all-gather      result is the gathered buffer; wire = b·(g-1)/g
#   all-reduce      operand == result;            wire = 2·b·(g-1)/g
#   reduce-scatter  operand = b·g;                wire = b·(g-1)
#   all-to-all      operand == result;            wire = b·(g-1)/g
#   collective-permute / broadcast                wire = b
def _wire_bytes(op: str, b: float, g: int) -> float:
    if g <= 1:
        return 0.0 if op not in ("collective-permute",) else b
    if op == "all-gather":
        return b * (g - 1) / g
    if op == "all-reduce":
        return 2.0 * b * (g - 1) / g
    if op == "reduce-scatter":
        return b * (g - 1)
    if op == "all-to-all":
        return b * (g - 1) / g
    return b   # permute / broadcast


_LOG_RE = re.compile(r"^collective (\S+) bytes=(\d+) group=([0-9,]*)$")


def events_from_text(text: str) -> List[Dict[str, Any]]:
    """The collectives of an op log (``launch.costs.Counter.text``)."""
    out = []
    for line in text.splitlines():
        m = _LOG_RE.match(line)
        if m:
            out.append({"op": m.group(1), "bytes": int(m.group(2)),
                        "group": [int(r) for r in m.group(3).split(",")
                                  if r]})
    return out


def parse_collectives(events: Union[str, Iterable[Dict[str, Any]]],
                      pod_boundary: Optional[int] = None,
                      node_ranks: int = NODE_RANKS) -> Dict[str, float]:
    """Per-device collective traffic of a run's collectives (the counter's
    events, or its op log).

    Returns the reference's dict: raw RESULT bytes per op kind, and modeled
    wire bytes with ring-algorithm factors and each op's group size:
    ``_wire_ici_bytes`` / ``_wire_dcn_bytes`` split at ``pod_boundary``
    (the rank where pod 1 starts; an op whose group or permute pair spans
    it is attributed to DCN in full), ``_dcn_bytes``, ``_n_ops``.  It adds
    the H100 cluster's split: ``_wire_nvlink_bytes`` for an op whose every
    group lies inside one node of ``node_ranks`` consecutive ranks, and
    ``_wire_ib_bytes`` for one whose group spans nodes, attributed in full
    as the reference attributes a pod-crossing op.

    An event is ``{"op", "bytes", "group"}`` (this rank's group's global
    ranks), or with ``"groups"`` (every group) or ``"pairs"`` (a permute's
    source-target pairs).  The reference's "promoted" half-width rule is
    XLA:CPU's (bf16 all-reduces computed in f32 on the host) and has no
    counterpart here: a count's bytes are the card's."""
    if isinstance(events, str):
        events = events_from_text(events)
    out: Dict[str, float] = {}
    wire_ici = wire_dcn = dcn_bytes = wire_nvl = wire_ib = 0.0
    n_ops = 0
    for ev in events:
        op, b = ev["op"], float(ev["bytes"])
        if b == 0:
            continue
        n_ops += 1
        out[op] = out.get(op, 0.0) + b
        if op == "collective-permute":
            g = 2
            groups = [list(p) for p in ev.get("pairs", [])]
        else:
            groups = ev.get("groups") or ([ev["group"]] if ev.get("group")
                                          else [])
            g = len(groups[0]) if groups else 1
        crosses = pod_boundary is not None and any(
            min(grp) < pod_boundary <= max(grp) for grp in groups if grp)
        spans_nodes = any(len({r // node_ranks for r in grp}) > 1
                          for grp in groups if grp)
        w = _wire_bytes(op, b, g)
        if crosses:
            wire_dcn += w
            dcn_bytes += b
        else:
            wire_ici += w
        if spans_nodes:
            wire_ib += w
        else:
            wire_nvl += w
    out["_dcn_bytes"] = dcn_bytes
    out["_wire_ici_bytes"] = wire_ici
    out["_wire_dcn_bytes"] = wire_dcn
    out["_wire_nvlink_bytes"] = wire_nvl
    out["_wire_ib_bytes"] = wire_ib
    out["_n_ops"] = n_ops
    return out


def collective_seconds(coll: Dict[str, float]) -> float:
    """The wire bytes at the links' rates: NVLink inside a node,
    InfiniBand across nodes."""
    return (coll.get("_wire_nvlink_bytes", 0.0) / NVLINK_BYTES_PER_S
            + coll.get("_wire_ib_bytes", 0.0) / IB_BYTES_PER_S)


def _probe_depths(cfg) -> tuple:
    """Layer counts for the two cost probes.  The period p is the smallest
    depth after which the layer plan repeats (zamba2's shared-attn
    cadence, llama4's interleaved MoE); probing at (p, 2p) layers makes the
    linear extrapolation to full depth exact for plan-periodic stacks."""
    import math
    p = 1
    if cfg.shared_attn_every:
        p = cfg.shared_attn_every
    if cfg.n_experts and cfg.moe_every > 1:
        p = p * cfg.moe_every // math.gcd(p, cfg.moe_every)
    L1 = p if p > 1 else 2
    return L1, 2 * L1


def _cost_record(compiled) -> Dict[str, Any]:
    cost = compiled.cost_analysis()
    return {"flops_per_device": float(cost["flops"]),
            "flops_by_dtype": {k: float(v) for k, v in
                               cost["flops_by_dtype"].items()},
            "bytes_per_device": float(cost["bytes accessed"]),
            "events": cost["collective_events"]}


def probe_correction(arch: str, shape, mesh, mode: str,
                     overrides: Optional[Dict],
                     pod_boundary: Optional[int] = None) -> Dict:
    """Per-device cost terms extrapolated from two shallow runs.

    The reference needs this because XLA's ``cost_analysis`` counts a
    scanned layer body once.  The port counts the full depth exactly, so
    here the extrapolation ``X(L) = X(L1) + (X(L2)-X(L1))·(L-L1)/(L2-L1)``
    is a check: it equals the full-depth count when cost is affine in
    depth."""
    from ..configs import get_config
    cfg = get_config(arch)
    L_full = (overrides or {}).get("n_layers", cfg.n_layers)
    # the period of the plan the overrides give (zamba2's shared-attention
    # cadence, the MoE interleave)
    cfg = dataclasses.replace(cfg, layer_plan=(), **{
        k: v for k, v in (overrides or {}).items()
        if k not in ("n_layers", "layer_plan", "n_enc_layers")})
    L1, L2 = _probe_depths(cfg)
    probes = {}
    for L in (L1, L2):
        upd = dict(overrides or {})
        upd.update(n_layers=L, layer_plan=())
        if cfg.is_encoder_decoder:
            upd["n_enc_layers"] = L
        case = build_case_for(arch, shape, mesh, mode, upd)
        rec = _cost_record(steps.lower_case(case).compile())
        rec["collectives"] = parse_collectives(rec.pop("events"),
                                               pod_boundary)
        probes[L] = rec
        del case

    def lerp(x1: float, x2: float) -> float:
        return x1 + (x2 - x1) * (L_full - L1) / (L2 - L1)

    p1, p2 = probes[L1], probes[L2]
    dtypes = set(p1["flops_by_dtype"]) | set(p2["flops_by_dtype"])
    coll_keys = set(p1["collectives"]) | set(p2["collectives"])
    return {
        "probe_depths": [L1, L2],
        "flops_per_device": lerp(p1["flops_per_device"],
                                 p2["flops_per_device"]),
        "flops_by_dtype": {k: lerp(p1["flops_by_dtype"].get(k, 0.0),
                                   p2["flops_by_dtype"].get(k, 0.0))
                           for k in dtypes},
        "bytes_per_device": lerp(p1["bytes_per_device"],
                                 p2["bytes_per_device"]),
        "collectives": {k: lerp(p1["collectives"].get(k, 0.0),
                                p2["collectives"].get(k, 0.0))
                        for k in coll_keys},
        "probes": probes,
    }


def build_case_for(arch: str, shape, mesh, mode: str,
                   overrides: Optional[Dict]):
    return steps.build_case(arch, shape, mesh, mode, overrides=overrides)


# ---------------------------------------------------------------------------
# the fake world
# ---------------------------------------------------------------------------

def _alltoall_as_on_the_card(input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's shard-to-shard move as NCCL runs it: the all-to-all
    operator, whatever the mesh's device (on ``cpu`` DTensor falls back to
    an all-gather and a chunk, for gloo)."""
    import torch
    return torch.ops._dtensor.shard_dim_alltoall(
        input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)


@contextlib.contextmanager
def fake_world(n: int):
    """This process as rank 0 of a world of ``n`` ranks of the ``fake``
    backend, destroyed on exit; DTensor's shard-to-shard moves inside are
    the card's all-to-all."""
    import torch.distributed as dist
    from torch.distributed.tensor import placement_types
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised: run the "
                           "dry-run in a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    inner = placement_types.shard_dim_alltoall
    placement_types.shard_dim_alltoall = _alltoall_as_on_the_card
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = inner
        dist.destroy_process_group()


def make_mesh(kind: str, device: str = "cpu"):
    """The cell's mesh over the fake world: ``single`` (16, 16), ``multi``
    (2, 16, 16), ``one`` (1, 1)."""
    from .mesh import make_mesh_for, make_production_mesh
    if kind == "one":
        return make_mesh_for(1, device=device)
    return make_production_mesh(multi_pod=kind == "multi", device=device)


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def _shape_name(shape) -> str:
    return shape if isinstance(shape, str) else shape.name


def run_cell(arch: str, shape, mesh_kind: str, out_dir: str,
             mode: str = "fsdp_tp", overrides: Optional[Dict] = None,
             tag: str = "", verbose: bool = True, device: str = "cpu",
             probes: bool = True) -> Dict:
    """Run one cell in the fake world this process is in (:func:`fake_world`
    of ``WORLDS[mesh_kind]`` ranks) and write its record."""
    mesh = make_mesh(mesh_kind, device)
    multi = mesh_kind == "multi"
    boundary = POD_RANKS if multi else None
    rec: Dict = {"arch": arch, "shape": _shape_name(shape),
                 "mesh": mesh_kind, "chips": mesh.size, "mode": mode,
                 "tag": tag, "device": device}
    if overrides:
        rec["overrides"] = dict(overrides)
    if not isinstance(shape, str):
        rec["shape_spec"] = dataclasses.asdict(shape)
    t0 = time.time()
    try:
        case = build_case_for(arch, shape, mesh, mode, overrides)
        if case.skip_reason:
            rec["status"] = "SKIP"
            rec["reason"] = case.skip_reason
            return _finish(rec, out_dir, t0, verbose)
        compiled = steps.lower_case(case).compile()
        mem = compiled.memory_analysis()
        cost = _cost_record(compiled)
        hlo = compiled.as_text()
        rec["status"] = "OK"
        rec["flops_per_device"] = cost["flops_per_device"]
        rec["flops_by_dtype"] = cost["flops_by_dtype"]
        rec["bytes_per_device"] = cost["bytes_per_device"]
        for attr in ("argument_size_in_bytes", "output_size_in_bytes",
                     "temp_size_in_bytes", "peak_memory_in_bytes"):
            rec[attr] = int(getattr(mem, attr))
        rec["collectives"] = parse_collectives(cost["events"], boundary)
        rec["hlo_lines"] = hlo.count("\n")
        rec["n_ops"] = compiled.cost_analysis()["n_ops"]
        del hlo, compiled, case
        if probes and not multi:
            # the two-probe extrapolation, kept as a check of the exact
            # full-depth count (single mesh, as the reference's)
            try:
                rec["corrected"] = probe_correction(
                    arch, shape, mesh, mode, overrides, boundary)
            except Exception as e:      # a probe failure must not fail it
                rec["corrected_error"] = f"{type(e).__name__}: {e}"
    except Exception as e:
        rec["status"] = "FAIL"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    return _finish(rec, out_dir, t0, verbose)


def record_path(out_dir: str, arch: str, shape: str, mesh: str,
                tag: str = "") -> str:
    tag = f"_{tag}" if tag else ""
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh}{tag}.json")


def _finish(rec: Dict, out_dir: str, t0: float, verbose: bool) -> Dict:
    rec["compile_seconds"] = round(time.time() - t0, 2)
    os.makedirs(out_dir, exist_ok=True)
    path = record_path(out_dir, rec["arch"], rec["shape"], rec["mesh"],
                       rec.get("tag", ""))
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    if verbose:
        status = rec["status"]
        extra = ""
        if status == "OK":
            coll = rec["collectives"]
            extra = (f" flops/dev={rec['flops_per_device']:.3e}"
                     f" bytes/dev={rec['bytes_per_device']:.3e}"
                     f" peak={rec['peak_memory_in_bytes']:.3e}"
                     f" coll_ops={coll.get('_n_ops', 0)}"
                     f" nvlink={coll['_wire_nvlink_bytes']:.3e}"
                     f" ib={coll['_wire_ib_bytes']:.3e}")
        elif status == "FAIL":
            extra = " " + rec["error"][:200]
        elif status == "SKIP":
            extra = " " + rec["reason"][:80]
        print(f"[{rec['compile_seconds']:7.1f}s] {rec['arch']:28s} "
              f"{rec['shape']:12s} {rec['mesh']:6s} {status}{extra}",
              flush=True)
    return rec


def parse_override(s: str):
    k, v = s.split("=", 1)
    for cast in (int, float):
        try:
            return k, cast(v)
        except ValueError:
            pass
    if v in ("True", "False"):
        return k, v == "True"
    return k, v


def main(argv=None) -> None:
    from ..configs import ARCHS
    from ..models.config import SHAPES, ShapeSpec
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all",
                    help="shape id, 'all', or NAME:SEQ:BATCH:KIND for a "
                         "shape of one's own (KIND train, prefill or decode)")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both", "one"])
    ap.add_argument("--mode", default="fsdp_tp")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--tag", default="")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default="cpu",
                    help="the device the fake tensors are on (cpu, cuda)")
    ap.add_argument("--override", action="append", default=[],
                    help="KEY=VALUE config override (repeatable)")
    ap.add_argument("--no-probes", action="store_true",
                    help="skip the two-probe extrapolation")
    args = ap.parse_args(argv)

    archs = ARCHS if args.arch == "all" else [args.arch]
    if args.shape == "all":
        shapes: List[Any] = list(SHAPES)
    elif ":" in args.shape:
        name, seq, batch, kind = args.shape.split(":")
        shapes = [ShapeSpec(name, int(seq), int(batch), kind)]
    else:
        shapes = [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    overrides = dict(parse_override(o) for o in args.override) or None

    n_fail = 0
    for mesh_kind in meshes:
        with fake_world(WORLDS[mesh_kind]):
            for arch in archs:
                for shape in shapes:
                    path = record_path(args.out, arch, _shape_name(shape),
                                       mesh_kind, args.tag)
                    if args.skip_existing and os.path.exists(path):
                        with open(path) as f:
                            if json.load(f).get("status") == "OK":
                                continue
                    rec = run_cell(arch, shape, mesh_kind, args.out,
                                   mode=args.mode, overrides=overrides,
                                   tag=args.tag, device=args.device,
                                   probes=not args.no_probes)
                    n_fail += rec["status"] == "FAIL"
    print(f"dry-run complete, {n_fail} failures", flush=True)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
