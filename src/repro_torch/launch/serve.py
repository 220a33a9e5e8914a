"""Serving launcher: continuous-batched prefill + decode loop.

Port of ``repro/launch/serve.py``, driven by the same request-queue
scheduler:

  * requests arrive with a prompt and a token budget;
  * prefill runs one request at a time into a batch slot's cache;
  * decode advances ALL active slots in lock-step (continuous batching —
    a finished slot is immediately refilled from the queue);
  * the loop itself is the paper's driver: prefill/decode are pure tasks —
    ``--show-graph`` traces one request into a task DAG, prints it and runs
    it on ``--backend``.

With ``--backend thread`` the traced request's tasks close over the
launcher's one parameter set.  With ``--backend process`` they are the
module-level recipe functions below (``_demo_prefill``/``_demo_decode``, as
in the reference): the graph pickles into spawned workers, and each worker
draws its own parameters from ``(arch, reduced, layers, max_len, seed,
device)`` once (``_serve_runtime``), so the traced tokens match the main
loop's.  The KV or SSM cache crosses between workers as host bytes.  A
caller's own parameter tree (``main(params=...)``) cannot be rebuilt from a
seed, so it serves only on the thread backend.

With ``--gateway HOST:PORT`` the traced request goes instead, built from the
same recipe functions, to a resident gateway (``python -m
repro_torch.launch.gateway``) as tenant ``--tenant``; the request loop still
serves locally.  The recipe functions are taken from the module imported as
``repro_torch.launch.serve``, never from ``__main__`` (which they would
pickle as when this file runs with ``python -m``), so the gateway's workers
can import them.

It runs on the card unless ``--device`` names another device; with no card
and no ``--device`` it raises.  This slice serves the dense transformer
family (qwen2-7b, qwen3-14b, granite-20b, yi-9b) and the MoE family
(dbrx-132b, llama4-maverick-400b-a17b), where every prefill runs the
flash-attention kernel at each layer, the Mamba1 family (falcon-mamba-7b)
and the Mamba2 hybrid (zamba2-7b; every prefill runs the flash-attention
kernel at each shared-attention site).  whisper-tiny, an encoder-decoder,
is refused with the reference's message: the reference serves no
encoder-decoder, so the port's prefill and decode steps for it
(``models/encdec.py``) are driven by the tests and ``chip_smoke.py``
alone.  llava-next-34b serves its text backbone, as in the reference (no
patch embeddings).  ``--layers N`` serves the
config's first N layers at its full width (a full-width model that does
not fit the card whole).  One parameter set serves both the traced request
and the main loop.

Started as the N ranks of a ``torch.distributed`` world (the environment
names it, as ``parallel.mesh.spawn_world`` sets it, or the caller has
initialised a process group), it serves on the ``(N / --tp, --tp)`` (data,
model) mesh of that world with the reference's ``dp_tp`` rules: the
parameters are DTensors laid out by the rule table (also on a mesh of one
rank), each slot's KV or SSM cache is laid out by ``cache_logical_axes``,
the flash and scan kernels run on each rank's local heads and channels,
rank 0 prints and every rank returns the same result.  With
``--show-graph`` the traced request's tasks close over those DTensor
parameters on the thread backend (every rank runs the same graph, so the
collectives meet in one order); on ``--backend process`` and through a
gateway the workers draw their own single-device runtime, as without a
world.  Without a world it serves on one device with plain tensors;
``--tp`` other than 1 then raises ``ValueError``.

CPU example (reduced config):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
      --reduced --device cpu --requests 6 --slots 2 --max-new 8
  ... --arch dbrx-132b --reduced                (MoE, top-4 of 4 experts)
  ... --show-graph --backend process --graph-workers 2   (worker processes)
  ... --show-graph --gateway HOST:PORT --gateway-token T  (a gateway's pool)
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..configs import ARCHS, get_config
from ..core import task, trace
from ..core.placement import standard_rules
from ..interop import resolve_device
from ..models import transformer as TF
from ..models.config import cut_depth
from ..parallel.mesh import launcher_mesh
from ..parallel.sharding import ShardingCtx, distribute_params, full_value
from .backend import add_backend_args, execute_traced, validate_backend_args


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,) int32
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0


def synth_requests(n: int, vocab: int, lo: int = 4, hi: int = 12,
                   max_new: int = 8, seed: int = 0) -> List[Request]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ln = int(rng.integers(lo, hi + 1))
        out.append(Request(i, rng.integers(1, vocab, ln).astype(np.int32),
                           max_new))
    return out


def _greedy(logits: torch.Tensor) -> int:
    """The first row's argmax; a DTensor's full value is taken first (a
    collective: every rank of its mesh calls it)."""
    return int(torch.argmax(full_value(logits)[0]))


# --------------------------------------------------------------------------
# traced-driver demo tasks for --backend process: module-level, with literal
# arguments, so the graph pickles into spawned cluster workers; each worker
# rebuilds its parameters and step functions from the recipe once.
# --------------------------------------------------------------------------
def _config(arch: str, reduced: bool, layers: int):
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    return cut_depth(cfg, layers) if layers else cfg


@functools.lru_cache(maxsize=2)
def _serve_runtime(arch: str, reduced: bool, layers: int, max_len: int,
                   seed: int, device: str):
    cfg = _config(arch, reduced, layers)
    params = TF.init_params(cfg, seed, torch.device(device))
    return (params, TF.make_prefill_step(cfg, max_len=max_len),
            TF.make_decode_step(cfg))


def _demo_prefill(arch, reduced, layers, max_len, seed, device, prompt):
    params, prefill, _ = _serve_runtime(arch, reduced, layers, max_len, seed,
                                        device)
    tokens = torch.as_tensor(np.asarray(prompt, np.int32)[None, :],
                             device=device)
    last, cache = prefill(params, tokens)
    return _greedy(last), cache


def _demo_decode(arch, reduced, layers, max_len, seed, device, tok, cache):
    params, _, decode = _serve_runtime(arch, reduced, layers, max_len, seed,
                                       device)
    token = torch.tensor([[tok]], dtype=torch.int32, device=device)
    logits, cache = decode(params, cache, token)
    return _greedy(logits), cache


def _demo_respond(*toks):
    return list(toks)


demo_prefill = task(_demo_prefill, cost=1.0, name="prefill", n_outputs=2)
demo_decode = task(_demo_decode, cost=0.2, name="decode", n_outputs=2)
demo_respond = task(_demo_respond, cost=0.01, name="respond")


def _recipe_tasks(recipe: tuple):
    """The demo's tasks for the process backend: the recipe functions with
    ``recipe = (arch, reduced, layers, max_len, seed, device)`` bound at trace
    time."""
    def prefill_t(prompt):
        return demo_prefill(*recipe, prompt)

    def decode_t(tok, cache):
        return demo_decode(*recipe, tok, cache)

    return prefill_t, decode_t, demo_respond


def _demo_tasks(params: Dict, prefill, decode, device: torch.device):
    """The demo's tasks for the thread backend: prefill and decode close
    over the launcher's one parameter set (the threads share the address
    space, so nothing is rebuilt); ``respond`` is ``demo_respond``."""
    def _prefill(prompt):
        tokens = torch.as_tensor(np.asarray(prompt, np.int32)[None, :],
                                 device=device)
        last, cache = prefill(params, tokens)
        return _greedy(last), cache

    def _decode(tok, cache):
        token = torch.tensor([[tok]], dtype=torch.int32, device=device)
        logits, cache = decode(params, cache, token)
        return _greedy(logits), cache

    return (task(_prefill, cost=1.0, name="prefill", n_outputs=2),
            task(_decode, cost=0.2, name="decode", n_outputs=2),
            demo_respond)


def main(argv=None, *, params: Optional[Dict] = None) -> Dict[str, Any]:
    """Serve ``--requests`` synthetic requests; returns the finished
    requests and the run's counts and times (with ``--show-graph``, the
    traced request's tokens and its backend's stats, or with ``--gateway``
    the job's stats: its workers' kernel launches and tasks run).

    ``params`` is a parameter tree to serve instead of drawing one from
    ``--seed`` (a tree carried across from the JAX package, or one a caller
    already holds on the device); with ``--show-graph`` and ``--backend
    process`` or ``--gateway`` it raises ``ValueError``, since the workers
    draw theirs from ``--seed``.
    """
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b", choices=ARCHS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="serve the config's first N layers at its width "
                         "(default: all)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tp", type=int, default=1,
                    help="model-parallel ways: the mesh is (N / tp, tp) "
                         "over a world of N ranks; only 1 without a world")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the CUDA card; "
                         "'cpu' runs the kernels' plain versions)")
    ap.add_argument("--show-graph", action="store_true",
                    help="trace one request (prefill + decode chain) into "
                         "a task DAG, print it, and execute on --backend")
    ap.add_argument("--gateway", default=None, metavar="HOST:PORT",
                    help="with --show-graph: submit the traced request "
                         "DAG to a resident gateway as one tenant of its "
                         "shared pool, instead of executing on --backend")
    ap.add_argument("--gateway-token", default=None,
                    help="gateway dial secret")
    ap.add_argument("--tenant", default="serve",
                    help="gateway tenant identity (quota/fair-share/"
                         "accounting bucket)")
    add_backend_args(ap)
    args = ap.parse_args(argv)
    validate_backend_args(args)

    cfg = _config(args.arch, args.reduced, args.layers)
    if cfg.is_encoder_decoder:
        raise SystemExit("serve.py targets decoder-only archs; whisper's "
                         "enc-dec serving is exercised in the dry-run cells")
    TF.check_supported(cfg)
    device = resolve_device(args.device)
    mesh = launcher_mesh(args.tp, device, "repro_torch.launch.serve")
    world = mesh is not None
    say = (functools.partial(print, flush=True)
           if not world or torch.distributed.get_rank() == 0
           else lambda *a, **k: None)
    remote = args.gateway is not None or args.backend == "process"
    if args.show_graph and remote and params is not None:
        raise ValueError("--backend process and --gateway: the workers draw "
                         "their parameters from --seed, so a parameter tree "
                         "passed in serves only on the thread backend")

    if params is None:
        params = TF.init_params(cfg, args.seed, device)
    ctx = None
    if world:
        ctx = ShardingCtx(mesh, standard_rules("dp_tp", pod_axis=None))
        params = distribute_params(params, TF.logical_axes(cfg), ctx)
    prefill = TF.make_prefill_step(cfg, ctx, max_len=args.max_len)
    decode = TF.make_decode_step(cfg, ctx)

    # ---- traced one-request driver executed on the chosen backend ----
    traced_tokens, demo_forwards, demo_prefills = None, 0, 0
    graph_stats: Optional[Dict[str, Any]] = None
    if args.show_graph:
        demo_prompt = tuple(
            synth_requests(1, cfg.vocab_size, max_new=3,
                           seed=args.seed)[0].prompt.tolist())
        if remote:
            # run as ``python -m`` this module is ``__main__``: trace
            # against the canonically imported one, whose functions the
            # workers can import
            import importlib
            canon = importlib.import_module("repro_torch.launch.serve")
            prefill_t, decode_t, respond_t = canon._recipe_tasks(
                (args.arch, args.reduced, args.layers, args.max_len,
                 args.seed, str(device)))
        else:
            prefill_t, decode_t, respond_t = _demo_tasks(params, prefill,
                                                         decode, device)

        def req_driver():
            tok, cache = prefill_t(demo_prompt)
            toks = [tok]
            for _ in range(2):
                tok, cache = decode_t(tok, cache)
                toks.append(tok)
            return respond_t(*toks)

        g, _ = trace(req_driver)
        say(g.summary())
        if args.gateway is not None:
            # tenant mode: the request DAG runs on a SHARED resident pool
            # next to other tenants' jobs, bit-identical to local
            from ..gateway import connect as gateway_connect
            with gateway_connect(args.gateway, token=args.gateway_token,
                                 tenant=args.tenant) as gc:
                fut = gc.submit(g, label="serve-request")
                res = fut.result()
            graph_stats = fut.stats
            say(f"[gateway {args.gateway}] executed {len(g.nodes)} "
                f"tasks as tenant {args.tenant} in "
                f"{fut.wall_time:.3f}s (stats {graph_stats})")
        else:
            res, graph_stats = execute_traced(g, args)
        traced_tokens = res[g.outputs[0]]
        demo_prefills = sum(1 for n in g if n.name == "prefill")
        demo_forwards = demo_prefills + sum(1 for n in g
                                            if n.name == "decode")
        say(f"traced request tokens: {traced_tokens}")

    reqs = synth_requests(args.requests, cfg.vocab_size,
                          max_new=args.max_new, seed=args.seed)
    queue = list(reqs)
    for r in queue:
        r.t_submit = time.time()

    # slot state
    slot_req: List[Optional[Request]] = [None] * args.slots
    caches: List[Optional[Dict]] = [None] * args.slots
    t0 = time.time()
    n_prefills = n_decode_steps = 0
    finished: List[Request] = []

    while queue or any(s is not None for s in slot_req):
        # admit: fill every free slot (prefill)
        for s in range(args.slots):
            if slot_req[s] is None and queue:
                req = queue.pop(0)
                tokens = torch.as_tensor(req.prompt[None, :], device=device)
                last, caches[s] = prefill(params, tokens)
                n_prefills += 1
                req.t_first = time.time()
                req.out.append(_greedy(last))
                slot_req[s] = req
        # decode tick over active slots
        for s in range(args.slots):
            req = slot_req[s]
            if req is None:
                continue
            tok = torch.tensor([[req.out[-1]]], dtype=torch.int32,
                               device=device)
            logits, caches[s] = decode(params, caches[s], tok)
            req.out.append(_greedy(logits))
            n_decode_steps += 1
            if len(req.out) >= req.max_new or \
                    len(req.prompt) + len(req.out) >= args.max_len:
                req.t_done = time.time()
                finished.append(req)
                slot_req[s] = None
                caches[s] = None

    wall = time.time() - t0
    ttft = [r.t_first - r.t_submit for r in finished]
    lat = [r.t_done - r.t_submit for r in finished]
    say(f"served {len(finished)} requests in {wall:.2f}s | "
        f"decode steps {n_decode_steps} "
        f"({n_decode_steps / wall:.1f} tok/s) | "
        f"TTFT p50 {np.median(ttft) * 1e3:.0f} ms | "
        f"latency p50 {np.median(lat) * 1e3:.0f} ms")
    for r in finished[:3]:
        say(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {r.out}")
    return {"finished": finished, "wall": wall,
            "decode_steps": n_decode_steps,
            "forwards": demo_forwards + n_prefills + n_decode_steps,
            "prefills": demo_prefills + n_prefills,
            "traced_tokens": traced_tokens, "graph_stats": graph_stats,
            "ttft_p50": float(np.median(ttft)),
            "latency_p50": float(np.median(lat)),
            "decode_tok_s": n_decode_steps / wall, "device": str(device)}


if __name__ == "__main__":
    main()
