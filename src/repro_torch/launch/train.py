"""Training launcher.

Port of ``repro/launch/train.py``: runs the ``launch.steps`` train step on
the card unless ``--device`` names another (with no card and no
``--device`` it raises).  ``--reduced`` gives the CPU-sized config of the
same family.

Started as the N ranks of a ``torch.distributed`` world (the environment
names it: ``RANK``, ``WORLD_SIZE``, ``REPRO_WORLD_STORE``, as
``parallel.mesh.spawn_world`` sets them; or the caller has initialised a
process group), it trains on the ``(N / --tp, --tp)`` (data, model) mesh of
that world (``parallel.mesh.launcher_mesh``: NCCL on the card, gloo with
``--device cpu``), with ``standard_rules(--mode)``: the parameters and
optimizer state are DTensors laid out by the rule table, also on a mesh of
one rank, the checkpoints resume onto the run's mesh whatever mesh wrote
them, rank 0 prints and every rank returns the same result.  Without a
world it trains on one device with plain tensors and never imports
``torch.distributed.tensor``; ``--tp`` other than 1 then raises
``ValueError`` (the reference ignores it on one device).

  * checkpoint/restart: async save every ``--ckpt-every`` steps;
    ``--resume`` restores params + optimizer state + data cursor onto the
    run's device;
  * the whole program is (step, host)-deterministic, so a restarted job
    replays the exact token stream from the cursor;
  * straggler detection: per-step wall-time EWMA; steps slower than
    ``--straggler-x`` times the EWMA are logged;
  * the driver loop is traced by the paper's auto-parallelizer: data
    loading is an ``@io_task`` source, the train step a pure task and the
    checkpoint an ``@io_task`` sink; ``--show-graph`` prints the DAG and
    runs it on ``--backend``.

The parameters and optimizer state are updated in place by each step
(``repro_torch.optim``).  The ``--show-graph`` demo tasks are module-level
and parameterized by literals (the device among them), so the traced graph
pickles into spawned workers, which rebuild the runtime from the recipe.
They are taken from the module imported as ``repro_torch.launch.train``,
never from ``__main__`` (which they would pickle as when this file runs
with ``python -m``), as ``launch/serve.py`` takes its own.
It trains every config of the pool on the card and the CPU: the dense
transformer family, llava-next-34b (its batches carry ``patch_embeds``,
``frontends.synth_patches``), MoE, Mamba1 (its gradient through the scan's
backward kernel on the card), the Mamba2 hybrid and the encoder-decoder
whisper-tiny (``models/encdec.py``; its batches carry ``frames``,
``frontends.synth_frames``).  As in the reference, every step takes the
same patches or frames, drawn from seed 0 on the run's device.

CPU example (reduced qwen2-family config; ``--arch falcon-mamba-7b`` for
Mamba1, ``whisper-tiny`` for the encoder-decoder, ``llava-next-34b`` for
the VLM, and without ``--device cpu`` on the card):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \\
      --reduced --device cpu --steps 8 --batch 2 --seq 16
and on a world of 4 gloo ranks at ``--tp 2``:
  PYTHONPATH=src python -c "from repro_torch.parallel.mesh import \\
      spawn_world; print(spawn_world(['-m', 'repro_torch.launch.train', \\
      '--arch', 'qwen2-7b', '--reduced', '--device', 'cpu', '--tp', '2', \\
      '--steps', '4', '--batch', '4', '--seq', '16'], 4)[0])"
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import importlib
import time
from typing import Any, Dict, Optional

import torch

from ..checkpoint.store import CheckpointManager, latest_step
from ..configs import ARCHS, get_config
from ..core import checkpoint_barrier, io_task, task, trace
from ..core.placement import standard_rules
from ..data.pipeline import Prefetcher, SyntheticLMDataset
from ..interop import resolve_device
from ..models import frontends, model_module
from ..optim.schedules import cosine_schedule
from ..parallel.mesh import Mesh, launcher_mesh, single_device_mesh
from ..parallel.sharding import ShardingCtx, distribute_params, layouts
from ..tree import tree_map
from . import steps as steps_mod
from .backend import add_backend_args, execute_traced, validate_backend_args


def _config(arch: str, reduced: bool, remat: str):
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, remat=remat)
    model_module(cfg).check_supported(cfg)
    return cfg


def add_frontend(batch: Dict[str, Any], cfg, n: int, device,
                 seed: int = 0) -> Dict[str, Any]:
    """``batch`` with the frontend's stand-in input of ``cfg``, drawn on
    ``device`` from ``seed`` (the launcher's every step: seed 0, the
    reference's ``train.py:206-210``): a VLM's ``patch_embeds``, an
    encoder-decoder's ``frames``."""
    if cfg.family == "vlm":
        batch["patch_embeds"] = frontends.synth_patches(cfg, n, seed,
                                                        device=device)
    if cfg.is_encoder_decoder:
        batch["frames"] = frontends.synth_frames(cfg, n, seed, device=device)
    return batch


def _batch_on(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


# --------------------------------------------------------------------------
# traced-driver demo tasks (--show-graph): module-level, parameterized by
# literals, so the graph pickles into spawned workers; each rebuilds the
# model and optimizer from the recipe on first use.
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=2)
def _demo_runtime(arch, reduced, remat, mode, lr, warmup, steps, seed,
                  device):
    cfg = _config(arch, reduced, remat)
    # one device, also in a world: the traced demo's runtime is its own
    ctx = ShardingCtx(Mesh(("data", "model"), (1, 1), resolve_device(device)),
                      standard_rules(mode, pod_axis=None))
    opt = steps_mod.make_optimizer(cfg, lr=cosine_schedule(lr, warmup, steps))
    step = steps_mod.make_train_step(cfg, opt, ctx)
    params = model_module(cfg).init_params(cfg, seed, device)
    return cfg, step, params, opt.init(params)


def _demo_load_batch(arch, reduced, seq, batch, step, seed, device):
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    ds = SyntheticLMDataset(cfg.vocab_size, seq, batch, seed=seed)
    # the frontend's input is drawn where the loop draws it (the same
    # numbers), then kept on the host, so the graph's values pickle
    b = add_frontend(ds.batch_at(step), cfg, batch, device)
    return {k: v.cpu() if isinstance(v, torch.Tensor) else v
            for k, v in b.items()}


def _demo_train_step(arch, reduced, remat, mode, lr, warmup, steps, seed,
                     device, b):
    _, step, params, opt_state = _demo_runtime(
        arch, reduced, remat, mode, lr, warmup, steps, seed, device)
    # the step updates in place: step copies, so every call starts from
    # the recipe's state, as the reference's functional step does
    params, opt_state = (tree_map(torch.clone, params),
                         tree_map(torch.clone, opt_state))
    _, _, metrics = step(params, opt_state, _batch_on(b, device))
    return float(metrics["total_loss"])


def _demo_save(loss):
    return loss


demo_load_batch = io_task(_demo_load_batch, cost=0.01, name="load_batch",
                          meta={"idempotent": True})
demo_train_step = task(_demo_train_step, cost=1.0, name="spmd_train_step")
demo_save = io_task(_demo_save, cost=0.05, name="save_ckpt")


def build_runtime(args, device: torch.device) -> Dict[str, Any]:
    """The config, mesh, context, optimizer, parameters, optimizer state and
    train step of a run: on the world's mesh when this process is a rank
    of one (the parameters DTensors, ``standard_rules(--mode)``), else on
    one device (``--tp`` other than 1 raises ``ValueError``)."""
    cfg = _config(args.arch, args.reduced, args.remat)
    mesh = launcher_mesh(args.tp, device)
    world = mesh is not None
    if not world:
        mesh = single_device_mesh(device)
    ctx = ShardingCtx(mesh, standard_rules(args.mode, pod_axis=None))
    opt = steps_mod.make_optimizer(cfg, lr=cosine_schedule(
        args.lr, args.warmup, args.steps))
    step_fn = steps_mod.make_train_step(cfg, opt, ctx)
    M = model_module(cfg)
    params = M.init_params(cfg, args.seed, device)
    if world:
        params = distribute_params(params, M.logical_axes(cfg), ctx)
    return dict(cfg=cfg, mesh=mesh, ctx=ctx, opt=opt, params=params,
                opt_state=opt.init(params), step=step_fn, world=world)


def _say(rt: Dict[str, Any]):
    """``print`` on rank 0 of a world (or without one); a no-op
    elsewhere."""
    if rt["world"] and torch.distributed.get_rank() != 0:
        return lambda *a, **k: None
    return functools.partial(print, flush=True)


def main(argv: Optional[list] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b", choices=ARCHS)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config of the same family")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tp", type=int, default=1,
                    help="model-parallel ways: the mesh is (N / tp, tp) "
                         "over a world of N ranks; only 1 without a world")
    ap.add_argument("--mode", default="fsdp_tp")
    ap.add_argument("--remat", default="selective",
                    choices=["none", "selective", "full"])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--straggler-x", type=float, default=3.0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the CUDA card; "
                         "'cpu' runs the kernels' plain versions)")
    ap.add_argument("--show-graph", action="store_true",
                    help="trace one driver iteration into a task DAG, "
                         "print it, and execute it on --backend")
    add_backend_args(ap)
    args = ap.parse_args(argv)
    validate_backend_args(args)

    device = resolve_device(args.device)
    rt = build_runtime(args, device)
    cfg = rt["cfg"]
    params, opt_state = rt["params"], rt["opt_state"]
    step_fn = rt["step"]
    say = _say(rt)

    start_step = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, every=args.ckpt_every, keep=3)
        if args.resume and latest_step(args.ckpt_dir) is not None:
            tree = {"params": params, "opt": opt_state}
            restored, extra = mgr.restore_latest(
                tree, shardings=layouts(tree) if rt["world"] else None)
            params, opt_state = restored["params"], restored["opt"]
            start_step = int(extra["step"]) + 1
            say(f"resumed from step {extra['step']} "
                f"(data cursor {start_step})")

    ds = SyntheticLMDataset(cfg.vocab_size, args.seq, args.batch,
                            seed=args.seed)
    pf = Prefetcher(ds, start_step=start_step, depth=2)

    # ---- the paper's interface: trace ONE driver iteration into a DAG and
    # execute it on the selected backend (thread = in-process work
    # stealing; process = cluster workers).  The demo runtime draws its own
    # parameters from the recipe, so it cannot touch the loop's.
    traced_loss = None
    if args.show_graph:
        canon = importlib.import_module("repro_torch.launch.train")

        def demo_driver():
            b = canon.demo_load_batch(args.arch, args.reduced, args.seq,
                                      args.batch, start_step, args.seed,
                                      str(device))
            loss = canon.demo_train_step(
                args.arch, args.reduced, args.remat, args.mode, args.lr,
                args.warmup, args.steps, args.seed, str(device), b)
            return checkpoint_barrier(canon.demo_save(loss))

        g, _ = trace(demo_driver)
        say(g.summary())
        say(g.to_dot())
        res, _ = execute_traced(g, args)
        traced_loss = res[g.outputs[0]]
        say(f"traced-driver step loss: {traced_loss:.4f}")

    losses = []
    ewma: Optional[float] = None
    stragglers = 0
    t_total = time.time()
    final_step = start_step
    for s in range(start_step, args.steps):
        batch = add_frontend(_batch_on(pf.next(), device), cfg,
                              args.batch, device)
        t0 = time.time()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["total_loss"])
        dt = time.time() - t0
        if ewma is not None and dt > args.straggler_x * ewma:
            stragglers += 1
            say(f"[straggler] step {s}: {dt:.3f}s vs EWMA {ewma:.3f}s")
        ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
        losses.append(loss)
        final_step = s
        if s % args.log_every == 0:
            say(f"step {s:5d} loss {loss:8.4f} "
                f"aux {float(metrics['aux']):7.4f} "
                f"{dt * 1e3:7.1f} ms")
        if mgr is not None:
            mgr.maybe_save(s, {"params": params, "opt": opt_state},
                           {"step": s})
    if mgr is not None:
        mgr.finish()
    pf.close()
    wall = time.time() - t_total
    say(f"done: steps {start_step}..{final_step} in {wall:.1f}s | "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f} | "
        f"stragglers {stragglers}")
    return {"losses": losses, "params": params, "wall": wall,
            "start_step": start_step, "traced_loss": traced_loss,
            "device": str(device)}


if __name__ == "__main__":
    main()
