#!/usr/bin/env python3
"""Measure what the training cells' checks in ``chip_smoke.py`` read, on
one card: how far the first step's bf16 loss moves under attention
numerics that are all correct, and how each peak rate moves llava's loss.

    python3 train_check_causes.py gap [--draws 12] [--arch qwen2-7b ...]
    python3 train_check_causes.py lr [--lr 0 1e-5 3e-5 1e-4]

``gap``: each training cell with an attention kernel (``chip_smoke``'s
``TRAIN_CELLS``: qwen2-7b, whisper-tiny, llava-next-34b, at their depth
and batch), its parameters drawn from seed 0.  For each of ``--draws``
batches (``SyntheticLMDataset(seed=0)``'s batch ``d``, its frames or
patches drawn from seed ``d``) the loss (forward only) with every
attention site computed by:

- ``plain``: ``kernels/ref.py::attention`` (float32 scores and P);
- ``kernel``: the flash kernel (wgmma in bf16), and ``kernel_again``;
- ``reference_numerics``: ``layers.attention_scores``, the JAX model's
  numbers (P normalised, then rounded to the compute type before P V);
- ``kernel_numerics``: the kernel's numbers in torch ops (P = exp(s -
  rowmax) rounded to bf16 before P V, the sum of the float32 P dividing);
- ``float32_reorder``: the plain attention with its scale on q, a change
  of float32 rounding and nothing more (exact at head dim 64, where the
  scale is a power of 2);
- for the encoder-decoder, ``only_enc``, ``only_dec``, ``only_cross``: the
  kernel at one site type, the plain attention at the others.

Each variant's gap to ``plain``, relative, per draw, with its mean and
standard deviation.

``lr``: llava-next-34b at ``chip_smoke``'s depth and batch, TRAIN_STEPS
AdamW steps as phase 14d takes them (``cosine_schedule(lr, 1,
TRAIN_STEPS)``), from the same draw, at each ``--lr``; rate 0 gives the
batches' own spread.

Prints the card's name and power limit first, then one JSON line per draw
or run and one summary line per cell.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def _attention_variants(torch):
    from repro_torch.kernels import ops, ref
    from repro_torch.models.layers import attention_scores
    kernel_fn = ops.flash_attention

    def kernel(q, k, v, causal=True, impl="kernel"):
        return kernel_fn(q, k, v, causal=causal, impl="kernel")

    def plain(q, k, v, causal=True, impl="kernel"):
        return ref.attention(q, k, v, causal=causal)

    def reference_numerics(q, k, v, causal=True, impl="kernel"):
        return attention_scores(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2),
                                causal=causal).transpose(1, 2)

    def scores(q, k, causal, scale_on_q=False):
        H, D = q.shape[1], q.shape[-1]
        if k.shape[1] != H:
            k = torch.repeat_interleave(k, H // k.shape[1], dim=1)
        if scale_on_q:
            s = torch.einsum("bhqd,bhkd->bhqk", q.float() * D ** -0.5,
                             k.float())
        else:
            s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                             k.float()) * D ** -0.5
        if causal:
            qpos = torch.arange(q.shape[2], device=q.device)[:, None]
            kpos = torch.arange(k.shape[2], device=q.device)[None, :]
            s = torch.where(kpos <= qpos, s, -math.inf)
        return s

    def values(v, H):
        if v.shape[1] != H:
            v = torch.repeat_interleave(v, H // v.shape[1], dim=1)
        return v.float()

    def kernel_numerics(q, k, v, causal=True, impl="kernel"):
        s = scores(q, k, causal)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        o = torch.einsum("bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(),
                         values(v, q.shape[1]))
        return (o / p.sum(-1, keepdim=True)).to(q.dtype)

    def float32_reorder(q, k, v, causal=True, impl="kernel"):
        p = torch.softmax(scores(q, k, causal, scale_on_q=True), dim=-1)
        return torch.einsum("bhqk,bhkd->bhqd", p,
                            values(v, q.shape[1])).to(q.dtype)

    def only(which):
        def at_site(q, k, v, causal=True, impl="kernel"):
            kind = ("dec" if causal else
                    "enc" if q.shape[2] == k.shape[2] else "cross")
            return (kernel if kind == which else plain)(q, k, v,
                                                        causal=causal)
        return at_site

    variants = {"kernel": kernel, "kernel_again": kernel,
                "reference_numerics": reference_numerics,
                "kernel_numerics": kernel_numerics,
                "float32_reorder": float32_reorder}
    encdec_only = {f"only_{w}": only(w) for w in ("enc", "dec", "cross")}
    return ops, plain, variants, encdec_only


@contextlib.contextmanager
def _sites_compute(ops, fn):
    inner = ops.flash_attention
    ops.flash_attention = fn
    try:
        yield
    finally:
        ops.flash_attention = inner


def gap(torch, cs, archs, draws: int) -> None:
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.launch.train import add_frontend
    from repro_torch.models import model_module
    ops, plain, variants, encdec_only = _attention_variants(torch)
    for arch in archs:
        cfg, _, _, n_batch, seq = cs._train_cell(arch)
        params = model_module(cfg).init_params(cfg, 0, "cuda")
        loss_fn = model_module(cfg).make_loss_fn(cfg, impl="kernel")
        ds = SyntheticLMDataset(cfg.vocab_size, seq, n_batch, seed=0)
        run = {**variants, **(encdec_only if cfg.is_encoder_decoder else {})}
        rows = []
        t0 = time.perf_counter()
        for d in range(draws):
            batch = add_frontend({k: torch.as_tensor(v, device="cuda")
                                  for k, v in ds.batch_at(d).items()},
                                 cfg, n_batch, "cuda", seed=d)
            row = {"draw": d}
            with torch.no_grad():
                for name, fn in {"plain": plain, **run}.items():
                    with _sites_compute(ops, fn):
                        row[name] = loss_fn(params, batch)[0].item()
            rows.append(row)
            print(f"row: {json.dumps({'arch': arch, **row})}", flush=True)
        summary = {}
        for name in run:
            g = [(r[name] - r["plain"]) / abs(r["plain"]) for r in rows]
            mean = sum(g) / len(g)
            summary[name] = {
                "rel_gaps": g, "mean": mean,
                "sd": math.sqrt(sum((x - mean) ** 2 for x in g)
                                / max(len(g) - 1, 1)),
                "max_abs": max(abs(x) for x in g),
                "over_train_loss_tol": sum(abs(x) > cs.TRAIN_LOSS_TOL
                                           for x in g)}
        out = {"arch": arch, "layers": cfg.n_layers, "batch": n_batch,
               "seq": seq, "draws": draws,
               "seconds": time.perf_counter() - t0,
               "train_loss_tol": cs.TRAIN_LOSS_TOL, "summary": summary}
        print(f"gap: {json.dumps(out)}", flush=True)
        del params
        gc.collect()
        torch.cuda.empty_cache()


def lr(torch, cs, rates) -> None:
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.launch import steps
    from repro_torch.launch.train import add_frontend
    from repro_torch.models import model_module
    from repro_torch.optim.schedules import cosine_schedule
    cfg, _, _, n_batch, seq = cs._train_cell(cs.VLM_ARCH)
    ds = SyntheticLMDataset(cfg.vocab_size, seq, n_batch, seed=0)
    frontend = add_frontend({}, cfg, n_batch, "cuda")
    for rate in rates:
        params = model_module(cfg).init_params(cfg, 0, "cuda")
        opt = steps.make_optimizer(cfg, lr=cosine_schedule(
            rate, 1, cs.TRAIN_STEPS))
        state = opt.init(params)
        step = steps.make_train_step(cfg, opt)
        losses = []
        for s in range(cs.TRAIN_STEPS):
            batch = {**{k: torch.as_tensor(v, device="cuda")
                        for k, v in ds.batch_at(s).items()}, **frontend}
            params, state, metrics = step(params, state, batch)
            losses.append(metrics["total_loss"].item())
        out = {"arch": cfg.name, "layers": cfg.n_layers, "lr": rate,
               "losses": losses}
        print(f"lr: {json.dumps(out)}", flush=True)
        del params, state, step, opt, metrics
        gc.collect()
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="what", required=True)
    g = sub.add_parser("gap")
    g.add_argument("--draws", type=int, default=12)
    g.add_argument("--arch", nargs="+", default=None)
    r = sub.add_parser("lr")
    r.add_argument("--lr", type=float, nargs="+",
                   default=[0.0, 1e-5, 3e-5, 1e-4])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("train_check_causes: no CUDA device is available",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if args.what == "gap":
        gap(torch, cs, args.arch or [cs.DENSE_ARCH, cs.ENCDEC_ARCH,
                                     cs.VLM_ARCH], args.draws)
    else:
        lr(torch, cs, args.lr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
