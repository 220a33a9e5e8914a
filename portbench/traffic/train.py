"""Closed-loop training: the port's train step called back to back on
batches drawn from the seed.

Set-up builds the step as ``launch/train.py::build_runtime`` builds it on
one device (the configuration cut in depth by ``cut_depth``,
``steps.make_optimizer``, ``steps.make_train_step`` on the one-device mesh
with ``standard_rules("fsdp_tp")``, selective remat), hands it the
benchmark's weights and the optimizer's fresh state, and runs the mix's
compared steps through it: they warm up every shape the window uses, and
they are what the reference follows. The window then calls the same step on
fresh batches until ``--seconds`` have passed, each step's batch copied in
from the host and its loss read back, as ``launch/train.py::main`` does.
With ``--trace 1`` a few more steps run under ``torch.profiler`` after the
window. Once the window's numbers are read and the program's state is
freed, the reference follows the compared steps from the same weights on
the same batches.

A mix's parameters: ``batch`` and ``seq`` (each step's tokens), ``zipf_a``
(the tokens' Zipf exponent, as the port's synthetic dataset draws them),
``compared_steps`` and ``traced_steps``.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import statistics
import time
from typing import Dict

import numpy as np

from .. import compare, harness, optimizers, trace, weights
from ..reference import train as reference
from ..tree import flatten, leaves, nest


def tokens_at(traffic: Dict, vocab: int, seed: int, step: int) -> np.ndarray:
    """Step ``step``'s (batch, seq) int32 tokens of the seed: Zipf-
    distributed ids in [1, vocab − 2], every step's rows its own."""
    rng = np.random.default_rng([seed % (1 << 64), step])
    z = rng.zipf(traffic["zipf_a"], size=(traffic["batch"], traffic["seq"]))
    return ((z % (vocab - 2)) + 1).astype(np.int32)


def port_config(config: Dict):
    """The port's config of this configuration file: its published config
    cut in depth, with the file's remat; it must hold every value the file
    states under a field of the port's config (its ``name`` aside)."""
    from repro_torch import configs
    from repro_torch.models.config import cut_depth
    cfg = cut_depth(configs.get_config(config["port_arch"]),
                    config["n_layers"])
    cfg = dataclasses.replace(cfg, remat=config["remat"])
    fields = {f.name for f in dataclasses.fields(cfg)} - {"name"}
    wrong = {k: (getattr(cfg, k), config[k]) for k in sorted(fields)
             if k in config and getattr(cfg, k) != config[k]}
    if wrong:
        raise ValueError(f"the port's {config['port_arch']} differs from "
                         f"the configuration file: {wrong}")
    return cfg


def _check_tree(cfg, config: Dict) -> None:
    from repro_torch.models import model_module
    port = {p: tuple(s.shape) for p, s in
            flatten(model_module(cfg).param_specs(cfg)).items()}
    mine = {leaf.path: leaf.shape for leaf in leaves(config)}
    if port != mine:
        raise ValueError(f"the port's parameter tree differs from the "
                         f"benchmark's: {sorted(set(port.items()) ^ set(mine.items()))}")


def _check_optimizer(opt, config: Dict) -> None:
    want = dict(config["optimizer"])
    kind = want.pop("kind")
    got = {k: getattr(opt, k) for k in want}
    if type(opt).__name__ != kind or got != want:
        raise ValueError(f"the port's optimizer {type(opt).__name__} {got} "
                         f"is not the configuration file's {kind} {want}")


def _norms(torch, tree: Dict) -> Dict[str, float]:
    return {p: torch.linalg.vector_norm(t.float()).item()
            for p, t in flatten(tree).items()}


def build(cell: Dict, dev):
    """The program's train step and optimizer for the cell, built as the
    launcher builds them on one device."""
    from repro_torch.launch import steps
    from repro_torch.parallel.mesh import single_device_mesh
    from repro_torch.parallel.sharding import ShardingCtx
    from repro_torch.core.placement import standard_rules
    config = cell["config"]
    cfg = port_config(config)
    _check_tree(cfg, config)
    opt = steps.make_optimizer(cfg, lr=config["lr"])
    _check_optimizer(opt, config)
    step = steps.make_train_step(cfg, opt, ShardingCtx(
        single_device_mesh(dev), standard_rules("fsdp_tp", pod_axis=None)))
    return opt, step


def batches(cell: Dict, seed: int, dev):
    """Step ``s``'s batch on ``dev``: the tokens copied in from the host,
    the labels the same tokens (the loss shifts them)."""
    import torch
    mix, vocab = cell["traffic"], cell["config"]["vocab_size"]

    def batch(s):
        t = torch.as_tensor(tokens_at(mix, vocab, seed, s), device=dev)
        return {"tokens": t, "labels": t}
    return batch


def first_steps(cell: Dict, opt, step, seed: int, dev):
    """The benchmark's weights and a fresh optimizer state, driven through
    the mix's compared steps: returns the parameters, the state and what
    the comparison reads of the program (each step's loss, each leaf's
    first gradient as the optimizer's state holds it, each leaf's
    change)."""
    import torch
    config = cell["config"]
    batch = batches(cell, seed, dev)
    params = nest(weights.draw(config, seed, dev))
    state = opt.init(params)
    program = {"losses": []}
    for s in range(cell["traffic"]["compared_steps"]):
        params, state, m = step(params, state, batch(s))
        program["losses"].append(float(m["total_loss"]))
        if s == 0:
            program["first_grad"] = _norms(torch, optimizers.reader(
                config["optimizer"]).first_grad(state, opt))
    start = weights.draw(config, seed, dev)
    program["change"] = {
        p: torch.linalg.vector_norm(t - start[p]).item()
        for p, t in flatten(params).items()}
    return params, state, program


def follow(cell: Dict, seed: int, dev, precision: str = "float32") -> Dict:
    """The reference's compared steps from the same weights and batches."""
    config = cell["config"]
    batch = batches(cell, seed, dev)
    return reference.follow(
        config, config["optimizer"] | {"lr": config["lr"]}, seed,
        [(b["tokens"], b["labels"]) for b in
         map(batch, range(cell["traffic"]["compared_steps"]))],
        precision, dev)


def free(torch, cuda: bool) -> None:
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def run(cell: Dict, seed: int, seconds: float, traced: bool, device: str,
        started: float) -> Dict:
    """One run of a training cell; returns the result line's parts without
    ``limits``, the compared ``numbers`` and the window's readings."""
    import torch
    from repro_torch import kernels

    mix = cell["traffic"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    opt, step = build(cell, dev)
    batch = batches(cell, seed, dev)
    params, state, program = first_steps(cell, opt, step, seed, dev)
    compared = mix["compared_steps"]
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    # ---- the window
    window_losses, host_s, ends = [], [], []
    t0_wall = time.time()
    t0 = time.perf_counter()
    while True:
        b = batch(compared + len(window_losses))
        h0 = time.perf_counter()
        params, state, m = step(params, state, b)
        host_s.append(time.perf_counter() - h0)
        window_losses.append(float(m["total_loss"]))
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= seconds:
            break
    window_s = ends[-1] - t0
    steps_ms = [1e3 * (e - s) for s, e in zip([t0] + ends, ends)]
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    n = len(window_losses)
    result = {
        "attempted": compared + n,
        "failed": sum(1 for x in program["losses"] + window_losses
                      if not math.isfinite(x)),
        "window": {"steps": n, "seconds": window_s,
                   "tokens": n * mix["batch"] * mix["seq"],
                   "host_ms": 1e3 * statistics.fmean(host_s),
                   "step_ms": [min(steps_ms), statistics.median(steps_ms),
                               max(steps_ms)]},
        "setup_s": t0_wall - started, "peak_bytes": peak}

    if traced:
        before = kernels.launch_counts()
        with trace.profiled(torch) as prof:
            with trace.span(torch, "window"):
                for s in range(mix["traced_steps"]):
                    with trace.span(torch, "batch_copy"):
                        b = batch(compared + n + s)
                    with trace.span(torch, "step_enqueue"):
                        params, state, m = step(params, state, b)
                    with trace.span(torch, "loss_read"):
                        float(m["total_loss"])
        after = kernels.launch_counts()
        result["trace"] = trace.reduce(
            prof, {k: after[k] - before.get(k, 0) for k in after},
            mix["traced_steps"])
        del prof

    # ---- the program's state freed, the reference follows the first steps
    del params, state, m, step, b
    free(torch, cuda)
    ref = follow(cell, seed, dev)
    result["program"], result["reference"] = program, ref
    result["numbers"] = compare.numbers(program, ref)
    return result


def metrics(cell: Dict, result: Dict, traced: bool) -> Dict:
    """The result line's metrics: the cell's end-to-end metrics untraced,
    its per-layer metrics traced."""
    w = result["window"]
    if not traced:
        values = {"train_tokens_per_s": w["tokens"] / w["seconds"],
                  "setup_s": result["setup_s"]}
        return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                for m in cell["end_to_end"]}
    rec = result["trace"]
    rec.config, rec.traffic, rec.window = cell["config"], cell["traffic"], w
    rec.peak_bytes = result["peak_bytes"]
    out = {}
    for m in cell["per_layer"]:
        value = harness.metric_reader(m["name"])(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
