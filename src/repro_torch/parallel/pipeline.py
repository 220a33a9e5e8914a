"""Pipeline parallelism over a mesh axis (GPipe-style microbatching).

Port of ``repro/parallel/pipeline.py`` (:32-126).  The stacked-layer tree is
split into ``n_stages`` contiguous stages (:func:`split_stages`); stage
*i* runs on the ranks at coordinate *i* of the stage axis, and microbatches
stream through a ring over that axis (``collectives.ring_permute``, the
reference's ``ppermute`` inside ``shard_map``).  The loop runs P + M − 1
ticks for P stages and M microbatches: at each tick stage 0 takes
microbatch t, a stage that holds a microbatch runs its layers on it, the
last stage writes the microbatch it finished, and every stage passes its
activation on.  At the end the output, which only the last stage holds,
and each stage's aux loss are summed over the stage axis, so every rank
returns them.  The aux loss is thus the layer stack's, as without the
pipeline.  Here the port departs from the reference, which sums only the
last stage's aux (:116-117) and so drops the aux of stages 0 to P − 2 of
an MoE model.
Bubble fraction is (P − 1)/(M + P − 1).

The stage body is ``models.transformer.layer_stack`` on plain per-rank
tensors, so its attention is the flash kernel launched on each rank's
microbatch.  Ranks along the other mesh axes run their
stage redundantly, as the reference's replicated ``in_specs`` do.  It works
for the layer plans the reference's does (dense, MoE with one expert layer
a layer, Mamba1, Mamba2; not the hybrid's shared block, not interleaved
MoE), and runs forward only: the ring carries no gradient.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..kernels import needs_grad
from ..models.config import ModelConfig
from ..tree import tree_leaves, tree_map
from .collectives import psum, ring_permute


def split_stages(params: Dict, n_stages: int, n_layers: int) -> Dict:
    """Reshape stacked layer params (L, ...) -> (S, L/S, ...) (views)."""
    per = n_layers // n_stages
    if per * n_stages != n_layers:
        raise ValueError(f"{n_stages} stages do not divide {n_layers} layers")
    return tree_map(lambda x: x.reshape((n_stages, per) + tuple(x.shape[1:])),
                    params)


def pipelined_forward(cfg: ModelConfig, mesh, *, n_microbatch: int,
                      stage_axis: str = "pod", train: bool = True) -> Callable:
    """Build fn(stage_params, x) -> (activations, aux), running the layer
    stack as a pipeline over ``stage_axis`` of ``mesh``.

    ``stage_params``: the layer tree reshaped to (n_stages, L/stages, ...)
    (:func:`split_stages`); each rank reads its own stage's slice.  ``x``:
    (B, S, d) embedded inputs, the same on every rank (embedding and
    unembedding stay outside).  Returns the (B, S, d) activations in
    ``x.dtype`` and the aux loss summed over the stages and averaged over
    the microbatches.  ``train`` runs the layers as a training forward
    (``cfg.remat``), as the reference's stage body does.
    """
    from ..models import transformer as TF     # models import this package
    n = mesh.shape[stage_axis]

    def stage_fn(layer_params, x):
        # training pipeline: positions are always [0, S) for every microbatch
        B_mb, S_mb = x.shape[0], x.shape[1]
        positions = torch.arange(S_mb, device=x.device).expand(B_mb, S_mb)
        y, aux, _ = TF.layer_stack(layer_params, x, cfg, positions=positions,
                                   train=train)
        return y.to(x.dtype), aux

    def fn(stage_params, x: torch.Tensor) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
        if needs_grad(x, *tree_leaves(stage_params)):
            raise NotImplementedError(
                "the pipeline runs forward only: its ring carries no "
                "gradient; call it under torch.no_grad()")
        B, S, d = x.shape
        if B % n_microbatch:
            raise ValueError(f"{n_microbatch} microbatches do not divide "
                             f"a batch of {B}")
        mb = B // n_microbatch
        stage = mesh.axis_index(stage_axis)
        sp = tree_map(lambda a: a[stage], stage_params)   # this stage's layers
        micro = x.reshape(n_microbatch, mb, S, d)
        out = torch.zeros_like(micro)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        buf = torch.zeros((mb, S, d), dtype=x.dtype, device=x.device)
        for t in range(n_microbatch + n - 1):
            if 0 <= t - stage < n_microbatch:
                # stage 0 injects microbatch t; the others take the ring's
                y, aux = stage_fn(sp, micro[t] if stage == 0 else buf)
                aux_total = aux_total + aux
                if stage == n - 1:        # the last stage writes its output
                    out[t - (n - 1)] = y
            else:
                y = torch.zeros_like(buf)
            buf = ring_permute(y, mesh, stage_axis)
        # the output lives on the last stage, the aux on every stage; sum
        # both so every rank returns them
        last = stage == n - 1
        out = psum(out if last else torch.zeros_like(out), mesh, stage_axis)
        aux_total = psum(aux_total, mesh, stage_axis)
        return out.reshape(B, S, d), aux_total / torch.full(
            (), n_microbatch, dtype=aux_total.dtype, device=x.device)

    return fn


def bubble_fraction(n_stages: int, n_microbatch: int) -> float:
    return (n_stages - 1) / (n_microbatch + n_stages - 1)
