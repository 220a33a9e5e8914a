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
MoE).

Training (the reference differentiates its pipeline with ``jax.grad``).
When ``x`` or a parameter requires grad, each rank's ticks are one autograd
node (``_Pipeline``), entered through ``collectives.copy_to`` and left
through ``collectives.reduce_from``.  Its forward runs the ticks as above
and keeps each tick's graph: the stage on inputs detached from the rest
(this stage's parameter slices, the microbatch or the received buffer),
and the hop of its activation, ``collectives.ring_hop``; an idle tick
hops a zero leaf, so that it too has a node there.  Its backward runs the
ticks in reverse, as GPipe does, one ``torch.autograd.backward`` a tick
(the stage slices' gradients summed in place over the ticks), given
the gradient of what the tick sent (the next tick's input gradient on this
rank), of the microbatch it wrote (last stage) and of its aux.  The hop's
backward sends the gradient back along the ring, so every rank issues the
same P + M − 1 backward hops in the same order, whichever ticks it idled:
an autograd graph across ticks would leave idle ticks without a node and
let the engine order independent branches differently on two ranks, and
the ranks would wait on each other for ever.  The gradients are those of
the one loss every rank computes alike on the returned ``(y, aux)``:

- ``reduce_from``'s backward is the identity: each rank's part of ``y`` and
  of the aux reaches the loss once, through the sum (an all-reduce there
  would count the gradient once for each of the P stages);
- this rank's stage slice gets the sum over its microbatches of the layer
  stack's gradient, each microbatch's aux weighted 1/M as in the forward;
  the other stages' slices get zero here, since every rank holds the whole
  stacked tree (:func:`split_stages` gives views), so a ``psum_tree`` of
  the gradient over the stage axis gives the whole of it.  Ranks along the
  other axes get equal gradients, nothing summed over them;
- ``x`` is replicated and only stage 0 reads it: ``copy_to``'s backward
  sums its gradient over the stage axis, so every rank gets the whole dx.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from ..kernels import needs_grad
from ..models.config import ModelConfig
from ..tree import tree_leaves, tree_map, tree_unflatten
from .collectives import copy_to, reduce_from, ring_hop


def split_stages(params: Dict, n_stages: int, n_layers: int) -> Dict:
    """Reshape stacked layer params (L, ...) -> (S, L/S, ...) (views)."""
    per = n_layers // n_stages
    if per * n_stages != n_layers:
        raise ValueError(f"{n_stages} stages do not divide {n_layers} layers")
    return tree_map(lambda x: x.reshape((n_stages, per) + tuple(x.shape[1:])),
                    params)


class _Ticks:
    """This rank's P + M − 1 ticks over one stacked tree: ``forward`` runs
    them, keeping each tick's graph when asked; ``backward`` runs the kept
    graphs in reverse."""

    def __init__(self, stage_fn: Callable, like: Dict, mesh, axis: str,
                 n_microbatch: int):
        self.stage_fn, self.like = stage_fn, like
        self.mesh, self.axis, self.n_micro = mesh, axis, n_microbatch
        self.n = mesh.shape[axis]
        self.stage = mesh.axis_index(axis)

    def forward(self, x: torch.Tensor, leaves: Sequence[torch.Tensor],
                needs: Sequence[bool] = ()) -> Tuple:
        """``(out, aux, tape)``: the microbatches this rank finished, (M,
        B/M, S, d), zero off the last stage; this stage's aux summed over
        its microbatches; and, when ``needs`` (whether ``x`` and each leaf
        need a gradient) has one, each tick's graph for :meth:`backward`,
        else ``None``."""
        n, stage, M = self.n, self.stage, self.n_micro
        record = any(needs)
        B, S, d = x.shape
        sl = [a[stage] for a in leaves]              # this stage's layers
        if record:
            sl = [a.detach().requires_grad_(r) for a, r in zip(sl, needs[1:])]
        sp = tree_unflatten(self.like, sl)
        micro = x.reshape(M, B // M, S, d)
        out = torch.zeros_like(micro)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        buf = torch.zeros_like(micro[0])
        ticks = []
        for t in range(M + n - 1):
            m = t - stage
            if 0 <= m < M:
                # stage 0 injects microbatch t; the others take the ring's
                xin = micro[m] if stage == 0 else buf
                if record:
                    xin = xin.detach().requires_grad_(stage > 0 or needs[0])
                y, aux = self.stage_fn(sp, xin)
                aux_total = aux_total + aux.detach()
                if stage == n - 1:        # the last stage writes its output
                    out[m] = y.detach()
            else:
                xin = aux = None
                y = torch.zeros_like(buf).requires_grad_(record)
            sent = ring_hop(y, self.mesh, self.axis)
            if record:
                ticks.append((xin, y, aux, sent))
            buf = sent.detach()
        return out, aux_total, ((ticks, sl) if record else None)

    def backward(self, tape: Tuple, g_out: torch.Tensor,
                 g_aux: torch.Tensor) -> Tuple:
        """``(dx, grads)`` from :meth:`forward`'s ``tape``: the gradient of
        ``x`` in microbatches, (M, B/M, S, d), zero off stage 0, and of
        each of this stage's leaf slices (``None`` where none was asked
        for or none reached it).  The slices' gradients accumulate in their
        ``.grad``, in place, tick by tick."""
        ticks, sl = tape
        n, stage = self.n, self.stage
        want = [a for a in sl if a.requires_grad]
        dx = torch.zeros_like(g_out)
        g_sent = torch.zeros_like(ticks[0][3])
        while ticks:
            t = len(ticks) - 1
            xin, y, aux, sent = ticks.pop()       # frees the tick's graph
            m = t - stage
            if xin is None:                       # an idle tick: the hop
                torch.autograd.backward([sent], [g_sent], inputs=[y])
                g_sent = torch.zeros_like(g_sent)
                continue
            outs, gs = [sent], [g_sent]
            if stage == n - 1:
                outs.append(y)
                gs.append(g_out[m])
            if aux.requires_grad:
                outs.append(aux)
                gs.append(g_aux.to(aux.dtype))
            torch.autograd.backward(
                outs, gs, inputs=([xin] if xin.requires_grad else []) + want)
            g_in = xin.grad
            if stage == 0 and g_in is not None:
                dx[m] = g_in
            # what this tick received is what the tick before it sent
            g_sent = (g_in if stage > 0 and g_in is not None
                      else torch.zeros_like(g_sent))
        grads = [a.grad for a in sl]
        for a in sl:
            a.grad = None
        return dx, grads

    def place(self, g, shape) -> torch.Tensor:
        """This stage's slice gradient ``g`` in a gradient of the stacked
        leaf's ``shape``, zero on the other stages (``None`` for none)."""
        if g is None:
            return None
        if self.n == 1:
            return g.unsqueeze(0)
        whole = g.new_zeros(shape)
        whole[self.stage] = g
        return whole


class _Pipeline(torch.autograd.Function):
    """This rank's ticks as one autograd node; see the module's
    docstring."""

    @staticmethod
    def forward(ctx, ticks: _Ticks, x, *leaves):
        with torch.enable_grad():
            out, aux, ctx.tape = ticks.forward(x, leaves,
                                               ctx.needs_input_grad[1:])
        ctx.ticks = ticks
        ctx.shapes = [a.shape for a in leaves]
        return out, aux

    @staticmethod
    @once_differentiable
    def backward(ctx, g_out, g_aux):
        dx, grads = ctx.ticks.backward(ctx.tape, g_out, g_aux)
        ctx.tape = None
        return (None, dx.reshape(-1, *dx.shape[2:])
                if ctx.needs_input_grad[1] else None,
                *(ctx.ticks.place(g, shape)
                  for g, shape in zip(grads, ctx.shapes)))


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
    (``cfg.remat``), as the reference's stage body does.  Under autograd
    the gradients are those the module's docstring gives: this stage's
    slice of each leaf (``psum_tree`` them over ``stage_axis`` for the
    whole) and the whole dx on every rank.
    """
    from ..models import transformer as TF     # models import this package

    def stage_fn(layer_params, x):
        # training pipeline: positions are always [0, S) for every microbatch
        B_mb, S_mb = x.shape[0], x.shape[1]
        positions = torch.arange(S_mb, device=x.device).expand(B_mb, S_mb)
        y, aux, _ = TF.layer_stack(layer_params, x, cfg, positions=positions,
                                   train=train)
        return y.to(x.dtype), aux

    def fn(stage_params, x: torch.Tensor) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
        B, S, d = x.shape
        if B % n_microbatch:
            raise ValueError(f"{n_microbatch} microbatches do not divide "
                             f"a batch of {B}")
        leaves = tree_leaves(stage_params)
        ticks = _Ticks(stage_fn, stage_params, mesh, stage_axis,
                       n_microbatch)
        if needs_grad(x, *leaves):
            out, aux = _Pipeline.apply(ticks, copy_to(x, mesh, stage_axis),
                                       *leaves)
        else:
            out, aux, _ = ticks.forward(x, leaves)
        # the output lives on the last stage, the aux on every stage; sum
        # both so every rank returns them
        out = reduce_from(out, mesh, stage_axis)
        aux = reduce_from(aux, mesh, stage_axis)
        return out.reshape(B, S, d), aux / torch.full(
            (), n_microbatch, dtype=aux.dtype, device=x.device)

    return fn


def bubble_fraction(n_stages: int, n_microbatch: int) -> float:
    return (n_stages - 1) / (n_microbatch + n_stages - 1)
