"""Step builders shared by the launchers: the optimizer of a config, the
train step and the sharding helpers.

Port of ``repro/launch/steps.py`` (``make_optimizer`` :50, ``make_rules``
:60, ``make_train_step`` :99, ``_fit_sharding`` and ``fit_case_shardings``
:222-253, the latter two as functions of shapes, specs and a mesh).  The
dry-run's cases (``Case``, ``build_case``, ``lower_case``) and
``opt_state_shardings`` come with the dry-run (ROADMAP §1 item 9), which
can build its cases on ``make_train_step(cfg, optimizer, ctx)``.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

from ..core.placement import Spec, fit_spec, standard_rules
from ..models import model_module
from ..models import transformer as TF
from ..models.config import ModelConfig
from ..optim import Adafactor, AdamW
from ..parallel.sharding import ShardingCtx
from ..tree import tree_map


def make_optimizer(cfg: ModelConfig, lr=3e-4):
    if cfg.name.startswith("llama4"):
        return Adafactor(lr=lr)        # Adam state cannot fit
    return AdamW(lr=lr, weight_decay=0.1)


def make_rules(mesh, mode: str, global_batch: int):
    """The rule table of ``mode`` on ``mesh``; a batch that the batch axes
    do not divide (long_500k's B = 1) is replicated, TP and FSDP kept."""
    pod = "pod" if "pod" in mesh.axis_names else None
    rules = standard_rules(mode, pod_axis=pod)
    batch_ways = mesh.shape["data"] * (mesh.shape["pod"] if pod else 1)
    if global_batch % batch_ways != 0:
        rules = [("batch", None), ("expert_group", None)] + \
            [r for r in rules if r[0] not in ("batch", "expert_group")]
    return rules


def _fit_sharding(shape: Tuple[int, ...], spec: Spec, mesh) -> Spec:
    """``spec`` without the mesh axes whose shard count does not divide
    their dim of ``shape`` (``core.placement.fit_spec``): a jit's I/O
    shardings need exact divisibility in the reference."""
    return fit_spec(shape, spec, mesh)


def fit_case_shardings(shapes: Any, specs: Any, mesh) -> Any:
    """:func:`_fit_sharding` at each leaf of a tree of shapes and the tree
    of their specs."""
    return tree_map(lambda shape, spec: _fit_sharding(shape, spec, mesh),
                    shapes, specs)


# the logical axes of each batch entry, laid out on the mesh as the
# reference's batch is (its frames and patches by batch and sequence)
BATCH_AXES = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
              "frames": ("batch", "seq", None),
              "patch_embeds": ("batch", "seq", "d_model")}


def _reduce_grad(g, p, shard_grads: bool):
    """A gradient of the world path laid out for the update: with
    ``shard_grads`` in its parameter's placements (a partial sum over the
    batch becomes a reduce-scatter to the shard each rank owns), else each
    partial sum all-reduced (replicated there)."""
    from torch.distributed.tensor import Replicate
    if shard_grads:
        want = p.placements
    else:
        want = [Replicate() if q.is_partial() else q for q in g.placements]
    return g.redistribute(g.device_mesh, want)


def make_train_step(cfg: ModelConfig, optimizer,
                    ctx: Optional[ShardingCtx] = None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics), the
    parameters and optimizer state updated in place.

    With ``ctx`` over a ``torch.distributed`` world (the launchers' world
    path: DTensor parameters) the batch is laid out on its mesh
    (``BATCH_AXES``), the loss constrains its activations by ``ctx``, and
    each gradient is all-reduced where it is a partial sum, or, when
    ``cfg.shard_grads``, redistributed to its parameter's placements: a
    reduce-scatter instead of an all-reduce (the reference pins the
    gradients to the parameters' layout, ``repro/launch/steps.py:99-124``).
    The loss is the encoder-decoder's (``models/encdec.py``; its batch
    carries ``frames``) or the decoder-only LM's (``models/transformer.py``;
    a VLM's carries ``patch_embeds``), as the reference dispatches it."""
    M = model_module(cfg)
    M.check_supported(cfg)
    grad_fn = TF.value_and_grad(M.make_loss_fn(cfg, ctx))
    world = ctx is not None and ctx.distributed

    def train_step(params, opt_state, batch):
        if world:
            batch = {k: ctx.fit(v, BATCH_AXES[k]) for k, v in batch.items()}
        (total, metrics), grads = grad_fn(params, batch)
        if world:
            grads = tree_map(lambda g, p: _reduce_grad(g, p, cfg.shard_grads),
                             grads, params)
        opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, dict(metrics, total_loss=total)

    return train_step
