"""The reference's training steps: the loss and its gradients (each layer
recomputed in the backward, so that one layer's activations live at a
time) of the configuration's family, and its optimizer's step, in float32
with TF32 off.

:func:`follow` runs the first steps of a cell from the benchmark's weights
on the benchmark's batches and returns what the comparison reads: each
step's loss, each leaf's first gradient as the optimizer takes it (after
the clip), each leaf's change after the last step.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import weights
from ..tree import flatten, nest
from . import family, optimizer


def loss_and_grads(params: Dict[str, torch.Tensor], tokens, labels,
                   cfg: Dict, precision: str
                   ) -> Tuple[float, Dict[str, torch.Tensor]]:
    leaves = {p: t.detach().requires_grad_() for p, t in params.items()}

    def run_layer(fn, x):
        return checkpoint(fn, x, use_reentrant=False)

    with torch.enable_grad():
        loss = family(cfg).loss(nest(leaves), tokens, labels, cfg,
                                precision, run_layer)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.item(), dict(zip(leaves, grads))


def norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {p: torch.linalg.vector_norm(t).item() for p, t in tree.items()}


def follow(cfg: Dict, opt: Dict, seed: int, batches: List[Tuple],
           precision: str, device) -> Dict:
    """``len(batches)`` steps of the optimizer ``opt`` (its settings, with
    ``kind`` and ``lr``) from the weights of ``seed``: ``losses``,
    ``first_grad`` (each leaf's norm after the clip) and ``change`` (each
    leaf's norm of its change after the last step).  ``batches`` are
    (tokens, labels) pairs on ``device``."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        params = weights.draw(cfg, seed, device)
        optim = optimizer(opt).Optimizer(params, opt)
        losses, first_grad = [], None
        for tokens, labels in batches:
            loss, grads = loss_and_grads(params, tokens, labels, cfg,
                                         precision)
            losses.append(loss)
            optim.step(params, grads)
            if first_grad is None:
                first_grad = norms(grads)
            del grads
        del optim
        start = weights.draw(cfg, seed, device)
        change = {p: torch.linalg.vector_norm(params[p] - start[p]).item()
                  for p in flatten(nest(params))}
        return {"losses": losses, "first_grad": first_grad,
                "change": change}
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
