"""Step builders shared by the launchers: the optimizer of a config and the
train step.

Port of ``repro/launch/steps.py`` (``make_optimizer`` :50,
``make_train_step`` :99).  The dry-run's cases (``Case``, ``build_case``,
``lower_case``) and the sharding helpers come with intra-op SPMD and the
dry-run (ROADMAP §1 items 8-9).
"""
from __future__ import annotations

from typing import Callable, Optional

from ..models import model_module
from ..models import transformer as TF
from ..models.config import ModelConfig
from ..optim import Adafactor, AdamW
from ..parallel.sharding import ShardingCtx


def make_optimizer(cfg: ModelConfig, lr=3e-4):
    if cfg.name.startswith("llama4"):
        return Adafactor(lr=lr)        # Adam state cannot fit
    return AdamW(lr=lr, weight_decay=0.1)


def make_train_step(cfg: ModelConfig, optimizer,
                    ctx: Optional[ShardingCtx] = None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics), the
    parameters and optimizer state updated in place.

    The reference pins the gradients to the parameters' layout when
    ``cfg.shard_grads`` (a reduce-scatter instead of an all-reduce); on one
    device there is no layout to pin, so ``ctx`` changes nothing here.
    The loss is the encoder-decoder's (``models/encdec.py``; its batch
    carries ``frames``) or the decoder-only LM's (``models/transformer.py``;
    a VLM's carries ``patch_embeds``), as the reference dispatches it."""
    M = model_module(cfg)
    M.check_supported(cfg)
    grad_fn = TF.value_and_grad(M.make_loss_fn(cfg))

    def train_step(params, opt_state, batch):
        (total, metrics), grads = grad_fn(params, batch)
        opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, dict(metrics, total_loss=total)

    return train_step
