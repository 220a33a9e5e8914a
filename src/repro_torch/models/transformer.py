"""The port's decoder-only LM over stacked layers, for plan kinds ``attn``
(dense, no experts), ``mamba1``, ``mamba2`` and ``mamba2_shared`` (the
zamba2 hybrid): forward, loss and gradients.

Port of ``repro/models/transformer.py``.  Parameters keep the reference's
tree: nested dicts with a leading ``n_layers`` dim on every per-layer leaf,
so a tree made by ``repro.models.transformer.init_params`` and carried
across with ``interop.params_from_numpy`` runs here unchanged.  The
reference's ``lax.scan`` over the stacked layers becomes a Python loop over
per-layer views (``tree.unstack_layers``), so zamba2's shared transformer
block (one unstacked parameter set, applied after every
``shared_attn_every``-th layer) is placed by the loop's static index, as
the reference's unrolled path places it; its KV caches are the
``cache["shared"]`` slots, one a site.

Training (``forward(train=True)``, ``make_loss_fn``; the train step is
``launch/steps.py``'s) follows the reference's remat modes with
``torch.utils.checkpoint``, and takes gradients with
``torch.autograd.grad`` over the parameter leaves (:func:`value_and_grad`),
functional like ``jax.value_and_grad``.  With
``impl="kernel"`` the attention's gradient goes through the flash kernel's
autograd Function, and Mamba1's through the scan's (``SSMScan``: the scan
kernel forward, the scan's backward kernel); Mamba2's SSD is torch ops.

This slice runs the dense transformer family (qwen2-7b, qwen3-14b,
granite-20b, yi-9b, llava-next-34b's backbone), the attention-free Mamba1
family (falcon-mamba-7b) and the Mamba2 hybrid (zamba2-7b).  MoE and the
encoder-decoder raise ``NotImplementedError`` naming the ROADMAP item that
brings them.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..interop import Device, resolve_device
from ..tree import tree_leaves, tree_map, tree_unflatten, unstack_layers
from .config import ModelConfig
from .layers import (apply_norm, attention_block, embed_tokens,
                     init_attention, init_embed, init_mlp, init_norm,
                     init_param, mlp_block, unembed)
from .ssm import (init_mamba1, init_mamba2, mamba1_block, mamba1_decode_cache,
                  mamba2_block, mamba2_decode_cache)


# --------------------------------------------------------------------------
# plan helpers
# --------------------------------------------------------------------------

def _plan_kind(cfg: ModelConfig) -> str:
    kinds = set(cfg.layer_plan)
    if kinds == {"attn"}:
        return "attn"
    if kinds == {"mamba1"}:
        return "mamba1"
    if kinds == {"mamba2"}:
        return "mamba2"
    if kinds <= {"mamba2", "mamba2+shared_attn"}:
        return "mamba2_shared"
    raise ValueError(f"unsupported layer plan {kinds} (scan needs homogeneity)")


def _n_shared_sites(cfg: ModelConfig) -> int:
    return sum(1 for p in cfg.layer_plan if p == "mamba2+shared_attn")


def check_supported(cfg: ModelConfig) -> str:
    """The plan kind of ``cfg`` if this port runs it, else raise
    ``NotImplementedError`` naming the ROADMAP item that brings it."""
    kind = _plan_kind(cfg)
    if cfg.is_encoder_decoder:
        what = "encoder-decoder models: ROADMAP §1 item 7"
    elif kind != "attn" or not cfg.n_experts:
        return kind
    else:
        what = "MoE layers: ROADMAP §1 item 7"
    raise NotImplementedError(
        f"{cfg.name}: layer plan {kind!r} is not ported yet; it comes with "
        f"{what}")


def param_specs(cfg: ModelConfig) -> Dict:
    """The parameter tree of ``cfg`` with a :class:`ParamSpec` at each leaf:
    the keys, shapes and initialisers of the reference's ``init_params``."""
    kind = check_supported(cfg)
    L = cfg.n_layers
    specs = {
        "embed": init_embed(cfg),
        "final_norm": init_norm("final_norm", cfg),
        "layers": {"norm1": init_norm("layers/norm1", cfg, stacked=L)},
    }
    if kind == "attn":
        specs["layers"]["mixer"] = init_attention("layers/attn", cfg,
                                                  stacked=L)
        specs["layers"]["ffn"] = init_mlp("layers/mlp", cfg, stacked=L)
        specs["layers"]["norm2"] = init_norm("layers/norm2", cfg, stacked=L)
    elif kind == "mamba1":
        specs["layers"]["mixer"] = init_mamba1("layers/mamba1", cfg,
                                               stacked=L)
    else:
        specs["layers"]["mixer"] = init_mamba2("layers/mamba2", cfg,
                                               stacked=L)
    if kind == "mamba2_shared":
        # zamba2's shared block is a full transformer block (attention +
        # MLP), ONE parameter set reused at every site
        specs["shared_attn"] = init_attention("shared_attn", cfg)
        specs["shared_norm"] = init_norm("shared_norm", cfg)
        specs["shared_mlp"] = init_mlp("shared_mlp", cfg)
        specs["shared_norm2"] = init_norm("shared_norm2", cfg)
    return specs


def init_params(cfg: ModelConfig, seed: int = 0,
                device: Optional[Device] = None) -> Dict:
    """Draw the parameters of ``cfg`` on ``device`` (the card unless another
    is named) in ``cfg.pdtype``.

    Each parameter is drawn from its own generator on the device, seeded
    from ``seed`` and the CRC-32 of its name (``layers.param_seed``), with
    the reference's distributions; the values differ from ``jax.random``'s.
    To compute with the reference's numbers, carry its tree across with
    ``interop.params_from_numpy`` instead.
    """
    device = resolve_device(device)
    return tree_map(lambda s: init_param(s, seed, cfg.pdtype, device),
                    param_specs(cfg))


def count_params(cfg: ModelConfig) -> int:
    return sum(s.numel for s in tree_leaves(param_specs(cfg)))


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: Optional[torch.dtype] = None,
               device: Optional[Device] = None) -> Dict:
    """Decode cache tree.  ``pos`` is the write cursor (same for the batch).
    An attention cache holds each layer's (batch, max_len, KH, hd) k and v
    in ``dtype`` (the compute type by default), or int8 with bf16 scales
    when ``cfg.kv_cache_dtype == "int8"``; a Mamba cache holds each layer's
    conv window and state, so ``max_len`` does not size it, and the hybrid
    adds ``shared``: each shared-attention site's (batch, max_len, KH, hd)
    k and v."""
    kind = check_supported(cfg)
    device = resolve_device(device)
    dt = dtype or cfg.cdtype
    L = cfg.n_layers
    if kind == "attn":
        shape = (L, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        if cfg.kv_cache_dtype == "int8":
            layers = {
                "k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                       device=device),
                "v_scale": torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                       device=device)}
        else:
            layers = {"k": torch.zeros(shape, dtype=dt, device=device),
                      "v": torch.zeros(shape, dtype=dt, device=device)}
    else:
        make = mamba1_decode_cache if kind == "mamba1" else mamba2_decode_cache
        c = make(cfg, batch, dt, device)
        layers = {k: v.expand((L,) + v.shape).contiguous()
                  for k, v in c.items()}
    cache = {"pos": torch.zeros((), dtype=torch.int32, device=device),
             "layers": layers}
    if kind == "mamba2_shared":
        shape = (_n_shared_sites(cfg), batch, max_len, cfg.n_kv_heads,
                 cfg.head_dim)
        cache["shared"] = {"k": torch.zeros(shape, dtype=dt, device=device),
                           "v": torch.zeros(shape, dtype=dt, device=device)}
    return cache


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _save_matmuls(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``remat="selective"``: keep the outputs of 2-D products (the
    projections: a ``torch.matmul`` of activations by a weight runs as
    ``aten.mm``) and recompute the rest, attention included — the
    counterpart of ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``."""
    return (CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, body: Callable) -> Callable:
    """``body`` under the reference's remat mode (``_layer_body`` :286-293):
    ``none`` as it is; ``full`` checkpointed, everything inside recomputed
    in the backward; ``selective`` checkpointed with :func:`_save_matmuls`.
    """
    if cfg.remat == "none":
        return body
    if cfg.remat == "full":
        kw = {}
    elif cfg.remat == "selective":
        kw = {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, _save_matmuls)}
    else:
        raise ValueError(f"unknown remat mode {cfg.remat!r}")
    return functools.partial(checkpoint, body, use_reentrant=False, **kw)


def forward(params: Dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            cache: Optional[Dict] = None,
            patch_embeds: Optional[torch.Tensor] = None,
            impl: str = "kernel", train: bool = False
            ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """Returns (logits, new_cache, aux_loss).

    tokens: (B, S) on the parameters' device.  With ``cache``: prefill
    (pos=0, S>1) or decode (S==1, written at ``cache["pos"]``).
    ``patch_embeds`` (B, P, d) overrides the first P embeddings (the VLM
    stub frontend).  Logits are float32.  ``impl`` selects the kernels
    (``"kernel"``: flash attention in prefill and training, the selective
    scan) or their plain versions (``"ref"``).  ``train`` applies
    ``cfg.remat`` to each layer (no cache then).  The cache given is not
    changed; a new one is returned.  On a path with attention (``attn``,
    the hybrid), reading the cache's write position is the forward's one
    host sync; a Mamba forward without attention needs no positions.

    The hybrid applies the shared block (norm, attention, residual, norm,
    MLP, residual) after layer ``idx`` when ``(idx + 1) % every == 0``, at
    site ``(idx + 1) // every - 1`` of ``cache["shared"]``; in training it
    runs inside that layer's remat, its index bound by closure.
    """
    kind = check_supported(cfg)
    if train and cache is not None:
        raise ValueError("a training forward takes no cache")
    B, S = tokens.shape
    L = cfg.n_layers
    pos0 = (int(cache["pos"]) if cache is not None
            and kind in ("attn", "mamba2_shared") else 0)
    positions = (torch.arange(S, device=tokens.device) + pos0).expand(B, S)
    x = embed_tokens(params["embed"], tokens, cfg, positions)
    if patch_embeds is not None:
        P = patch_embeds.shape[1]
        x = torch.cat([patch_embeds.to(x.dtype), x[:, P:, :]], dim=1)

    every = cfg.shared_attn_every if kind == "mamba2_shared" else 0
    site_caches = None
    if kind == "mamba2_shared" and cache is not None:
        site_caches = [{"k": k, "v": v} for k, v in zip(
            cache["shared"]["k"].unbind(0), cache["shared"]["v"].unbind(0))]

    def shared_block(x, site):
        h = apply_norm(x, params["shared_norm"], cfg)
        h, nc = attention_block(
            params["shared_attn"], h, cfg, positions=positions,
            cache=None if site_caches is None else site_caches[site],
            cache_pos=pos0, causal=True, impl=impl)
        if nc is not None:
            site_caches[site] = nc
        x = x + h
        h = apply_norm(x, params["shared_norm2"], cfg)
        return x + mlp_block(params["shared_mlp"], h, cfg)

    def body(x, lp, lcache, idx):
        h = apply_norm(x, lp["norm1"], cfg)
        if kind == "attn":
            h, nc = attention_block(lp["mixer"], h, cfg, positions=positions,
                                    cache=lcache, cache_pos=pos0,
                                    causal=True, impl=impl)
        elif kind == "mamba1":
            h, nc = mamba1_block(lp["mixer"], h, cfg, cache=lcache,
                                 impl=impl)
        else:
            h, nc = mamba2_block(lp["mixer"], h, cfg, cache=lcache)
        x = x + h
        if "ffn" in lp:
            h = apply_norm(x, lp["norm2"], cfg)
            x = x + mlp_block(lp["ffn"], h, cfg)
        if every and (idx + 1) % every == 0:
            x = shared_block(x, (idx + 1) // every - 1)
        return x, nc

    layers = unstack_layers(params["layers"], L)
    new_layers = []
    if train:
        for idx, lp in enumerate(layers):
            step = _remat(cfg, lambda x, lp, idx=idx: body(x, lp, None,
                                                           idx)[0])
            x = step(x, lp)
    else:
        caches = (unstack_layers(cache["layers"], L) if cache is not None
                  else [None] * L)
        for idx, (lp, lcache) in enumerate(zip(layers, caches)):
            x, nc = body(x, lp, lcache, idx)
            new_layers.append(nc)

    x = apply_norm(x, params["final_norm"], cfg)
    logits = unembed(params["embed"], x, cfg)

    new_cache = None
    if cache is not None:
        new_cache = {"pos": cache["pos"] + S,
                     "layers": {k: torch.stack([c[k] for c in new_layers])
                                for k in new_layers[0]}}
        if site_caches is not None:
            new_cache["shared"] = {k: torch.stack([c[k] for c in site_caches])
                                   for k in ("k", "v")}
    aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    return logits, new_cache, aux


# --------------------------------------------------------------------------
# step builders
# --------------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy, float32; logits (B, S, V), labels (B, S)."""
    z = logits.float()
    lse = torch.logsumexp(z, dim=-1)
    gold = torch.gather(z, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - gold)


class _XentWithBwdDtype(torch.autograd.Function):
    """Cross-entropy whose backward emits ``dtype`` cotangents
    (``_xent_with_bwd_dtype`` :425-456): ``(softmax(z) - onehot) · g /
    count`` in float32, rounded to ``dtype``.  Every entry lies in
    [-1, 1], so bf16 holds it; autograd hands it to the float32 logits'
    producer widened back, with the bf16 values."""

    @staticmethod
    def forward(ctx, logits, labels, dtype):
        ctx.save_for_backward(logits, labels)
        ctx.dtype = dtype
        return softmax_xent(logits, labels)

    @staticmethod
    def backward(ctx, g):
        logits, labels = ctx.saved_tensors
        p = torch.softmax(logits.float(), dim=-1)
        # p - onehot, without a (B, S, V) one-hot
        p.scatter_add_(-1, labels[..., None].long(),
                       torch.full(labels.shape + (1,), -1.0,
                                  dtype=p.dtype, device=p.device))
        return (p * (g / labels.numel())).to(ctx.dtype), None, None


def xent_with_bwd_dtype(logits: torch.Tensor, labels: torch.Tensor,
                        dtype: torch.dtype) -> torch.Tensor:
    return _XentWithBwdDtype.apply(logits, labels, dtype)


def make_loss_fn(cfg: ModelConfig, *, impl: str = "kernel"):
    """(params, batch) -> (total loss, {"loss", "aux"}), the loss of the
    next-token labels under ``forward(train=True)``."""
    if cfg.grad_dtype == "float32":
        xent = softmax_xent
    else:
        xent = functools.partial(xent_with_bwd_dtype,
                                 dtype=getattr(torch, cfg.grad_dtype))

    def loss_fn(params, batch):
        logits, _, aux = forward(
            params, batch["tokens"], cfg,
            patch_embeds=batch.get("patch_embeds"), impl=impl, train=True)
        loss = xent(logits[:, :-1], batch["labels"][:, 1:])
        return loss + aux, {"loss": loss, "aux": aux}
    return loss_fn


def value_and_grad(loss_fn: Callable):
    """``jax.value_and_grad(loss_fn, has_aux=True)`` for ``loss_fn(params,
    batch) -> (total, aux)``: returns ``fn(params, batch) -> ((total,
    aux), grads)`` with ``grads`` a tree like ``params``.

    Each leaf is differentiated through a detached alias (same storage, no
    copy), so ``params`` never require grad and no ``.grad`` accumulates:
    the parameters serve no-grad paths unchanged, and the kernel wrappers'
    guard sees grad-requiring tensors only inside this call.
    """
    def fn(params, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with torch.enable_grad():
            total, aux = loss_fn(tree_unflatten(params, leaves), batch)
            grads = torch.autograd.grad(total, leaves, allow_unused=True,
                                        materialize_grads=True)
        aux = {k: v.detach() for k, v in aux.items()}
        return (total.detach(), aux), tree_unflatten(params, grads)
    return fn


def make_prefill_step(cfg: ModelConfig, max_len: Optional[int] = None, *,
                      impl: str = "kernel"):
    """(params, tokens) -> (next_token_logits, cache)."""
    def prefill(params, tokens):
        B, S = tokens.shape
        cache = init_cache(cfg, B, max_len or cfg.max_cache_len or S,
                           device=tokens.device)
        logits, cache, _ = forward(params, tokens, cfg, cache=cache,
                                   impl=impl)
        return logits[:, -1, :], cache
    return prefill


def make_decode_step(cfg: ModelConfig, *, impl: str = "kernel"):
    """(params, cache, token (B,1)) -> (logits (B, V), cache)."""
    def decode(params, cache, token):
        logits, cache, _ = forward(params, token, cfg, cache=cache, impl=impl)
        return logits[:, -1, :], cache
    return decode
