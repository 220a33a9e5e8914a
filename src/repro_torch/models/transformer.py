"""The port's decoder-only LM over stacked layers, for plan kinds ``attn``
(dense, or MoE), ``mamba1``, ``mamba2`` and ``mamba2_shared`` (the zamba2
hybrid): forward, loss and gradients.

Port of ``repro/models/transformer.py``.  Parameters keep the reference's
tree: nested dicts with a leading ``n_layers`` dim on every per-layer leaf,
so a tree made by ``repro.models.transformer.init_params`` and carried
across with ``interop.params_from_numpy`` runs here unchanged.  The
reference's ``lax.scan`` over the stacked layers becomes a Python loop over
per-layer views (``tree.unstack_layers``), so zamba2's shared transformer
block (one unstacked parameter set, applied after every
``shared_attn_every``-th layer) is placed by the loop's static index, as
the reference's unrolled path places it; its KV caches are the
``cache["shared"]`` slots, one a site.  An MoE layer's feed-forward is
:func:`moe.moe_block`, picked by structure (a ``router`` in the layer's
``ffn``) as there, and its aux loss adds into the returned one.  With
``moe_every = k > 1`` (llama4-maverick) ``layers/ffn`` holds ``mlp``
stacked by L − L/k and ``moe`` stacked by L/k: layer ``s·k + j`` takes
``mlp[s·(k−1) + j]`` for ``j < k − 1`` and ``moe[s]`` for ``j = k − 1``,
the reference's super-block order (:func:`_layer_params`).

Training (``forward(train=True)``, ``make_loss_fn``; the train step is
``launch/steps.py``'s) follows the reference's remat modes with
``torch.utils.checkpoint``, and takes gradients with
``torch.autograd.grad`` over the parameter leaves (:func:`value_and_grad`),
functional like ``jax.value_and_grad``.  With
``impl="kernel"`` the attention's gradient goes through the flash kernel's
autograd Function, and Mamba1's through the scan's (``SSMScan``: the scan
kernel forward, the scan's backward kernel); Mamba2's SSD is torch ops.

It runs the dense transformer family (qwen2-7b, qwen3-14b, granite-20b,
yi-9b, llava-next-34b's backbone, whose ``patch_embeds`` stand in for the
vision frontend), the MoE family (dbrx-132b, llama4-maverick-400b-a17b),
the attention-free Mamba1 family (falcon-mamba-7b) and the Mamba2 hybrid
(zamba2-7b).  The encoder-decoder (whisper-tiny) is ``models/encdec.py``'s:
here it raises ``NotImplementedError`` naming that module.

With a sharding context over a ``torch.distributed`` world (``ctx``, the
launchers' world path) the parameters and the batch are DTensors, and
``forward`` constrains the activations where the reference's
``_layer_body`` and ``forward`` do: the embeddings and each layer's output
to ``("batch", "seq", "d_model")``, the logits to ``("batch", "seq",
"vocab")``.  The positions are a DTensor laid out with the tokens.  The
loss runs on each rank's batch rows over the whole vocabulary (the logits
gathered by vocab first; ``parallel.sharding.batch_call``), each rank's
mean a share of the batch's, summed over the ranks.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..interop import Device, resolve_device
from ..parallel.sharding import (batch_call, batch_dims, is_dtensor,
                                 replicated_like)
from ..tree import tree_leaves, tree_map, tree_unflatten, unstack_layers
from .config import ModelConfig
from .layers import (apply_norm, attention_block, embed_tokens,
                     init_attention, init_embed, init_mlp, init_norm,
                     init_param, mlp_block, shard_act, unembed)
from .moe import init_moe, moe_block, moe_flops_per_token
from .ssm import (init_mamba1, init_mamba2, mamba1_block, mamba1_decode_cache,
                  mamba2_block, mamba2_decode_cache, ssm_flops_per_token)


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
    """The plan kind of ``cfg`` if this module runs it; an encoder-decoder
    config raises ``NotImplementedError`` naming the module that does."""
    kind = _plan_kind(cfg)
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name} is an encoder-decoder model: "
            f"repro_torch.models.encdec builds and runs it")
    _superblock(cfg)
    return kind


def _superblock(cfg: ModelConfig) -> int:
    """Layers a super-block: ``moe_every`` for interleaved MoE (k − 1 dense
    layers, then one MoE layer), else 1."""
    if cfg.n_experts and cfg.moe_every > 1 and _plan_kind(cfg) == "attn":
        if cfg.n_layers % cfg.moe_every:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are no "
                             f"whole number of blocks of {cfg.moe_every}")
        return cfg.moe_every
    return 1


def _ffn_init(cfg: ModelConfig, L: int) -> Dict:
    """The attention layers' feed-forward specs: the MLP, the MoE layer, or
    for interleaved MoE both, stacked by the layers that take each."""
    if not cfg.n_experts:
        return init_mlp("layers/mlp", cfg, stacked=L)
    k = _superblock(cfg)
    if k == 1:
        return init_moe("layers/moe", cfg, stacked=L)
    return {"mlp": init_mlp("layers/mlp", cfg, stacked=L - L // k),
            "moe": init_moe("layers/moe", cfg, stacked=L // k)}


def _layer_params(layers: Dict, cfg: ModelConfig,
                  L: Optional[int] = None) -> List[Dict]:
    """Each layer's parameter tree, its leaves views of the stacked ones
    (``L`` of them, ``cfg.n_layers`` unless given).  With interleaved MoE
    the ``ffn`` leaves are stacked by the layers of each kind, so they are
    unbound by those counts and placed by index."""
    L, k = L or cfg.n_layers, _superblock(cfg)
    if k == 1:
        return unstack_layers(layers, L)
    per = unstack_layers({n: t for n, t in layers.items() if n != "ffn"}, L)
    mlp = unstack_layers(layers["ffn"]["mlp"], L - L // k)
    moe = unstack_layers(layers["ffn"]["moe"], L // k)
    for i, lp in enumerate(per):
        s, j = divmod(i, k)
        lp["ffn"] = mlp[s * (k - 1) + j] if j < k - 1 else moe[s]
    return per


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
        specs["layers"]["ffn"] = _ffn_init(cfg, L)
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


def logical_axes(cfg: ModelConfig) -> Dict:
    """The parameter tree of ``cfg`` with each leaf's logical axis names (a
    tuple, one name or ``None`` a dimension), the reference's
    ``logical_axes`` (``Builder(mode="axes")``): what the placement rules
    map onto mesh axes (``core.placement.tree_specs``)."""
    return tree_map(lambda s: s.axes, param_specs(cfg))


def abstract_params(cfg: ModelConfig, fake_mode,
                    device: Optional[Device] = "cpu") -> Dict:
    """The parameter tree of ``cfg`` as fake tensors of ``fake_mode`` (a
    ``FakeTensorMode``: shapes and dtypes, no memory) on ``device``, in
    ``cfg.pdtype``: the reference's ``abstract_params``, which the dry-run
    builds its cases on (``launch/steps.py::build_case``)."""
    with fake_mode:
        return tree_map(lambda s: torch.empty(s.shape, dtype=cfg.pdtype,
                                              device=device),
                        param_specs(cfg))


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


def count_active_params(cfg: ModelConfig) -> int:
    """Params touched per token (MoE: top-k experts only; interleaved MoE
    counts only the L//moe_every layers that actually have experts)."""
    total = count_params(cfg)
    if not cfg.n_experts:
        return total
    d, ff, E, K = (cfg.d_model, cfg.expert_d_ff, cfg.n_experts,
                   cfg.experts_per_token)
    n_moe_layers = cfg.n_layers // cfg.moe_every
    return total - n_moe_layers * (E - K) * 3 * d * ff


def model_flops_per_token(cfg: ModelConfig, seq_len: int) -> float:
    """Forward matmul FLOPs per token (the 6·N·D convention divides into
    2·N_active fwd + 4·N_active bwd; attention adds the S-dependent term).
    With interleaved MoE only the last layer of each block of ``moe_every``
    counts the MoE layer's FLOPs, the others their MLP's; the reference
    counts the MoE layer's at every attention layer (ROADMAP §3)."""
    d, hd = cfg.d_model, cfg.head_dim
    attn = (2 * d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
            + 2 * cfg.n_heads * hd * d
            + 2 * 2 * cfg.n_heads * hd * seq_len / 2)
    k = _superblock(cfg)
    f = 0.0
    for i, plan in enumerate(cfg.layer_plan):
        if plan == "attn":
            f += attn
            if cfg.n_experts and (i + 1) % k == 0:
                f += moe_flops_per_token(cfg)
            else:
                mult = 3 if cfg.mlp_act == "swiglu" else 2
                f += mult * 2 * d * cfg.d_ff
        else:
            f += ssm_flops_per_token(
                cfg, "mamba1" if plan == "mamba1" else "mamba2")
            if "shared_attn" in plan:
                f += attn
    f += 2 * d * cfg.vocab_size          # unembed
    return f


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
    cache = {"pos": write_cursor(0, device), "layers": layers}
    if kind == "mamba2_shared":
        shape = (_n_shared_sites(cfg), batch, max_len, cfg.n_kv_heads,
                 cfg.head_dim)
        cache["shared"] = {"k": torch.zeros(shape, dtype=dt, device=device),
                           "v": torch.zeros(shape, dtype=dt, device=device)}
    return cache


def write_cursor(pos: int, device) -> torch.Tensor:
    """A cache's ``pos``: the 0-d int32 write position.  Under
    ``FakeTensorMode`` (the dry-run's cases) it is made from a Python int,
    which fake tensor mode keeps as a constant, so the forward's one host
    read of it still gets the value; on real tensors it is filled on the
    device, as before, without a copy from the host."""
    if torch._C._get_dispatch_mode(
            torch._C._TorchDispatchModeKey.FAKE) is not None:
        return torch.tensor(pos, dtype=torch.int32, device=device)
    return torch.full((), pos, dtype=torch.int32, device=device)


def cache_logical_axes(cfg: ModelConfig) -> Dict:
    """The logical axis names of each leaf of :func:`init_cache`'s tree,
    as the reference's ``cache_logical_axes`` gives them."""
    kind = check_supported(cfg)
    ax: Dict = {"pos": ()}
    if kind == "attn":
        kv = ("layers", "batch", "kv_seq", "kv_heads", None)
        ax["layers"] = {"k": kv, "v": kv}
        if cfg.kv_cache_dtype == "int8":
            ax["layers"]["k_scale"] = kv[:-1]
            ax["layers"]["v_scale"] = kv[:-1]
    elif kind == "mamba1":
        ax["layers"] = {"conv": ("layers", "batch", None, "ssm_inner"),
                        "h": ("layers", "batch", "ssm_inner", "state")}
    else:
        ax["layers"] = {"conv": ("layers", "batch", None, "conv_dim"),
                        "h": ("layers", "batch", "ssm_heads", None, "state")}
        if kind == "mamba2_shared":
            kv = (None, "batch", "kv_seq", "kv_heads", None)
            ax["shared"] = {"k": kv, "v": kv}
    return ax


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


def layer_stack(layers: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                positions: torch.Tensor, caches: Optional[List] = None,
                cache_pos: int = 0, shared: Optional[Dict] = None,
                site_caches: Optional[List[Dict]] = None,
                impl: str = "kernel", train: bool = False, ctx=None
                ) -> Tuple[torch.Tensor, torch.Tensor, List]:
    """Run the stacked layers ``layers`` (each leaf with a leading layer
    dim, as ``params["layers"]`` holds them, or a contiguous slice of them)
    on ``x`` (B, S, d) at ``positions`` (B, S): the counterpart of the
    reference's ``_layer_body`` scanned over the stack, which
    :func:`forward` and the pipeline's stage body
    (``parallel/pipeline.py``) both run.

    ``caches`` holds each layer's cache (``None`` for none); ``cache_pos``
    is the write position.  The hybrid's shared block takes its parameters
    from ``shared`` (a tree with ``shared_attn``, ``shared_norm``,
    ``shared_mlp`` and ``shared_norm2``, such as ``params``) and its KV
    caches from ``site_caches``, which it updates in place.  ``train``
    applies ``cfg.remat`` to each layer (no caches then).  ``ctx`` is the
    sharding context of the blocks' constraints; each layer's output is
    constrained to ``("batch", "seq", "d_model")``.  Returns ``x``,
    the sum of the MoE layers' aux losses in layer order (float32 zero
    without experts) and each layer's new cache (``None``s without
    caches)."""
    kind = check_supported(cfg)
    L = tree_leaves(layers["norm1"])[0].shape[0]
    every = cfg.shared_attn_every if kind == "mamba2_shared" else 0
    if every and shared is None:
        raise ValueError(f"{cfg.name}: the shared block needs its "
                         f"parameters (shared=)")

    def shared_block(x, site):
        h = apply_norm(x, shared["shared_norm"], cfg)
        h, nc = attention_block(
            shared["shared_attn"], h, cfg, positions=positions,
            cache=None if site_caches is None else site_caches[site],
            cache_pos=cache_pos, causal=True, impl=impl, ctx=ctx)
        if nc is not None:
            site_caches[site] = nc
        x = x + h
        h = apply_norm(x, shared["shared_norm2"], cfg)
        return x + mlp_block(shared["shared_mlp"], h, cfg, ctx)

    def body(x, lp, lcache, idx):
        """One layer: returns x, the layer's new cache and its MoE aux loss
        (None for a layer without experts)."""
        h = apply_norm(x, lp["norm1"], cfg)
        if kind == "attn":
            h, nc = attention_block(lp["mixer"], h, cfg, positions=positions,
                                    cache=lcache, cache_pos=cache_pos,
                                    causal=True, impl=impl, ctx=ctx)
        elif kind == "mamba1":
            h, nc = mamba1_block(lp["mixer"], h, cfg, cache=lcache,
                                 impl=impl, ctx=ctx)
        else:
            h, nc = mamba2_block(lp["mixer"], h, cfg, cache=lcache, ctx=ctx)
        x = x + h
        a = None
        if "ffn" in lp:
            h = apply_norm(x, lp["norm2"], cfg)
            if "router" in lp["ffn"]:           # MoE vs dense by structure
                h, a = moe_block(lp["ffn"], h, cfg, ctx)
            else:
                h = mlp_block(lp["ffn"], h, cfg, ctx)
            x = x + h
        if every and (idx + 1) % every == 0:
            x = shared_block(x, (idx + 1) // every - 1)
        return shard_act(x, ("batch", "seq", "d_model"), ctx), nc, a

    new_caches = []
    aux = replicated_like(torch.zeros((), dtype=torch.float32,
                                      device=x.device), x)
    if train:
        if caches is not None:
            raise ValueError("a training forward takes no cache")
        for idx, lp in enumerate(_layer_params(layers, cfg, L)):
            # (x, aux) of the layer: a training forward keeps no cache
            step = _remat(cfg, lambda x, lp, idx=idx: body(x, lp, None,
                                                           idx)[::2])
            x, a = step(x, lp)
            if a is not None:
                aux = aux + a
    else:
        for idx, (lp, lcache) in enumerate(zip(
                _layer_params(layers, cfg, L),
                caches if caches is not None else [None] * L)):
            x, nc, a = body(x, lp, lcache, idx)
            new_caches.append(nc)
            if a is not None:
                aux = aux + a
    return x, aux, new_caches


def forward(params: Dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            cache: Optional[Dict] = None,
            patch_embeds: Optional[torch.Tensor] = None,
            impl: str = "kernel", train: bool = False, ctx=None
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

    The layers run in :func:`layer_stack`.  The hybrid applies the shared
    block (norm, attention, residual, norm, MLP, residual) after layer
    ``idx`` when ``(idx + 1) % every == 0``, at site
    ``(idx + 1) // every - 1`` of ``cache["shared"]``; in training it runs
    inside that layer's remat, its index bound by closure.  The aux loss is
    the sum of the MoE layers' load-balancing losses in layer order (zero
    without experts).  ``ctx`` constrains the activations (module
    docstring); the tokens, the patch embeddings and the cache are then
    DTensors laid out on its mesh.
    """
    kind = check_supported(cfg)
    if train and cache is not None:
        raise ValueError("a training forward takes no cache")
    B, S = tokens.shape
    L = cfg.n_layers
    pos0 = (int(cache["pos"]) if cache is not None
            and kind in ("attn", "mamba2_shared") else 0)
    positions = replicated_like(torch.arange(S, device=tokens.device)
                                + pos0, tokens).expand(B, S)
    positions = shard_act(positions, ("batch", "seq"), ctx)
    x = embed_tokens(params["embed"], tokens, cfg, positions)
    if patch_embeds is not None:
        P = patch_embeds.shape[1]
        x = torch.cat([patch_embeds.to(x.dtype), x[:, P:, :]], dim=1)
    x = shard_act(x, ("batch", "seq", "d_model"), ctx)

    site_caches = None
    if kind == "mamba2_shared" and cache is not None:
        site_caches = [{"k": k, "v": v} for k, v in zip(
            cache["shared"]["k"].unbind(0), cache["shared"]["v"].unbind(0))]

    x, aux, new_layers = layer_stack(
        params["layers"], x, cfg, positions=positions,
        caches=(unstack_layers(cache["layers"], L) if cache is not None
                else None),
        cache_pos=pos0,
        shared=params if kind == "mamba2_shared" else None,
        site_caches=site_caches, impl=impl, train=train, ctx=ctx)

    x = apply_norm(x, params["final_norm"], cfg)
    logits = shard_act(unembed(params["embed"], x, cfg),
                       ("batch", "seq", "vocab"), ctx)

    new_cache = None
    if cache is not None:
        new_cache = {"pos": cache["pos"] + S,
                     "layers": {k: torch.stack([c[k] for c in new_layers])
                                for k in new_layers[0]}}
        if site_caches is not None:
            new_cache["shared"] = {k: torch.stack([c[k] for c in site_caches])
                                   for k in ("k", "v")}
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


def sharded_loss(xent: Callable, logits: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
    """``xent(logits, labels)``, a mean over the batch.  On DTensors it
    runs on each rank's batch rows over the whole vocabulary (the logits
    gathered by vocab), each rank's mean divided by the number of batch
    shards and summed over them (a replicated scalar)."""
    if not is_dtensor(logits):
        return xent(logits, labels)
    from torch.distributed.tensor import Replicate
    mesh = logits.device_mesh
    n = 1
    for i in batch_dims(logits):
        n *= mesh.size(i)
    loss, = batch_call(lambda z, y: (xent(z, y) / n,), logits,
                       [logits, labels], [0, 0], ["partial"])
    return loss.redistribute(mesh, [Replicate()] * mesh.ndim)


def make_loss_fn(cfg: ModelConfig, ctx=None, *, impl: str = "kernel"):
    """(params, batch) -> (total loss, {"loss", "aux"}), the loss of the
    next-token labels under ``forward(train=True)``, its activations
    constrained by ``ctx``."""
    if cfg.grad_dtype == "float32":
        xent = softmax_xent
    else:
        xent = functools.partial(xent_with_bwd_dtype,
                                 dtype=getattr(torch, cfg.grad_dtype))

    def loss_fn(params, batch):
        logits, _, aux = forward(
            params, batch["tokens"], cfg,
            patch_embeds=batch.get("patch_embeds"), impl=impl, train=True,
            ctx=ctx)
        loss = sharded_loss(xent, logits[:, :-1], batch["labels"][:, 1:])
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


def lay_out(tree, axes, ctx):
    """Each leaf of ``tree`` constrained to its logical axes in ``axes``
    (a tree of the same structure) by ``ctx``; ``tree`` without one."""
    if ctx is None or ctx.mesh is None:
        return tree
    return tree_map(lambda t, a: shard_act(t, a, ctx), tree, axes)


def make_prefill_step(cfg: ModelConfig, ctx=None,
                      max_len: Optional[int] = None, *,
                      impl: str = "kernel"):
    """(params, tokens[, patch_embeds]) -> (next_token_logits, cache);
    with ``ctx`` the tokens (and a VLM's patch embeddings) and the new
    cache are laid out on its mesh (the cache by
    :func:`cache_logical_axes`)."""
    def prefill(params, tokens, patch_embeds=None):
        B, S = tokens.shape
        tokens = shard_act(tokens, ("batch", "seq"), ctx)
        if patch_embeds is not None:
            patch_embeds = shard_act(patch_embeds,
                                     ("batch", "seq", "d_model"), ctx)
        cache = lay_out(init_cache(cfg, B, max_len or cfg.max_cache_len or S,
                                   device=tokens.device),
                        cache_logical_axes(cfg), ctx)
        logits, cache, _ = forward(params, tokens, cfg, cache=cache,
                                   patch_embeds=patch_embeds, impl=impl,
                                   ctx=ctx)
        return logits[:, -1, :], cache
    return prefill


def make_decode_step(cfg: ModelConfig, ctx=None, *, impl: str = "kernel"):
    """(params, cache, token (B,1)) -> (logits (B, V), cache)."""
    def decode(params, cache, token):
        token = shard_act(token, ("batch", "seq"), ctx)
        logits, cache, _ = forward(params, token, cfg, cache=cache,
                                   impl=impl, ctx=ctx)
        return logits[:, -1, :], cache
    return decode
