"""The port's encoder-decoder transformer (whisper's backbone): forward,
loss, prefill and decode.

Port of ``repro/models/encdec.py``.  The audio conv frontend is a stand-in:
the encoder takes precomputed frame embeddings (B, enc_seq, d_model)
(``frontends.synth_frames``).  whisper-tiny's config sets LayerNorm, the
gelu MLP, q/k/v biases, learned positions and tied embeddings; the
reference's layers follow the config, and so do these.

Parameters keep the reference's tree (``enc_pos``, ``enc_layers/attn``,
``enc_layers/norm1``, ..., ``dec_layers/self_attn``,
``dec_layers/cross_attn``, ``dec_layers/normx``, ...), so a tree made by
``repro.models.encdec.init_params`` and carried across with
``interop.params_from_numpy`` runs here unchanged.  The reference's
``lax.scan`` over stacked layers and its ``jax.vmap`` over the stacked
cross-attention weights become Python loops over per-layer views
(``tree.unstack_layers``).  Every attention, the encoder's non-causal
self-attention, the decoder's causal one in training and prefill, and the
cross-attention (over the encoder's keys, also in a decode step) goes
through the flash kernel (``impl="ref"``: its plain version); a decode
step's self-attention attends over the cache in torch ops.  Neither stack
is checkpointed: the reference's bodies are not, whatever ``cfg.remat``
says.  Gradients come from ``transformer.value_and_grad`` over
:func:`make_loss_fn`.

:func:`logical_axes` and :func:`cache_logical_axes` give each parameter's
and cache leaf's logical axis names, as the reference's do, and
:func:`abstract_params` the parameters as fake tensors, which the dry-run
builds its cases on.

With a sharding context over a ``torch.distributed`` world (``ctx``) the
parameters and the batch are DTensors and the activations are constrained
where the reference's are: the encoder's input and each encoder layer's
output, the decoder's embeddings and each decoder layer's output, to
``("batch", "seq", "d_model")`` (``models.layers.shard_act``); the loss is
``transformer.sharded_loss``'s.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..interop import Device, resolve_device
from ..parallel.sharding import replicated_like
from ..tree import tree_leaves, tree_map, unstack_layers
from .config import ModelConfig
from .layers import (split_heads, apply_norm, attention_block,
                     embed_tokens, init_attention, init_embed, init_mlp,
                     init_norm, init_param, mlp_block, p, shard_act, unembed)
from .transformer import lay_out, sharded_loss, softmax_xent, write_cursor


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` unless ``cfg`` is an encoder-decoder config:
    a decoder-only one is ``models.transformer``'s."""
    if not cfg.is_encoder_decoder:
        raise ValueError(f"{cfg.name} is not an encoder-decoder config; "
                         f"repro_torch.models.transformer runs it")


def param_specs(cfg: ModelConfig) -> Dict:
    """The parameter tree of ``cfg`` with a ``ParamSpec`` at each leaf: the
    keys, shapes and initialisers of the reference's ``init_params``
    (``encdec.py:23-45``)."""
    check_supported(cfg)
    Le, Ld = cfg.n_enc_layers, cfg.n_layers
    return {
        "embed": init_embed(cfg),
        "enc_pos": p("enc_pos", (cfg.enc_seq, cfg.d_model), (None, "embed"),
                     scale=0.02),
        "enc_layers": {
            "attn": init_attention("enc/attn", cfg, stacked=Le),
            "norm1": init_norm("enc/norm1", cfg, stacked=Le),
            "mlp": init_mlp("enc/mlp", cfg, stacked=Le),
            "norm2": init_norm("enc/norm2", cfg, stacked=Le),
        },
        "enc_norm": init_norm("enc_norm", cfg),
        "dec_layers": {
            "self_attn": init_attention("dec/self_attn", cfg, stacked=Ld),
            "norm1": init_norm("dec/norm1", cfg, stacked=Ld),
            "cross_attn": init_attention("dec/cross_attn", cfg, stacked=Ld),
            "normx": init_norm("dec/normx", cfg, stacked=Ld),
            "mlp": init_mlp("dec/mlp", cfg, stacked=Ld),
            "norm2": init_norm("dec/norm2", cfg, stacked=Ld),
        },
        "dec_norm": init_norm("dec_norm", cfg),
    }


def logical_axes(cfg: ModelConfig) -> Dict:
    """The parameter tree of ``cfg`` with each leaf's logical axis names,
    the reference's ``logical_axes`` (``encdec.py:52``)."""
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
    is named) in ``cfg.pdtype``, as ``transformer.init_params`` draws its
    own: the reference's distributions, not ``jax.random``'s numbers."""
    device = resolve_device(device)
    return tree_map(lambda s: init_param(s, seed, cfg.pdtype, device),
                    param_specs(cfg))


def count_params(cfg: ModelConfig) -> int:
    return sum(s.numel for s in tree_leaves(param_specs(cfg)))


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def encode(params: Dict, frames: torch.Tensor, cfg: ModelConfig, ctx=None,
           *, impl: str = "kernel") -> torch.Tensor:
    """The encoder over frames (B, S, d_model): the frames and ``enc_pos``
    rows added in the compute type, ``n_enc_layers`` pre-norm blocks of
    non-causal self-attention and MLP, the final norm."""
    B, S, _ = frames.shape
    cd = cfg.cdtype
    x = frames.to(cd) + params["enc_pos"][:S].to(cd)
    x = shard_act(x, ("batch", "seq", "d_model"), ctx)
    positions = replicated_like(torch.arange(S, device=frames.device),
                                frames).expand(B, S)
    for lp in unstack_layers(params["enc_layers"], cfg.n_enc_layers):
        h = apply_norm(x, lp["norm1"], cfg)
        h, _ = attention_block(lp["attn"], h, cfg, positions=positions,
                               causal=False, impl=impl, ctx=ctx)
        x = x + h
        h = apply_norm(x, lp["norm2"], cfg)
        x = x + mlp_block(lp["mlp"], h, cfg, ctx)
        x = shard_act(x, ("batch", "seq", "d_model"), ctx)
    return apply_norm(x, params["enc_norm"], cfg)


def cross_kv(params: Dict, enc_out: torch.Tensor,
             cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Each decoder layer's cross-attention k and v of the encoder output:
    ``{"k", "v"}``, each (L, B, enc_seq, KH, hd) in the compute type."""
    cd = cfg.cdtype
    ks, vs = [], []
    for lp in unstack_layers(params["dec_layers"]["cross_attn"],
                             cfg.n_layers):
        k = torch.matmul(enc_out, lp["wk"].to(cd))
        v = torch.matmul(enc_out, lp["wv"].to(cd))
        if "bk" in lp:
            k = k + lp["bk"].to(cd)
            v = v + lp["bv"].to(cd)
        ks.append(split_heads(k, cfg.n_kv_heads, cfg.head_dim))
        vs.append(split_heads(v, cfg.n_kv_heads, cfg.head_dim))
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def decoder_forward(params: Dict, tokens: torch.Tensor,
                    xkv: Dict[str, torch.Tensor], cfg: ModelConfig, *,
                    ctx=None, cache: Optional[Dict] = None,
                    impl: str = "kernel"
                    ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Returns (float32 logits, new_cache).

    tokens (B, S) at positions ``cache["pos"] + arange(S)`` (from 0
    without a cache), their learned position rows added; each layer is
    causal self-attention (over the cache when one is given), cross-
    attention over the layer's ``xkv`` and the MLP.  The cache given is not
    changed; the new one carries ``xkv`` on.  Reading the cache's write
    position is the forward's one host sync."""
    B, S = tokens.shape
    L = cfg.n_layers
    pos0 = int(cache["pos"]) if cache is not None else 0
    positions = replicated_like(torch.arange(S, device=tokens.device)
                                + pos0, tokens).expand(B, S)
    positions = shard_act(positions, ("batch", "seq"), ctx)
    x = shard_act(embed_tokens(params["embed"], tokens, cfg, positions),
                  ("batch", "seq", "d_model"), ctx)
    caches = (unstack_layers(cache["layers"], L) if cache is not None
              else [None] * L)
    new_layers = []
    for lp, lkv, lcache in zip(unstack_layers(params["dec_layers"], L),
                               unstack_layers(xkv, L), caches):
        h = apply_norm(x, lp["norm1"], cfg)
        h, nc = attention_block(lp["self_attn"], h, cfg, positions=positions,
                                cache=lcache, cache_pos=pos0, causal=True,
                                impl=impl, ctx=ctx)
        new_layers.append(nc)
        x = x + h
        h = apply_norm(x, lp["normx"], cfg)
        h, _ = attention_block(lp["cross_attn"], h, cfg, positions=positions,
                               kv_override=(lkv["k"], lkv["v"]),
                               causal=False, impl=impl, ctx=ctx)
        x = x + h
        h = apply_norm(x, lp["norm2"], cfg)
        x = x + mlp_block(lp["mlp"], h, cfg, ctx)
        x = shard_act(x, ("batch", "seq", "d_model"), ctx)
    x = apply_norm(x, params["dec_norm"], cfg)
    logits = unembed(params["embed"], x, cfg)
    new_cache = None
    if cache is not None:
        new_cache = {"pos": cache["pos"] + S,
                     "layers": {k: torch.stack([c[k] for c in new_layers])
                                for k in ("k", "v")},
                     "xkv": xkv}
    return logits, new_cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: Optional[torch.dtype] = None,
               device: Optional[Device] = None) -> Dict:
    """Decode cache tree: ``pos`` (the write cursor), each decoder layer's
    (batch, max_len, KH, hd) self-attention k and v, and ``xkv``: the
    cross-attention k and v, (batch, enc_seq, KH, hd) a layer, zero until a
    prefill puts :func:`cross_kv`'s there."""
    check_supported(cfg)
    device = resolve_device(device)
    dt = dtype or cfg.cdtype
    L, KH, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim

    def kv(length):
        return {n: torch.zeros((L, batch, length, KH, hd), dtype=dt,
                               device=device) for n in ("k", "v")}
    return {"pos": write_cursor(0, device), "layers": kv(max_len),
            "xkv": kv(cfg.enc_seq)}


def cache_logical_axes(cfg: ModelConfig) -> Dict:
    """The logical axis names of each leaf of :func:`init_cache`'s tree,
    the reference's ``cache_logical_axes`` (``encdec.py:154``)."""
    kv = ("layers", "batch", "kv_seq", "kv_heads", None)
    return {"pos": (), "layers": {"k": kv, "v": kv},
            "xkv": {"k": kv, "v": kv}}


# --------------------------------------------------------------------------
# step builders
# --------------------------------------------------------------------------

def make_loss_fn(cfg: ModelConfig, ctx=None, *, impl: str = "kernel"):
    """(params, batch) -> (loss, {"loss", "aux"}): the next-token loss of
    ``batch["tokens"]`` decoded over ``batch["frames"]``; aux is zero."""
    check_supported(cfg)

    def loss_fn(params, batch):
        enc_out = encode(params, batch["frames"], cfg, ctx, impl=impl)
        xkv = cross_kv(params, enc_out, cfg)
        logits, _ = decoder_forward(params, batch["tokens"], xkv, cfg,
                                    ctx=ctx, impl=impl)
        loss = sharded_loss(softmax_xent, logits[:, :-1],
                            batch["labels"][:, 1:])
        return loss, {"loss": loss,
                      "aux": replicated_like(
                          torch.zeros((), dtype=torch.float32,
                                      device=loss.device), loss)}
    return loss_fn


def make_prefill_step(cfg: ModelConfig, ctx=None,
                      max_len: Optional[int] = None, *,
                      impl: str = "kernel"):
    """(params, tokens, frames) -> (next_token_logits, cache): the frames
    encoded, their cross k and v into the cache, the tokens decoded into a
    self-attention cache of ``max_len or cfg.max_cache_len or S`` slots."""
    def prefill(params, tokens, frames):
        B, S = tokens.shape
        tokens = shard_act(tokens, ("batch", "seq"), ctx)
        frames = shard_act(frames, ("batch", "seq", None), ctx)
        enc_out = encode(params, frames, cfg, ctx, impl=impl)
        xkv = cross_kv(params, enc_out, cfg)
        cache = lay_out(init_cache(cfg, B, max_len or cfg.max_cache_len or S,
                                   device=tokens.device),
                        cache_logical_axes(cfg), ctx)
        cache["xkv"] = lay_out(xkv, cache_logical_axes(cfg)["xkv"], ctx)
        logits, cache = decoder_forward(params, tokens, cache["xkv"], cfg,
                                        ctx=ctx, cache=cache, impl=impl)
        return logits[:, -1, :], cache
    return prefill


def make_decode_step(cfg: ModelConfig, ctx=None, *, impl: str = "kernel"):
    """(params, cache, token (B, 1)) -> (logits (B, V), cache)."""
    def decode(params, cache, token):
        token = shard_act(token, ("batch", "seq"), ctx)
        logits, cache = decoder_forward(params, token, cache["xkv"], cfg,
                                        ctx=ctx, cache=cache, impl=impl)
        return logits[:, -1, :], cache
    return decode
