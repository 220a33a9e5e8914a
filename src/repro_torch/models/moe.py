"""Mixture-of-Experts layer: top-k router and grouped capacity dispatch.

Port of ``repro/models/moe.py`` (GShard-style): the tokens are split into
groups of ``cfg.moe_group`` (all of them when fewer, or when the group size
does not divide them); each group routes every token to its top-k experts
and fills each expert's capacity buffer of ``C`` slots in token order,
dropping the picks that find their expert's buffer full.  The experts run
on the capacity buffers (``E × C`` rows a group), so the products cost the
active compute plus the capacity padding, whatever the batch.

The reference writes the dispatch and the expert computation as einsums.
Here each is one batched product: over the group for the dispatch and the
combine, over the expert for the three expert products.  None forms a
per-(token, expert, slot, feature) tensor; the largest tensors are the
(G, gs, E·C) dispatch and combine weights.  The JAX package computes MoE
outside any Pallas kernel (``repro.kernels.grouped_matmul``, named in its
docstring, does not exist), so the products are ``torch.bmm`` in the
compute type.

On a mesh (the launchers' world path) the routing has no DTensor
sharding strategy to rely on (the stable sort, the capacity cumsum, the
``scatter`` into the dispatch and combine weights), so it runs on plain
tensors on each rank over a replicated value (``parallel.sharding
.batch_call``: the router's input and weight gathered, every rank routing
every group the same way; the reference's groups follow the batch, which a
group of ``moe_group`` tokens rarely divides at the reduced sizes).  The
dispatch weights are then constrained by expert (``("expert_group", None,
"experts")``, whole experts a shard, as the reference's ``(G, gs, E, C)``
constraint) and the expert products run on each rank's experts, the
reference's three constraints in this module's layout.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..parallel.sharding import batch_call, is_dtensor
from .config import ModelConfig
from .layers import p, shard_act


def init_moe(name: str, cfg: ModelConfig, stacked: int = 0) -> Dict:
    d, ff, E = cfg.d_model, cfg.expert_d_ff, cfg.n_experts
    L: Tuple[int, ...] = (stacked,) if stacked else ()
    A: Tuple[str, ...] = ("layers",) if stacked else ()
    out = {
        "router": p(f"{name}/router", L + (d, E), A + ("embed", None),
                    scale=d ** -0.5),
        "wi_gate": p(f"{name}/wi_gate", L + (E, d, ff),
                     A + ("experts", "embed", "d_ff")),
        "wi_up": p(f"{name}/wi_up", L + (E, d, ff),
                   A + ("experts", "embed", "d_ff")),
        "wo": p(f"{name}/wo", L + (E, ff, d),
                A + ("experts", "d_ff", "embed")),
    }
    if cfg.n_shared_experts:
        sff = ff * cfg.n_shared_experts
        out["shared_wi_gate"] = p(f"{name}/shared_wi_gate", L + (d, sff),
                                  A + ("embed", "d_ff"))
        out["shared_wi_up"] = p(f"{name}/shared_wi_up", L + (d, sff),
                                A + ("embed", "d_ff"))
        out["shared_wo"] = p(f"{name}/shared_wo", L + (sff, d),
                             A + ("d_ff", "embed"))
    return out


class Routing(NamedTuple):
    """One MoE call's routing: G groups of ``gs`` tokens, capacity ``C``
    slots an expert a group; ``probs`` (G, gs, E) float32, each token's
    top-k ``idx`` (G, gs, K) and renormalised ``gates`` (zero where
    dropped), the slot ``pos`` each pick takes in its expert's buffer and
    ``keep`` (pos < C)."""
    G: int
    gs: int
    C: int
    probs: torch.Tensor
    idx: torch.Tensor
    gates: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, largest first,
    the lower index first among equal values (``torch.topk`` does not
    promise that order; a stable descending sort does)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(params: Dict, x: torch.Tensor, cfg: ModelConfig) -> Routing:
    """The router of :func:`moe_block` (``moe.py:55-92``): group size,
    capacity, float32 softmax probabilities, top-k picks with gates
    renormalised (sum clipped at 1e-9), and each pick's slot: a running
    count per expert over the group's picks in token order, k fastest
    within a token, so an earlier token always wins a slot."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    T = B * S
    gs = (cfg.moe_group if T % cfg.moe_group == 0 and T >= cfg.moe_group
          else T)
    G = T // gs
    # ceil, not floor: small groups (decode: gs = batch) would otherwise get
    # almost no capacity; int() of the float product first, as there
    C = max(-(-int(cfg.capacity_factor * gs * K) // E), 1)
    logits = torch.matmul(x.reshape(G, gs, d).float(),
                          params["router"].float())
    probs = torch.softmax(logits, dim=-1)                       # (G, gs, E)
    gates, idx = _top_k(probs, K)                               # (G, gs, K)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    flat = F.one_hot(idx, E).reshape(G, gs * K, E)
    pos = ((torch.cumsum(flat, dim=1) - flat) * flat).sum(-1) \
        .reshape(G, gs, K)
    keep = pos < C
    return Routing(G, gs, C, probs, idx, gates * keep.float(), pos, keep)


def _dispatch(router: torch.Tensor, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The routing of ``x`` (B, S, d) as :func:`moe_block` uses it: the
    (G, gs, E·C) dispatch and combine weights in the compute type and the
    float32 aux loss.

    The aux loss is the Switch load-balancing loss over all tokens, from
    the probabilities and the picks before any drop.  Each kept pick writes
    a 1 (dispatch) and its gate rounded to the compute type (combine) at
    its (expert, slot): a token's picks name distinct experts, so no two
    writes of a row meet, and the values are the reference's sums of
    one-hot products."""
    E = cfg.n_experts
    cd = cfg.cdtype
    r = route({"router": router}, x, cfg)
    G, gs, C = r.G, r.gs, r.C
    me = r.probs.mean(dim=(0, 1))                                # (E,)
    ce = F.one_hot(r.idx, E).float().sum(2).mean(dim=(0, 1))
    aux = cfg.router_aux_weight * E * torch.sum(me * ce)

    slot = r.idx * C + torch.clamp(r.pos, max=C - 1)            # (G, gs, K)
    zeros = torch.zeros((G, gs, E * C), dtype=cd, device=x.device)
    dispatch = zeros.scatter(2, slot, r.keep.to(cd))
    combine = zeros.scatter(2, slot, r.gates.to(cd))
    return dispatch, combine, aux.float()


def moe_block(params: Dict, x: torch.Tensor, cfg: ModelConfig,
              ctx=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output, aux_loss); x: (B, S, d) in the compute type; the
    routing is :func:`_dispatch`'s."""
    B, S, d = x.shape
    E = cfg.n_experts
    cd = cfg.cdtype
    if is_dtensor(x):
        dispatch, combine, aux = batch_call(
            lambda router, x: _dispatch(router, x, cfg), None,
            [params["router"], x], [None, None], [None, None, None])
    else:
        dispatch, combine, aux = _dispatch(params["router"], x, cfg)
    G, gs = dispatch.shape[:2]
    C = dispatch.shape[2] // E
    dispatch = shard_act(dispatch, ("expert_group", None, "experts"), ctx)

    xt = shard_act(x.reshape(G, gs, d).to(cd), ("expert_group", None, None),
                   ctx)
    xe = torch.bmm(dispatch.transpose(1, 2), xt)                # (G, E*C, d)
    # experts as the batch: (E, G*C, d); a view when G == 1
    xe = xe.reshape(G, E, C, d).transpose(0, 1).reshape(E, G * C, d)
    xe = shard_act(xe, ("experts", None, None), ctx)
    g = torch.bmm(xe, params["wi_gate"].to(cd))
    u = torch.bmm(xe, params["wi_up"].to(cd))
    ye = torch.bmm(F.silu(g) * u, params["wo"].to(cd))          # (E, G*C, d)
    ye = ye.reshape(E, G, C, d).transpose(0, 1).reshape(G, E * C, d)
    y = torch.bmm(combine, ye)                                  # (G, gs, d)

    if "shared_wi_gate" in params:
        gsh = torch.matmul(xt, params["shared_wi_gate"].to(cd))
        ush = torch.matmul(xt, params["shared_wi_up"].to(cd))
        y = y + torch.matmul(F.silu(gsh) * ush, params["shared_wo"].to(cd))
    return y.reshape(B, S, d), aux


def moe_flops_per_token(cfg: ModelConfig) -> int:
    """Active-parameter matmul FLOPs per token for one MoE layer (fwd)."""
    d, ff, K = cfg.d_model, cfg.expert_d_ff, cfg.experts_per_token
    f = 2 * d * cfg.n_experts                      # router
    f += K * (3 * 2 * d * ff)                      # K experts, swiglu
    if cfg.n_shared_experts:
        f += cfg.n_shared_experts * 3 * 2 * d * ff
    return f
