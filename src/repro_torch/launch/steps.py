"""Step builders shared by the launchers and the dry-run: the optimizer of
a config, the train step, the sharding helpers, and the dry-run's cases.

Port of ``repro/launch/steps.py`` (``Case`` :28, ``skip_reason`` :42,
``make_optimizer`` :50, ``make_rules`` :60, ``opt_state_shardings`` :71,
``make_train_step`` :99, ``build_case`` :132, ``_fit_sharding`` and
``fit_case_shardings`` :222-253, the latter two as functions of shapes,
specs and a mesh, ``lower_case`` :256).  A case's arguments are fake
tensors (``FakeTensorMode``: shapes, dtypes and layouts, no memory) laid
out by the rule table on a mesh over a world of the ``fake`` backend
(``launch/dryrun.py`` makes one); :func:`lower_case` returns a
:class:`Lowered` whose ``compile()`` runs the case's step once on them
under ``launch.costs.Counter``: the structure of the reference's
``Lowered``/``Compiled``, with the counted run in place of XLA's compile.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from ..configs import get_config
from ..core.placement import Spec, fit_spec, logical_to_spec, standard_rules
from ..models import frontends, model_module
from ..models import transformer as TF
from ..models.config import SHAPES, ModelConfig, ShapeSpec
from ..optim import Adafactor, AdamW
from ..parallel.sharding import ShardingCtx
from ..tree import tree_map


@dataclasses.dataclass
class Case:
    """One (arch × shape × mesh) cell: the step ``fn`` and its arguments
    ``args`` (fake tensors laid out on the mesh, of ``fake_mode``), their
    specs (``in_shardings``, fitted to each leaf), the arguments the step
    updates in place (``donate_argnums``), its kind (train, prefill or
    decode), and why it is skipped, if it is."""
    arch: str
    shape: str
    cfg: ModelConfig
    fn: Optional[Callable]
    args: Tuple[Any, ...]
    in_shardings: Tuple[Any, ...]
    out_shardings: Any
    donate_argnums: Tuple[int, ...]
    kind: str                          # train | prefill | decode
    skip_reason: Optional[str] = None
    fake_mode: Any = None


def skip_reason(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("full-attention arch at 512k context: quadratic prefill / "
                "full-length KV cache out of scope per assignment "
                "(DESIGN.md §Arch-applicability)")
    return None


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


def opt_state_shardings(opt, params_axes, params_abs, rules, mesh):
    """The optimizer state's specs: AdamW's m and v mirror the parameters'
    specs; Adafactor's factored vr and vc drop the last and the
    second-to-last logical axis (matching its init by shape); the step
    count is replicated."""
    def spec(axes):
        return logical_to_spec(axes, rules, mesh.axis_names)

    if isinstance(opt, AdamW):
        pm = tree_map(spec, params_axes)
        return {"step": (), "m": pm, "v": pm}

    def vspec(axes, p):
        if opt._factored(p.shape):
            return {"vr": spec(axes[:-1]), "vc": spec(axes[:-2] + axes[-1:])}
        return {"v": spec(axes)}
    return {"step": (), "v": tree_map(vspec, params_axes, params_abs)}


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
                    ctx: Optional[ShardingCtx] = None, *,
                    impl: str = "kernel") -> Callable:
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
    a VLM's carries ``patch_embeds``), as the reference dispatches it;
    ``impl`` picks the kernels or their plain versions."""
    M = model_module(cfg)
    M.check_supported(cfg)
    grad_fn = TF.value_and_grad(M.make_loss_fn(cfg, ctx, impl=impl))
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


# --------------------------------------------------------------------------
# the dry-run's cases
# --------------------------------------------------------------------------

def _laid_out(tree: Any, specs: Any, ctx: ShardingCtx) -> Tuple[Any, Any]:
    """Each tensor of ``tree`` laid out by its spec in ``specs`` fitted to
    its shape (``ShardingCtx.fit_spec``: even shards, no axis of size 1);
    returns the laid-out tree and the fitted specs."""
    from ..core.placement import shard
    fitted = tree_map(lambda t, spec: ctx.fit_spec(t.shape, spec), tree,
                      specs)
    return tree_map(lambda t, spec: shard(t, ctx.mesh, spec), tree,
                    fitted), fitted


def build_case(arch: str, shape_name: Union[str, ShapeSpec], mesh,
               mode: str = "fsdp_tp", *, remat: Optional[str] = None,
               serve_mode: Optional[str] = None,
               overrides: Optional[Dict[str, Any]] = None,
               impl: str = "kernel") -> Case:
    """The case of ``arch`` at ``shape_name`` (a name in ``SHAPES``, or a
    ``ShapeSpec`` of the caller's) on ``mesh`` (a mesh over a world, fake
    or real, whose device the arguments are made on), as the reference
    builds it: a train case's params, optimizer state and batch (with
    ``patch_embeds`` or ``frames`` where the family takes them); a
    prefill case's params and tokens; a decode case's params, a cache of
    ``seq_len`` slots written up to its last one, and one token.  Serving
    runs bf16 weights under ``serve_mode`` (the train mode when None).
    ``overrides`` replace config fields (``n_layers`` cuts the depth and
    the layer plan with it); ``impl="ref"`` runs the kernels' plain
    versions (``launch.hillclimb flashsim``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = get_config(arch)
    shape = (shape_name if isinstance(shape_name, ShapeSpec)
             else SHAPES[shape_name])
    reason = skip_reason(cfg, shape)
    if reason:
        return Case(arch, shape.name, cfg, None, (), (), None, (),
                    shape.kind, skip_reason=reason)
    B, S = shape.global_batch, shape.seq_len
    upd: Dict[str, Any] = {"max_cache_len": S}
    if shape.kind != "train":
        upd["param_dtype"] = "bfloat16"        # serving runs bf16 weights
        mode = serve_mode or mode
    if remat is not None:
        upd["remat"] = remat
    if overrides:
        upd.update(overrides)
    if "n_layers" in upd and "layer_plan" not in upd:
        upd["layer_plan"] = ()                 # derived anew from the depth
    cfg = dataclasses.replace(cfg, **upd)
    M = model_module(cfg)
    M.check_supported(cfg)
    rules = make_rules(mesh, mode, B)
    ctx = ShardingCtx(mesh, rules)
    fake = FakeTensorMode()
    dev = mesh.device
    names = mesh.axis_names
    spec = lambda axes: logical_to_spec(axes, rules, names)  # noqa: E731
    params_axes = M.logical_axes(cfg)
    params_abs = M.abstract_params(cfg, fake, dev)
    with fake:
        params, params_sh = _laid_out(params_abs, tree_map(spec,
                                                           params_axes),
                                      ctx)
        tok = torch.zeros((B, S), dtype=torch.int32, device=dev)
        if shape.kind == "train":
            opt = make_optimizer(cfg)
            opt_state, opt_sh = _laid_out(
                opt.init(params_abs),
                opt_state_shardings(opt, params_axes, params_abs, rules,
                                    mesh), ctx)
            # the step count stays a plain 0-d tensor, as in the launchers
            opt_state["step"] = opt_state["step"].to_local()
            batch = {"tokens": tok, "labels": tok.clone()}
            if cfg.family == "vlm":
                shp, dt = frontends.vision_patch_spec(cfg, B)
                batch["patch_embeds"] = torch.zeros(shp, dtype=dt,
                                                    device=dev)
            if cfg.is_encoder_decoder:
                shp, dt = frontends.audio_frame_spec(cfg, B)
                batch["frames"] = torch.zeros(shp, dtype=dt, device=dev)
            batch, batch_sh = _laid_out(
                batch, {k: spec(BATCH_AXES[k]) for k in batch}, ctx)
            return Case(arch, shape.name, cfg,
                        make_train_step(cfg, opt, ctx, impl=impl),
                        (params, opt_state, batch),
                        (params_sh, opt_sh, batch_sh), None, (0, 1),
                        "train", fake_mode=fake)
        if shape.kind == "prefill":
            extra = {}
            if cfg.family == "vlm":
                extra["patch_embeds"] = frontends.vision_patch_spec(cfg, B)
            if cfg.is_encoder_decoder:
                extra["frames"] = frontends.audio_frame_spec(cfg, B)
            inputs = {"tokens": tok, **{
                k: torch.zeros(shp, dtype=dt, device=dev)
                for k, (shp, dt) in extra.items()}}
            inputs, inputs_sh = _laid_out(
                inputs, {k: spec(BATCH_AXES[k]) for k in inputs}, ctx)
            order = ["tokens"] + list(extra)
            args = [params] + [inputs[k] for k in order]
            in_sh = [params_sh] + [inputs_sh[k] for k in order]
            return Case(arch, shape.name, cfg,
                        M.make_prefill_step(cfg, ctx, max_len=S, impl=impl),
                        tuple(args), tuple(in_sh), None, (), "prefill",
                        fake_mode=fake)
        # decode: one new token against a cache of S slots, written up to
        # its last one
        cache = M.init_cache(cfg, B, S, device=dev)
        cache["pos"] = TF.write_cursor(S - 1, dev)
        cache, cache_sh = _laid_out(cache, tree_map(
            spec, M.cache_logical_axes(cfg)), ctx)
        token, token_sh = _laid_out(tok[:, :1].contiguous(),
                                    spec(("batch", None)), ctx)
        return Case(arch, shape.name, cfg,
                    M.make_decode_step(cfg, ctx, impl=impl),
                    (params, cache, token), (params_sh, cache_sh, token_sh),
                    None, (1,), "decode", fake_mode=fake)


class Compiled:
    """A case run once under ``launch.costs.Counter``: the reference's
    ``Compiled`` as far as the dry-run reads it."""

    def __init__(self, counter, outputs) -> None:
        self._counter = counter
        self.outputs = outputs

    def cost_analysis(self) -> Dict[str, Any]:
        """This rank's FLOPs (``flops``, ``flops_by_dtype``), bytes
        (``bytes accessed``), collectives and memory."""
        return self._counter.cost()

    def memory_analysis(self):
        """The reference's memory record, as attributes."""
        import types
        return types.SimpleNamespace(**self._counter.memory())

    def as_text(self) -> str:
        """The op log: one line a dispatched operation."""
        return self._counter.text()


class Lowered:
    """A case ready to run; ``compile()`` runs it (``where``: each log line
    names the model code that issued it)."""

    def __init__(self, case: Case, where: bool = False) -> None:
        self.case = case
        self.where = where

    def compile(self) -> Compiled:
        from .costs import Counter
        case = self.case
        with case.fake_mode, Counter(log=True, where=self.where) as c:
            c.hold(case.args)
            out = case.fn(*case.args)
            c.outputs(out)
        return Compiled(c, out)


def lower_case(case: Case, *, where: bool = False) -> Lowered:
    if case.skip_reason:
        raise ValueError(f"{case.arch} {case.shape}: {case.skip_reason}")
    return Lowered(case, where)
