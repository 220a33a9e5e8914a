"""The port's MoE layers on the CPU against the JAX package: dbrx-132b
(16 experts top-4, every layer MoE) and llama4-maverick-400b-a17b (128
experts top-1, a shared expert, MoE on every other layer), both reduced.

Parameters come from ``repro.models.transformer.init_params`` and cross
through ``interop.params_from_numpy``; inputs are made with numpy from a
seed.  ``moe_block`` is held at rtol = atol = 1e-4 in float32 compute and
5e-2 in bf16 compute, in a case with several dispatch groups, one where
capacity drops picks and a decode step (one token a slot); the whole
``forward`` (logits and aux) at 1e-4, the gradient of ``loss + aux`` at
2e-5 of each leaf's largest entry (as ``test_torch_train.py``), decode
against the full forward with a dropless capacity (the reference's
``tests/test_models.py::test_decode_matches_forward_moe``), and the
parameter and FLOP counts to the reference's integers (less, for the
FLOPs of interleaved MoE, the reference's overcount of its dense layers:
ROADMAP §3).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMDataset  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import moe as pt_moe  # noqa: E402
from repro_torch.models import transformer as PTF  # noqa: E402
from repro_torch.models.config import cut_depth  # noqa: E402
from repro_torch.tree import tree_flatten_with_paths  # noqa: E402

MOE = ["dbrx-132b", "llama4-maverick-400b-a17b"]
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
GRAD_TOL = 2e-5
# group size 8 over 2 x 16 tokens: G = 4; capacity factor 0.5: drops;
# decode: one token for each of 4 slots
CASES = {"groups": dict(moe_group=8), "drops": dict(capacity_factor=0.5),
         "decode": {}}


def _cfgs(arch, **overrides):
    return (jax_config(arch).reduced(**overrides),
            get_config(arch).reduced(**overrides))


@functools.lru_cache(maxsize=None)
def _tree(arch, seed=1, **overrides):
    jcfg, _ = _cfgs(arch, **overrides)
    return jax.device_get(JTF.init_params(jcfg, jax.random.PRNGKey(seed)))


def _moe_layer(tree, cfg):
    """The first MoE layer's parameters of a stacked tree."""
    ffn = tree["layers"]["ffn"]
    ffn = ffn["moe"] if cfg.moe_every > 1 else ffn
    return {k: v[0] for k, v in ffn.items()}


def _x(shape, dtype):
    x = np.random.default_rng(4).standard_normal(shape, dtype=np.float32)
    return (jnp.asarray(x).astype(dtype),
            torch.from_numpy(x).to(getattr(torch, dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", MOE)
def test_moe_block_matches_the_references(arch, case, dtype):
    jcfg, cfg = _cfgs(arch, compute_dtype=dtype, **CASES[case])
    layer = _moe_layer(_tree(arch), cfg)
    jp, pp = (jax.tree.map(jnp.asarray, layer),
              params_from_numpy(layer, "cpu"))
    jx, x = _x((4, 1, cfg.d_model) if case == "decode"
               else (2, 16, cfg.d_model), dtype)
    jy, jaux = jax_moe.moe_block(jp, jx, jcfg)
    y, aux = pt_moe.moe_block(pp, x, cfg)
    assert y.dtype == x.dtype and aux.dtype == torch.float32
    tol = TOL[dtype]
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy, np.float32), rtol=tol, atol=tol)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    r = pt_moe.route(pp, x, cfg)
    T = x.shape[0] * x.shape[1]
    assert r.G == (4 if case == "groups" else 1) and r.G * r.gs == T
    dropped = int((~r.keep).sum())
    if case == "drops":
        # some picks drop on both sides: each output differs from the
        # dropless one (capacity E x the tokens)
        assert dropped > 0
        jfull, full = _cfgs(arch, compute_dtype=dtype,
                            capacity_factor=float(cfg.n_experts))
        assert not np.allclose(np.asarray(jax_moe.moe_block(jp, jx, jfull)[0],
                                          np.float32),
                               np.asarray(jy, np.float32), atol=tol)
        assert not torch.allclose(pt_moe.moe_block(pp, x, full)[0].float(),
                                  y.float(), atol=tol)
    if case == "decode":
        # slot 0's picks come first in each expert's buffer: never dropped
        assert r.keep[0, 0].all()


def test_top_k_takes_the_lower_index_first_among_ties():
    x = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3]])
    vals, idx = pt_moe._top_k(x, 3)
    jvals, jidx = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    assert idx.tolist() == np.asarray(jidx).tolist() == [[1, 2, 4]]
    assert torch.equal(vals, torch.from_numpy(np.array(jvals)))


# maverick at 6 layers with MoE every 3rd: layer 3s + j takes mlp[2s + j]
# for j < 2, so the interleave's index map is exercised beyond k = 2
FORWARD = [("dbrx-132b", {}), ("llama4-maverick-400b-a17b", {}),
           ("dbrx-132b", dict(moe_group=8, capacity_factor=0.5)),
           ("llama4-maverick-400b-a17b", dict(n_layers=6, moe_every=3))]


@pytest.mark.parametrize("arch,overrides", FORWARD)
def test_forward_logits_and_aux_match(arch, overrides):
    jcfg, cfg = _cfgs(arch, **overrides)
    tree = _tree(arch, **overrides)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 16),
                                             dtype=np.int32)
    jlogits, _, jaux = JTF.forward(jax.tree.map(jnp.asarray, tree),
                                   jnp.asarray(toks), jcfg)
    logits, _, aux = PTF.forward(params_from_numpy(tree, "cpu"),
                                 torch.from_numpy(toks), cfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    # one load-balancing term per MoE layer, each about router_aux_weight
    assert float(aux) > 0.5 * cfg.router_aux_weight * (
        cfg.n_layers // cfg.moe_every)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_layer_params_follow_the_references_super_blocks():
    cfg = get_config("llama4-maverick-400b-a17b").reduced(n_layers=6,
                                                          moe_every=3)
    tree = _tree("llama4-maverick-400b-a17b", n_layers=6, moe_every=3)
    layers = PTF._layer_params(params_from_numpy(tree, "cpu")["layers"], cfg)
    ffn = tree["layers"]["ffn"]
    for i, lp in enumerate(layers):
        s, j = divmod(i, 3)
        if j < 2:
            np.testing.assert_array_equal(lp["ffn"]["wo"].numpy(),
                                          ffn["mlp"]["wo"][2 * s + j])
        else:
            np.testing.assert_array_equal(lp["ffn"]["router"].numpy(),
                                          ffn["moe"]["router"][s])
        np.testing.assert_array_equal(lp["norm2"]["scale"].numpy(),
                                      tree["layers"]["norm2"]["scale"][i])


def _assert_grads_close(got, want):
    want = dict(tree_flatten_with_paths(want))
    got = tree_flatten_with_paths(got)
    assert sorted(p for p, _ in got) == sorted(want)
    for path, g in got:
        w = np.asarray(want[path])
        err = np.abs(g.numpy() - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= GRAD_TOL, (path, err)


@pytest.mark.parametrize("arch", MOE)
def test_loss_aux_and_grads_match_the_references(arch):
    """``loss + aux`` (``make_loss_fn``) and its gradient, the router's
    through the gates and the aux loss, with the layers under remat."""
    jcfg, cfg = _cfgs(arch)
    tree = _tree(arch)
    b = SyntheticLMDataset(cfg.vocab_size, 16, 2, seed=1).batch_at(0)
    (jtotal, jm), jgrads = jax.value_and_grad(
        JTF.make_loss_fn(jcfg), has_aux=True)(
            jax.tree.map(jnp.asarray, tree),
            {k: jnp.asarray(v) for k, v in b.items()})
    (total, m), grads = PTF.value_and_grad(PTF.make_loss_fn(cfg))(
        params_from_numpy(tree, "cpu"),
        {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    np.testing.assert_allclose(float(m["aux"]), float(jm["aux"]), rtol=1e-5)
    assert float(m["aux"]) > 0
    _assert_grads_close(grads, jax.device_get(jgrads))
    assert float(grads["layers"]["ffn"]["router"].abs().max()
                 if cfg.moe_every == 1 else
                 grads["layers"]["ffn"]["moe"]["router"].abs().max()) > 0


@pytest.mark.parametrize("arch", MOE)
def test_decode_matches_forward_when_dropless(arch):
    """Prefill S - 1 tokens, decode the last: the last-position logits of
    the full forward, with ``capacity_factor = E`` so that no group drops
    (which picks drop depends on the group's tokens, so prefill and decode
    would differ by design otherwise); and the JAX package's decode."""
    jcfg, cfg = _cfgs(arch)
    E = float(cfg.n_experts)
    jcfg = dataclasses.replace(jcfg, capacity_factor=E)
    cfg = dataclasses.replace(cfg, capacity_factor=E)
    tree = _tree(arch)
    params = params_from_numpy(tree, "cpu")
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 12),
                                             dtype=np.int32)
    full, _, _ = PTF.forward(params, torch.from_numpy(toks), cfg)
    _, cache = PTF.make_prefill_step(cfg, max_len=16)(
        params, torch.from_numpy(toks[:, :-1]))
    got, cache = PTF.make_decode_step(cfg)(params, cache,
                                           torch.from_numpy(toks[:, -1:]))
    np.testing.assert_allclose(got.numpy(), full[:, -1].numpy(),
                               rtol=1e-4, atol=1e-4)
    assert int(cache["pos"]) == 12
    jp = jax.tree.map(jnp.asarray, tree)
    _, jcache = JTF.make_prefill_step(jcfg, max_len=16)(
        jp, jnp.asarray(toks[:, :-1]))
    want, _ = JTF.make_decode_step(jcfg)(jp, jcache,
                                         jnp.asarray(toks[:, -1:]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


# (arch, layers or None for the published depth, reduced)
COUNTS = [(a, None, r) for a in MOE for r in (False, True)] + \
    [("dbrx-132b", 4, False), ("llama4-maverick-400b-a17b", 2, False)]


@pytest.mark.parametrize("arch,layers,reduced", COUNTS)
def test_counts_match_the_reference(arch, layers, reduced):
    jcfg, cfg = jax_config(arch), get_config(arch)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    if layers:
        cfg = cut_depth(cfg, layers)
        jcfg = dataclasses.replace(jcfg, n_layers=layers,
                                   layer_plan=jcfg.layer_plan[:layers])
    assert PTF.count_params(cfg) == JTF.count_params(jcfg)
    assert PTF.count_active_params(cfg) == JTF.count_active_params(jcfg)
    # the reference counts the MoE layer's FLOPs at the dense layers of an
    # interleaved config too (ROADMAP §3): the port counts their MLP's
    dense = cfg.n_layers - cfg.n_layers // cfg.moe_every
    overcount = dense * (pt_moe.moe_flops_per_token(cfg)
                         - 3 * 2 * cfg.d_model * cfg.d_ff)
    assert (dense > 0) == (arch == "llama4-maverick-400b-a17b")
    for seq in (1, 2048):
        assert PTF.model_flops_per_token(cfg, seq) == \
            JTF.model_flops_per_token(jcfg, seq) - overcount
    assert pt_moe.moe_flops_per_token(cfg) == \
        jax_moe.moe_flops_per_token(jcfg)
    want = {("dbrx-132b", 4): 14_269_470_720,
            ("llama4-maverick-400b-a17b", 2): 18_553_267_200}
    if (arch, layers) in want:
        assert PTF.count_params(cfg) == want[arch, layers]


def test_chip_smoke_phase_13_cells():
    """chip_smoke.py's MoE cells: the parameter counts it checks are the
    cut configs', and each prefill launches flash once a layer on wgmma."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    for arch, layers, n_params in chip_smoke.MOE_CELLS:
        cfg = cut_depth(get_config(arch), layers)
        assert PTF.count_params(cfg) == n_params
        assert chip_smoke._path_kernel(cfg) == "flash_attention"
        assert chip_smoke._kernel_layers(cfg) == layers
        assert chip_smoke.expected_route(cfg) == "wgmma"


def test_cut_depth_keeps_whole_super_blocks():
    cfg = get_config("llama4-maverick-400b-a17b")
    cut = cut_depth(cfg, 2)
    assert (cut.n_layers, cut.layer_plan, cut.d_model) == (2, ("attn",) * 2,
                                                           5120)
    with pytest.raises(ValueError, match="blocks of 2"):
        cut_depth(cfg, 3)
    with pytest.raises(ValueError, match="cannot cut"):
        cut_depth(cfg, 49)


@pytest.mark.parametrize("arch", MOE)
def test_launcher_trains_moe_as_the_jax_launcher(arch, monkeypatch):
    """The training launcher on the CPU from the JAX launcher's parameter
    draw: the same losses (``loss + aux``) over 3 steps at rtol 1e-4."""
    argv = ["--arch", arch, "--reduced", "--steps", "3", "--batch", "2",
            "--seq", "16", "--log-every", "100"]
    want = jax_train.main(argv)
    tree = _tree(arch, seed=0)
    monkeypatch.setattr(PTF, "init_params",
                        lambda cfg, seed, device: params_from_numpy(tree,
                                                                    device))
    got = train_mod.main(argv + ["--device", "cpu"])
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
