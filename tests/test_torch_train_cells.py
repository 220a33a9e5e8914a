"""chip_smoke.py's training cells of phases 12b, 13b, 18b and 18c
(zamba2-7b, dbrx-132b, granite-20b, qwen3-14b) and its serve cells of
phase 18 on the CPU against the JAX package.

- Each cell's parameter count is both packages' ``count_params`` at its
  cut, and a step launches flash attention on the ``wgmma`` route: twice a
  site (the forward and the remat recompute) and its backward once.
- Each serve cell (granite-20b, yi-9b, qwen3-14b, llava-next-34b) is
  served at the depth whose parameter count both packages give, with one
  wgmma flash launch a layer in each of its 5 prefills.
- dbrx-132b trains with ``Adafactor``, which ``make_optimizer`` gives to
  llama4* only (as the reference's does): two steps of ``make_train_step``
  with the port's Adafactor on the reduced config meet two steps of the
  reference's train step with ``repro.optim.Adafactor``, on the
  reference's seeded draw carried across as numpy and the same batches:
  the losses and every parameter leaf within ``tests/test_torch_optim.py``'s
  float32 tolerance.
- A narrow zamba2-7b at the published SSD chunk (``ssm_chunk = 256``) over
  512 tokens, where the chunk's decay exponents leave float32's range: the
  loss is the reference's and every gradient leaf is finite (the
  reference's gradient is not, ROADMAP §3).
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as J  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import steps as JST  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro.optim.schedules import cosine_schedule as jax_cosine  # noqa: E402
from repro_torch import optim as P  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMDataset  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.models import transformer as PTF  # noqa: E402
from repro_torch.models.config import cut_depth  # noqa: E402
from repro_torch.optim.schedules import cosine_schedule  # noqa: E402
from repro_torch.tree import tree_flatten_with_paths  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

# tests/test_torch_optim.py's float32 tolerance
TOL = dict(rtol=1e-6, atol=1e-6)
# (arch, flash forward launches a step, backward launches a step)
CELLS = [(chip_smoke.HYBRID_ARCH, 8, 4), (chip_smoke.MOE_TRAIN_ARCH, 2, 1),
         ("granite-20b", 12, 6), ("qwen3-14b", 8, 4)]
# (arch, layers served, flash launches in a serve run: a layer's one in
# each of the traced request's and the 4 requests' prefills)
SERVE_CELLS = [("granite-20b", 36, 180), ("yi-9b", 48, 240),
               ("qwen3-14b", 40, 200), ("llava-next-34b", 23, 115)]


def _batch(cfg, step, seq=16, batch=2):
    b = SyntheticLMDataset(cfg.vocab_size, seq, batch, seed=1).batch_at(step)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


@pytest.mark.parametrize("arch,forwards,backwards", CELLS)
def test_cells_count_the_references_parameters_and_launch_wgmma(
        arch, forwards, backwards):
    layers, n_params, batch, seq = chip_smoke.TRAIN_CELLS[arch][:4]
    assert (batch, seq) == (chip_smoke.TRAIN_BATCH, chip_smoke.TRAIN_SEQ)
    cfg = cut_depth(get_config(arch), layers)
    jcfg = jax_config(arch)
    jcfg = dataclasses.replace(jcfg, n_layers=layers,
                               layer_plan=jcfg.layer_plan[:layers])
    assert PTF.count_params(cfg) == JTF.count_params(jcfg) == n_params
    assert chip_smoke._path_kernel(cfg) == "flash_attention"
    assert chip_smoke._train_kernels(cfg) == {
        fa.flash_attention: forwards, fa.flash_attention_backward: backwards}
    assert chip_smoke.expected_route(cfg) == "wgmma"
    assert (cfg.compute_dtype, cfg.remat) == ("bfloat16", "selective")
    opt = chip_smoke._train_optimizer(cfg, 1e-4)
    want = P.Adafactor if arch in chip_smoke.ADAFACTOR_CELLS else P.AdamW
    assert isinstance(opt, want)
    # make_optimizer is the reference's: Adafactor for llama4* only
    assert isinstance(ST.make_optimizer(cfg), P.AdamW)
    assert isinstance(JST.make_optimizer(jcfg), J.AdamW)


@pytest.mark.parametrize("arch,layers,launches", SERVE_CELLS)
def test_serve_cells_count_the_references_parameters_and_launch_wgmma(
        arch, layers, launches):
    (cell,) = [c for c in chip_smoke.SERVE_CELLS if c[0] == arch]
    cfg = get_config(arch)
    assert (cell[1] or cfg.n_layers) == layers
    cfg = cut_depth(cfg, layers)
    jcfg = jax_config(arch)
    jcfg = dataclasses.replace(jcfg, n_layers=layers,
                               layer_plan=jcfg.layer_plan[:layers])
    assert PTF.count_params(cfg) == JTF.count_params(jcfg) == cell[2]
    assert chip_smoke._path_kernel(cfg) == "flash_attention"
    assert chip_smoke._kernel_layers(cfg) * chip_smoke.SERVE_PREFILLS == \
        launches
    assert chip_smoke.expected_route(cfg) == "wgmma"
    assert (cfg.param_dtype, cfg.compute_dtype) == ("float32", "bfloat16")
    assert chip_smoke._depth_args(cfg) == (
        ["--layers", str(layers)] if cell[1] else [])


def test_reduced_dbrx_adafactor_steps_match_the_references():
    arch = chip_smoke.MOE_TRAIN_ARCH
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jparams = JTF.init_params(jcfg, jax.random.PRNGKey(3))
    params = params_from_numpy(jax.device_get(jparams), "cpu")
    jopt = J.Adafactor(lr=jax_cosine(1e-3, 1, 2))
    opt = P.Adafactor(lr=cosine_schedule(1e-3, 1, 2))
    jstep = jax.jit(JST.make_train_step(jcfg, jopt, None))
    step = ST.make_train_step(cfg, opt)
    jstate, state = jopt.init(jparams), opt.init(params)
    for s in range(2):
        jb, pb = _batch(cfg, s)
        jparams, jstate, jm = jstep(jparams, jstate, jb)
        params, state, m = step(params, state, pb)
        np.testing.assert_allclose(float(m["total_loss"]),
                                   float(jm["total_loss"]), **TOL)
        assert float(m["aux"]) > 0
    assert int(state["step"]) == 2
    want = dict(tree_flatten_with_paths(jax.device_get(jparams)))
    got = tree_flatten_with_paths(params)
    assert sorted(p for p, _ in got) == sorted(want)
    for path, p in got:
        np.testing.assert_allclose(p.numpy(), want[path], err_msg=path,
                                   **TOL)


def test_narrow_zamba2_gradient_is_finite_at_the_published_chunk():
    arch, seq = chip_smoke.HYBRID_ARCH, 512
    chunk = get_config(arch).ssm_chunk
    assert chunk == 256
    kw = dict(n_layers=2, shared_attn_every=2, ssm_chunk=chunk)
    jcfg, cfg = jax_config(arch).reduced(**kw), get_config(arch).reduced(**kw)
    jparams = JTF.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.device_get(jparams), "cpu")
    jb, pb = _batch(cfg, 0, seq=seq, batch=1)
    (jtotal, _), jgrads = jax.value_and_grad(
        JTF.make_loss_fn(jcfg), has_aux=True)(jparams, jb)
    (total, _), grads = PTF.value_and_grad(PTF.make_loss_fn(cfg))(params, pb)
    # the forward is right in both packages
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    bad = [p for p, g in tree_flatten_with_paths(grads)
           if not torch.isfinite(g).all()]
    assert not bad
    assert float(grads["layers"]["mixer"]["A_log"].abs().max()) > 0
    # this input reaches the overflow: the reference's exp of the unmasked
    # decay exponents makes its gradient non-finite (ROADMAP §3)
    assert not all(np.isfinite(np.asarray(g)).all()
                   for g in jax.tree.leaves(jgrads))
