"""The port's Mamba2 (SSD) blocks and the zamba2 hybrid on the CPU against
the JAX package.

Two reduced configs: zamba2-7b's own ``reduced()``, whose 4 layers hold no
shared-attention site (every 6th layer), so it is a pure ``mamba2`` plan,
and ``reduced(n_layers=4, shared_attn_every=2)``, the hybrid with sites
after layers 1 and 3, as the reference's ``tests/test_models.py`` builds
it.  Parameters come from ``repro.models.transformer.init_params`` and
cross through ``interop.params_from_numpy``; inputs are made with numpy
from a seed.  Tolerances: 1e-4 in float32 (both sides differ only in
summation order), 5e-2 with bf16 SSD operands; gradients 2e-5 of each
leaf's largest entry, as ``tests/test_torch_train.py`` holds them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMDataset  # noqa: E402
from repro_torch.interop import params_from_numpy, tensor_to_numpy  # noqa: E402
from repro_torch.kernels import flash_attention as pt_flash  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import ssm as pt_ssm  # noqa: E402
from repro_torch.models import transformer as PTF  # noqa: E402
from repro_torch.tree import tree_flatten_with_paths  # noqa: E402

ARCH = "zamba2-7b"
TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
GRAD_TOL = 2e-5
PLANS = {"mamba2": {}, "hybrid": {"n_layers": 4, "shared_attn_every": 2}}


@pytest.fixture(scope="module", params=sorted(PLANS))
def model(request):
    """(plan, jax cfg, port cfg, jax tree, port tree) of one reduced plan."""
    kw = PLANS[request.param]
    jcfg = jax_config(ARCH).reduced(**kw)
    cfg = get_config(ARCH).reduced(**kw)
    jparams = JTF.init_params(jcfg, jax.random.PRNGKey(3))
    return (request.param, jcfg, cfg, jparams,
            params_from_numpy(jax.device_get(jparams), "cpu"))


def _layer(tree, i):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


def test_reduced_plans_are_what_the_tests_claim(model):
    plan, jcfg, cfg, _, _ = model
    want = "mamba2" if plan == "mamba2" else "mamba2_shared"
    assert PTF.check_supported(cfg) == JTF._plan_kind(jcfg) == want
    assert PTF._n_shared_sites(cfg) == (0 if plan == "mamba2" else 2)


@pytest.mark.parametrize("S,chunk,with_h0,bf16", [
    (64, 16, False, False),      # four chunks from a zero state
    (64, 16, True, False),       # four chunks from a carried state
    (40, 16, True, False),       # 16 does not divide 40: one chunk of 40
    (1, 16, True, False),        # a decode step
    (64, 16, True, True),        # bf16 intra-chunk operands (ssd_bf16)
])
def test_ssd_chunked_matches(S, chunk, with_h0, bf16):
    rng = np.random.default_rng(S + chunk + with_h0 + 2 * bf16)
    B, H, P, N = 2, 4, 8, 16
    x = rng.standard_normal((B, S, H, P), dtype=np.float32)
    dt = rng.uniform(1e-3, 0.1, (B, S, H)).astype(np.float32)
    Bc, Cc = (rng.standard_normal((B, S, N), dtype=np.float32)
              for _ in range(2))
    A = -np.arange(1, H + 1, dtype=np.float32)
    h0 = (rng.standard_normal((B, H, P, N), dtype=np.float32)
          if with_h0 else None)
    want_y, want_h = jax_ssm.ssd_chunked(
        *(jnp.asarray(a) for a in (x, dt, Bc, Cc, A)),
        None if h0 is None else jnp.asarray(h0), chunk,
        io_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    got_y, got_h = pt_ssm.ssd_chunked(
        *(torch.from_numpy(a) for a in (x, dt, Bc, Cc, A)),
        None if h0 is None else torch.from_numpy(h0), chunk,
        io_dtype=torch.bfloat16 if bf16 else torch.float32)
    assert got_y.dtype == got_h.dtype == torch.float32
    assert tuple(got_y.shape) == (B, S, H, P)
    assert tuple(got_h.shape) == (B, H, P, N)
    tol = BF16_TOL if bf16 else TOL
    _close(got_y, want_y, tol)
    _close(got_h, want_h, tol)


def test_ssd_chunked_masks_the_exponent_before_exp():
    """A full-width-like chunk (256, A down to -112, dt 0.1) whose
    above-diagonal decay exponents overflow ``exp``.  The port's forward
    equals the reference's, and its gradients are finite.  (The
    reference's ``jnp.where(causal, exp(cum_q - cum_k), 0)`` is right
    forward, but ``exp``'s VJP multiplies the zero cotangent above the
    diagonal by ``inf``: its gradient with respect to dt is NaN at this
    input.  ROADMAP §3 records it; the port masks the exponent to ``-inf``
    first.)"""
    rng = np.random.default_rng(0)
    B, S, H, P, N = 1, 256, 8, 4, 4
    x = rng.standard_normal((B, S, H, P), dtype=np.float32)
    Bc, Cc = (rng.standard_normal((B, S, N), dtype=np.float32)
              for _ in range(2))
    dt = np.full((B, S, H), 0.1, np.float32)
    A = (-14.0 * np.arange(1, H + 1)).astype(np.float32)
    want_y, want_h = jax_ssm.ssd_chunked(
        *(jnp.asarray(a) for a in (x, dt, Bc, Cc, A)), None, 256)
    inputs = [torch.from_numpy(a).requires_grad_()
              for a in (x, dt, Bc, Cc, A)]
    got_y, got_h = pt_ssm.ssd_chunked(*inputs, None, 256)
    _close(got_y, want_y)
    _close(got_h, want_h)
    grads = torch.autograd.grad(got_y.sum() + got_h.sum(), inputs)
    for name, g in zip(("x", "dt", "B", "C", "A"), grads):
        assert torch.isfinite(g).all(), name
    assert grads[1].abs().max() > 0


@pytest.mark.parametrize("with_cache", [False, True])
def test_mamba2_block_matches(model, with_cache):
    _, jcfg, cfg, jparams, params = model
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, cfg.d_model), dtype=np.float32)
    jcache = cache = None
    if with_cache:
        conv_dim = cfg.d_inner + 2 * cfg.ssm_state
        conv = rng.standard_normal((2, cfg.ssm_conv - 1, conv_dim),
                                   dtype=np.float32)
        h = rng.standard_normal((2, cfg.n_ssm_heads, cfg.ssm_head_dim,
                                 cfg.ssm_state), dtype=np.float32)
        jcache = {"conv": jnp.asarray(conv), "h": jnp.asarray(h)}
        cache = {"conv": torch.from_numpy(conv), "h": torch.from_numpy(h)}
    want, want_cache = jax_ssm.mamba2_block(
        jax.tree.map(lambda a: a[1], jparams["layers"]["mixer"]),
        jnp.asarray(x), jcfg, cache=jcache)
    got, got_cache = pt_ssm.mamba2_block(
        _layer(params["layers"]["mixer"], 1), torch.from_numpy(x), cfg,
        cache=cache)
    _close(got, want)
    if not with_cache:
        assert got_cache is None and want_cache is None
        return
    assert got_cache.keys() == want_cache.keys()
    for k in ("conv", "h"):
        assert tuple(got_cache[k].shape) == want_cache[k].shape
        _close(got_cache[k], want_cache[k])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba2_decode_cache_is_the_references(model, dtype):
    _, jcfg, cfg, _, _ = model
    want = jax_ssm.mamba2_decode_cache(jcfg, 3, jnp.dtype(str(dtype)[6:]))
    got = pt_ssm.mamba2_decode_cache(cfg, 3, dtype)
    assert got.keys() == want.keys()
    for k in got:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype) == f"torch.{want[k].dtype}", k
        assert not got[k].any()
    assert got["h"].dtype == torch.float32


@pytest.mark.parametrize("S", [40, 64])      # one chunk of 40; two of 32
def test_forward_logits_match(model, S):
    _, jcfg, cfg, jparams, params = model
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, S)).astype(np.int32)
    want, _, _ = JTF.forward(jparams, jnp.asarray(toks), jcfg)
    got, cache, aux = PTF.forward(params, torch.from_numpy(toks), cfg)
    assert got.dtype == torch.float32 and cache is None
    assert tuple(got.shape) == (2, S, cfg.vocab_size) and float(aux) == 0.0
    _close(got, want)


def test_prefill_and_decode_match_reference_and_forward(model):
    """prefill(S-1) + decode(1) against the reference's steps, with every
    cache leaf (the shared sites' k and v included), and against the
    port's own full forward."""
    plan, jcfg, cfg, jparams, params = model
    S = 12
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, S)).astype(np.int32)
    _, cache = PTF.make_prefill_step(cfg, max_len=S + 4)(
        params, torch.from_numpy(toks[:, :-1]))
    got, cache = PTF.make_decode_step(cfg)(params, cache,
                                           torch.from_numpy(toks[:, -1:]))
    assert int(cache["pos"]) == S
    _, jcache = JTF.make_prefill_step(jcfg, max_len=S + 4)(
        jparams, jnp.asarray(toks[:, :-1]))
    want, jcache = JTF.make_decode_step(jcfg)(jparams, jcache,
                                              jnp.asarray(toks[:, -1:]))
    _close(got, want)
    assert sorted(cache) == sorted(jcache)
    assert ("shared" in cache) == (plan == "hybrid")
    for group in ("layers", "shared"):
        for k, a in jcache.get(group, {}).items():
            t = cache[group][k]
            assert tuple(t.shape) == a.shape, (group, k)
            assert str(t.dtype) == f"torch.{a.dtype}", (group, k)
            _close(t, a)
    full, _, _ = PTF.forward(params, torch.from_numpy(toks), cfg)
    _close(got, full[:, -1])


def test_init_params_and_cache_give_the_reference_trees(model):
    _, jcfg, cfg, jparams, _ = model
    want = dict(tree_flatten_with_paths(jax.eval_shape(
        lambda: JTF.init_params(jcfg, jax.random.PRNGKey(0)))))
    params = PTF.init_params(cfg, seed=1, device="cpu")
    got = dict(tree_flatten_with_paths(params))
    assert got.keys() == want.keys()
    for name, s in want.items():
        assert tuple(got[name].shape) == s.shape, name
        assert str(got[name].dtype) == f"torch.{s.dtype}", name
    assert PTF.count_params(cfg) == sum(t.numel() for t in got.values()) \
        == JTF.count_params(jcfg)
    mixer = params["layers"]["mixer"]
    H = cfg.n_ssm_heads
    assert torch.equal(mixer["A_log"], torch.log(torch.arange(
        1., H + 1)).expand(cfg.n_layers, H))
    assert torch.all(mixer["norm"] == 1) and torch.all(mixer["D"] == 1)
    dt = torch.nn.functional.softplus(mixer["dt_bias"])
    assert 1e-3 * 0.999 <= float(dt.min()) and float(dt.max()) <= 0.1 * 1.001
    jc = jax.eval_shape(lambda: JTF.init_cache(jcfg, 2, 16))
    pc = PTF.init_cache(cfg, 2, 16, device="cpu")
    want_c = dict(tree_flatten_with_paths(jc))
    got_c = dict(tree_flatten_with_paths(pc))
    assert got_c.keys() == want_c.keys()
    for name, s in want_c.items():
        assert tuple(got_c[name].shape) == s.shape, name
        assert str(got_c[name].dtype) == f"torch.{s.dtype}", name


def test_params_from_numpy_carries_the_hybrid_tree_bit_for_bit(model):
    _, _, _, jparams, params = model
    want = dict(tree_flatten_with_paths(jax.device_get(jparams)))
    got = dict(tree_flatten_with_paths(params))
    assert got.keys() == want.keys()
    for name, a in want.items():
        back = tensor_to_numpy(got[name])
        assert back.dtype == a.dtype and back.shape == a.shape, name
        assert back.tobytes() == np.ascontiguousarray(a).tobytes(), name


def test_full_width_counts_match_the_reference():
    cfg, jcfg = get_config(ARCH), jax_config(ARCH)
    assert PTF.check_supported(cfg) == "mamba2_shared"
    assert PTF._n_shared_sites(cfg) == 13
    assert PTF.count_params(cfg) == JTF.count_params(jcfg) == 6_751_130_832
    assert pt_ssm.ssm_flops_per_token(cfg, "mamba2") == \
        jax_ssm.ssm_flops_per_token(jcfg, "mamba2")
    specs = PTF.param_specs(cfg)
    assert {k for k in specs if k.startswith("shared")} == {
        "shared_attn", "shared_norm", "shared_mlp", "shared_norm2"}
    assert specs["shared_attn"]["wq"].shape == (3584, 32 * 112)


@pytest.fixture(scope="module")
def serve_runs():
    argv = ["--arch", ARCH, "--reduced", "--requests", "4", "--slots", "2",
            "--max-new", "8", "--show-graph", "--backend", "thread"]
    want = jax_serve.main(argv)
    tree = JTF.init_params(jax_config(ARCH).reduced(), jax.random.PRNGKey(0))
    params = params_from_numpy(jax.device_get(tree), "cpu")
    return want, serve.main(argv + ["--device", "cpu"], params=params)


def test_serve_launcher_tokens_equal_the_jax_launchers(serve_runs):
    want, got = serve_runs
    assert got["decode_steps"] == want["decode_steps"] == 28
    assert {r.rid: r.out for r in got["finished"]} == \
        {r.rid: r.out for r in want["finished"]}
    req0 = next(r for r in got["finished"] if r.rid == 0)
    assert got["traced_tokens"] == req0.out[:3]


def test_serve_launcher_draws_and_serves_zamba2_on_the_cpu():
    out = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--requests", "2", "--slots", "1", "--max-new", "3"])
    assert len(out["finished"]) == 2 and out["decode_steps"] == 4


def _batch(cfg):
    b = SyntheticLMDataset(cfg.vocab_size, 64, 2, seed=1).batch_at(0)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


@pytest.mark.parametrize("remat", ["selective", "none"])
def test_hybrid_loss_and_grads_match_the_references(remat, monkeypatch):
    """value_and_grad of the reduced hybrid (2 shared sites, 64 tokens: two
    SSD chunks) against ``jax.value_and_grad``.  The shared block's
    attention goes through the flash kernel's Function, once a site, and
    again in the recompute under remat."""
    kw = dict(PLANS["hybrid"], remat=remat)
    jcfg = jax_config(ARCH).reduced(**kw)
    cfg = get_config(ARCH).reduced(**kw)
    jparams = JTF.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.device_get(jparams), "cpu")
    jb, pb = _batch(cfg)
    (jtotal, _), jgrads = jax.value_and_grad(
        JTF.make_loss_fn(jcfg), has_aux=True)(jparams, jb)
    calls = []
    forward = pt_flash.FlashAttention.forward

    def counted(ctx, *args):
        calls.append(1)
        return forward(ctx, *args)
    monkeypatch.setattr(pt_flash.FlashAttention, "forward",
                        staticmethod(counted))
    (total, _), grads = PTF.value_and_grad(PTF.make_loss_fn(cfg))(params, pb)
    assert len(calls) == 2 * (2 if remat == "selective" else 1)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    want = dict(tree_flatten_with_paths(jax.device_get(jgrads)))
    got = tree_flatten_with_paths(grads)
    assert sorted(p for p, _ in got) == sorted(want)
    for path, g in got:
        w = np.asarray(want[path])
        assert np.isfinite(g.numpy()).all(), path
        err = np.abs(g.numpy() - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= GRAD_TOL, (path, err)


def test_train_launcher_trains_zamba2_on_the_cpu():
    r = train_mod.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                        "--steps", "3", "--batch", "2", "--seq", "16",
                        "--log-every", "100"])
    assert len(r["losses"]) == 3 and np.isfinite(r["losses"]).all()
