"""The port's LMs on the CPU against the JAX package: the Mamba1 LM
(falcon-mamba-7b) and the dense transformer (qwen2-7b: QKV bias and GQA;
qwen3-14b: qk_norm; granite-20b: MQA and the gelu MLP).

Parameters come from ``repro.models.transformer.init_params`` on the
reduced configs (float32 params and compute) and cross through
``repro_torch.interop.params_from_numpy``, so both packages compute with
the same numbers; inputs are made with numpy from a seed.  Tolerance
1e-4: both sides compute in float32 and differ only in summation order.
"""
import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.interop import params_from_numpy, tensor_to_numpy  # noqa: E402
from repro_torch.models import layers as pt_layers  # noqa: E402
from repro_torch.models import ssm as pt_ssm  # noqa: E402
from repro_torch.models import transformer as PTF  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "falcon-mamba-7b"


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jparams = JTF.init_params(jcfg, jax.random.PRNGKey(3))
    params = params_from_numpy(jax.device_get(jparams), "cpu")
    return jcfg, cfg, jparams, params


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _layer(tree, i):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_configs_are_the_references(arch):
    assert ARCHS == JAX_ARCHS
    for reduce in (False, True):
        jc, pc = jax_config(arch), get_config(arch)
        if reduce:
            jc, pc = jc.reduced(), pc.reduced()
        assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
        assert (pc.d_inner, pc.head_dim, pc.sub_quadratic) == \
            (jc.d_inner, jc.head_dim, jc.sub_quadratic)
        assert str(pc.pdtype) == f"torch.{jc.pdtype}"
        assert str(pc.cdtype) == f"torch.{jc.cdtype}"


def test_causal_conv_matches(setup):
    rng = np.random.default_rng(0)
    x, state = (rng.standard_normal(s, dtype=np.float32)
                for s in ((2, 7, 16), (2, 3, 16)))
    w = rng.standard_normal((4, 16), dtype=np.float32)
    b = rng.standard_normal((16,), dtype=np.float32)
    for st in (None, state):
        want, want_state = jax_ssm._causal_conv(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
            None if st is None else jnp.asarray(st))
        got, got_state = pt_ssm._causal_conv(
            *(torch.from_numpy(a) for a in (x, w, b)),
            None if st is None else torch.from_numpy(st))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(got_state.numpy(), np.asarray(want_state),
                                   **TOL)


@pytest.mark.parametrize("with_cache", [False, True])
def test_mamba1_block_matches(setup, with_cache):
    jcfg, cfg, jparams, params = setup
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, cfg.d_model), dtype=np.float32)
    jcache = cache = None
    if with_cache:
        conv = rng.standard_normal((2, 3, cfg.d_inner), dtype=np.float32)
        h = rng.standard_normal((2, cfg.d_inner, cfg.ssm_state),
                                dtype=np.float32)
        jcache = {"conv": jnp.asarray(conv), "h": jnp.asarray(h)}
        cache = {"conv": torch.from_numpy(conv), "h": torch.from_numpy(h)}
    want, want_cache = jax_ssm.mamba1_block(
        jax.tree.map(lambda a: a[1], jparams["layers"]["mixer"]),
        jnp.asarray(x), jcfg, cache=jcache)
    got, got_cache = pt_ssm.mamba1_block(
        _layer(params["layers"]["mixer"], 1), torch.from_numpy(x), cfg,
        cache=cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if with_cache:
        for k in ("conv", "h"):
            np.testing.assert_allclose(got_cache[k].numpy(),
                                       np.asarray(want_cache[k]), **TOL)
    else:
        assert got_cache is None and want_cache is None


def test_forward_logits_match(setup):
    jcfg, cfg, jparams, params = setup
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)
    want, _, _ = JTF.forward(jparams, jnp.asarray(toks), jcfg)
    got, cache, aux = PTF.forward(params, torch.from_numpy(toks), cfg)
    assert got.dtype == torch.float32 and cache is None
    assert tuple(got.shape) == (2, 40, cfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_and_decode_match_reference_and_forward(setup):
    """tests/test_models.py's prefill(S-1) + decode(1) consistency, run
    through the port, with the caches held against the reference's."""
    jcfg, cfg, jparams, params = setup
    S = 12
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, S)).astype(np.int32)
    full, _, _ = PTF.forward(params, torch.from_numpy(toks), cfg)

    prefill = PTF.make_prefill_step(cfg, max_len=S + 4)
    decode = PTF.make_decode_step(cfg)
    _, cache = prefill(params, torch.from_numpy(toks[:, :-1]))
    got, cache = decode(params, cache, torch.from_numpy(toks[:, -1:]))
    np.testing.assert_allclose(got.numpy(), full[:, -1].numpy(), **TOL)
    assert int(cache["pos"]) == S

    jcache = JTF.make_prefill_step(jcfg, max_len=S + 4)(
        jparams, jnp.asarray(toks[:, :-1]))[1]
    jgot, jcache = JTF.make_decode_step(jcfg)(jparams, jcache,
                                             jnp.asarray(toks[:, -1:]))
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), **TOL)
    for k in ("conv", "h"):
        assert cache["layers"][k].dtype == torch.float32
        np.testing.assert_allclose(cache["layers"][k].numpy(),
                                   np.asarray(jcache["layers"][k]), **TOL)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_params_from_numpy_round_trips_bit_for_bit(param_dtype):
    jcfg = jax_config(ARCH).reduced(param_dtype=param_dtype, n_layers=2)
    tree = jax.device_get(JTF.init_params(jcfg, jax.random.PRNGKey(0)))
    params = params_from_numpy(tree, "cpu")
    want = dict(_leaves(tree))
    got = dict(_leaves(params))
    assert got.keys() == want.keys()
    for name, a in want.items():
        t = got[name]
        assert str(t.dtype) == f"torch.{a.dtype}", name
        back = tensor_to_numpy(t)
        assert back.dtype == a.dtype and back.shape == a.shape, name
        assert back.tobytes() == np.ascontiguousarray(a).tobytes(), name


def test_init_params_gives_the_reference_tree_and_distributions():
    cfg = get_config(ARCH).reduced(d_model=256)
    jcfg = jax_config(ARCH).reduced(d_model=256)
    want = dict(_leaves(jax.eval_shape(
        lambda: JTF.init_params(jcfg, jax.random.PRNGKey(0)))))
    params = PTF.init_params(cfg, seed=11, device="cpu")
    got = dict(_leaves(params))
    assert got.keys() == want.keys()
    for name, s in want.items():
        assert tuple(got[name].shape) == s.shape, name
        assert str(got[name].dtype) == f"torch.{s.dtype}", name
    assert PTF.count_params(cfg) == sum(t.numel() for t in got.values())

    mixer = params["layers"]["mixer"]
    dt = torch.nn.functional.softplus(mixer["dt_bias"])
    assert 1e-3 * 0.999 <= float(dt.min()) and float(dt.max()) <= 0.1 * 1.001
    N = cfg.ssm_state
    assert torch.allclose(mixer["A_log"],
                          torch.log(torch.arange(1., N + 1)).expand(
                              mixer["A_log"].shape))
    assert torch.all(mixer["conv_b"] == 0) and torch.all(mixer["D"] == 1)
    assert torch.all(params["final_norm"]["scale"] == 1)
    for name, t, scale in [("tok", params["embed"]["tok"], 1.0),
                           ("unembed", params["embed"]["unembed"],
                            cfg.d_model ** -0.5),
                           ("in_proj", mixer["in_proj"], cfg.d_model ** -0.5),
                           ("out_proj", mixer["out_proj"],
                            cfg.d_inner ** -0.5),
                           ("conv_w", mixer["conv_w"], 4 ** -0.5)]:
        assert abs(float(t.std()) / scale - 1) < 0.1, name
        assert abs(float(t.mean())) < 0.1 * scale, name

    again = PTF.init_params(cfg, seed=11, device="cpu")
    other = PTF.init_params(cfg, seed=12, device="cpu")
    assert torch.equal(again["embed"]["tok"], params["embed"]["tok"])
    assert not torch.equal(other["embed"]["tok"], params["embed"]["tok"])
    # each parameter has its own stream: its values do not depend on others
    spec = PTF.param_specs(cfg)["layers"]["mixer"]["x_proj"]
    alone = pt_layers.init_param(spec, 11, torch.float32, torch.device("cpu"))
    assert torch.equal(alone, mixer["x_proj"])


def test_counts_match_the_reference():
    for cfg, jcfg in [(get_config(ARCH), jax_config(ARCH)),
                      (get_config(ARCH).reduced(), jax_config(ARCH).reduced())]:
        assert PTF.count_params(cfg) == JTF.count_params(jcfg)
        assert pt_ssm.ssm_flops_per_token(cfg, "mamba1") == \
            jax_ssm.ssm_flops_per_token(jcfg, "mamba1")
        assert pt_ssm.dt_rank(cfg) == jax_ssm.dt_rank(jcfg)
    assert PTF.count_params(get_config(ARCH)) == 7_272_665_088
    assert math.isclose(PTF.count_params(get_config(ARCH)) * 4 / 1e9, 29.09,
                        abs_tol=0.005)


@pytest.mark.parametrize("arch,item", [("llama4-maverick-400b-a17b",
                                        "§1 item 7"),
                                       ("dbrx-132b", "§1 item 7"),
                                       ("whisper-tiny", "§1 item 7")])
def test_other_plans_raise_naming_the_roadmap_item(arch, item):
    cfg = get_config(arch).reduced()
    with pytest.raises(NotImplementedError, match=item):
        PTF.init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        PTF.forward({}, torch.zeros((1, 2), dtype=torch.int32), cfg)


# --------------------------------------------------------------------------
# the dense transformer
# --------------------------------------------------------------------------

DENSE = ["qwen2-7b", "qwen3-14b", "granite-20b"]


def _carry(tree):
    """A numpy tree as the same tree for JAX and for the port."""
    return (jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu"))


@functools.lru_cache(maxsize=None)
def _dense_setup(arch):
    """(arch, jax cfg, port cfg, numpy tree) with random attention and MLP
    biases, which init_params makes zero."""
    jcfg = jax_config(arch).reduced()
    cfg = get_config(arch).reduced()
    tree = jax.device_get(JTF.init_params(jcfg, jax.random.PRNGKey(5)))
    rng = np.random.default_rng(6)
    for group in ("mixer", "ffn"):
        for name, a in tree["layers"][group].items():
            if name in ("bq", "bk", "bv", "bi", "bo"):
                tree["layers"][group][name] = 0.1 * rng.standard_normal(
                    a.shape, dtype=np.float32)
    return arch, jcfg, cfg, tree


@pytest.fixture(scope="module", params=DENSE)
def dense(request):
    return _dense_setup(request.param)


def _np_layer(tree, i):
    return {k: _np_layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches(theta):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 3, 32), dtype=np.float32)
    pos = rng.integers(0, 3000, (2, 5)).astype(np.int32)
    want = jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = pt_layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                               theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("masks", ["causal", "q_pos+kv_len", "none"])
def test_attention_scores_matches(grouped, masks):
    rng = np.random.default_rng(8)
    q = rng.standard_normal((2, 3, 4, 32), dtype=np.float32)
    k, v = (rng.standard_normal((2, 9, 2, 32), dtype=np.float32)
            for _ in range(2))
    kw = dict(causal=masks != "none", grouped=grouped)
    jkw, pkw = dict(kw), dict(kw)
    if masks == "q_pos+kv_len":
        q_pos = np.array([[4, 5, 6], [2, 3, 4]], np.int32)
        kv_len = np.array([7, 5], np.int32)
        jkw.update(q_pos=jnp.asarray(q_pos), kv_len=jnp.asarray(kv_len))
        pkw.update(q_pos=torch.from_numpy(q_pos),
                   kv_len=torch.from_numpy(kv_len))
    want = jax_layers.attention_scores(*(jnp.asarray(a) for a in (q, k, v)),
                                       **jkw)
    got = pt_layers.attention_scores(*(torch.from_numpy(a)
                                       for a in (q, k, v)), **pkw)
    assert tuple(got.shape) == (2, 3, 4, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _block_inputs(cfg, S, max_len, pos, int8, seed):
    """x, positions and (for max_len) a cache whose first ``pos`` slots are
    already written, as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, S, cfg.d_model), dtype=np.float32)
    positions = np.broadcast_to(np.arange(pos, pos + S, dtype=np.int32),
                                (2, S)).copy()
    if not max_len:
        return x, positions, None
    shape = (2, max_len, cfg.n_kv_heads, cfg.head_dim)
    if int8:
        cache = {n: rng.integers(-127, 128, shape).astype(np.int8)
                 for n in ("k", "v")}
        for n in ("k_scale", "v_scale"):
            cache[n] = (0.01 * rng.random(shape[:-1])).astype(jnp.bfloat16)
    else:
        cache = {n: rng.standard_normal(shape, dtype=np.float32)
                 for n in ("k", "v")}
    return x, positions, cache


@pytest.mark.parametrize("mode", ["no cache", "prefill", "decode",
                                  "int8 prefill", "int8 decode"])
def test_attention_block_matches(dense, mode):
    arch, jcfg, cfg, tree = dense
    int8 = mode.startswith("int8")
    if int8:
        jcfg = jcfg.reduced(kv_cache_dtype="int8")
        cfg = cfg.reduced(kv_cache_dtype="int8")
    S, pos = (1, 6) if mode.endswith("decode") else (9, 0)
    x, positions, cache = _block_inputs(
        cfg, S, 0 if mode == "no cache" else 16, pos, int8, seed=len(mode))
    jp, pp = _carry(_np_layer(tree["layers"]["mixer"], 2))
    jcache, pcache = _carry(cache) if cache is not None else (None, None)
    want, want_cache = jax_layers.attention_block(
        jp, jnp.asarray(x), jcfg, positions=jnp.asarray(positions),
        cache=jcache, cache_pos=jnp.int32(pos))
    got, got_cache = pt_layers.attention_block(
        pp, torch.from_numpy(x), cfg, positions=torch.from_numpy(positions),
        cache=pcache, cache_pos=pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if cache is None:
        assert got_cache is None and want_cache is None
        return
    assert got_cache.keys() == want_cache.keys()
    for name, a in want_cache.items():
        t = got_cache[name]
        assert str(t.dtype) == f"torch.{a.dtype}", name
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(a, np.float32), **TOL)
        # functional: the cache given is not written
        assert np.array_equal(tensor_to_numpy(pcache[name]), cache[name])


def test_attention_block_refuses_to_overrun_the_cache():
    _, _, cfg, tree = _dense_setup("qwen2-7b")
    x, positions, cache = _block_inputs(cfg, 1, 6, 6, False, seed=1)
    _, pp = _carry(_np_layer(tree["layers"]["mixer"], 0))
    with pytest.raises(ValueError, match="overruns"):
        pt_layers.attention_block(
            pp, torch.from_numpy(x), cfg,
            positions=torch.from_numpy(positions),
            cache=params_from_numpy(cache, "cpu"), cache_pos=6)


@pytest.mark.parametrize("arch", ["qwen2-7b", "granite-20b"])  # swiglu, gelu
def test_mlp_block_matches(arch):
    _, jcfg, cfg, tree = _dense_setup(arch)
    x = np.random.default_rng(9).standard_normal((2, 5, cfg.d_model),
                                                 dtype=np.float32)
    jp, pp = _carry(_np_layer(tree["layers"]["ffn"], 1))
    assert ("wi_gate" in pp) == (cfg.mlp_act == "swiglu")
    want = jax_layers.mlp_block(jp, jnp.asarray(x), jcfg)
    got = pt_layers.mlp_block(pp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dense_forward_logits_match(dense):
    _, jcfg, cfg, tree = dense
    jp, pp = _carry(tree)
    toks = np.random.default_rng(10).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    want, _, _ = JTF.forward(jp, jnp.asarray(toks), jcfg)
    got, cache, aux = PTF.forward(pp, torch.from_numpy(toks), cfg)
    assert got.dtype == torch.float32 and cache is None and float(aux) == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dense_prefill_and_decode_match(dense):
    """prefill(S-1) + decode(1) against the reference's steps and against
    the port's own full forward, with the caches held against the
    reference's.  (The int8 cache is held at the block level: through
    several layers a last-bit difference can move a value across an int8
    rounding boundary.)"""
    _, jcfg, cfg, tree = dense
    jp, pp = _carry(tree)
    S = 12
    toks = np.random.default_rng(11).integers(
        0, cfg.vocab_size, (2, S)).astype(np.int32)
    _, pcache = PTF.make_prefill_step(cfg, max_len=S + 4)(
        pp, torch.from_numpy(toks[:, :-1]))
    got, pcache = PTF.make_decode_step(cfg)(pp, pcache,
                                            torch.from_numpy(toks[:, -1:]))
    assert int(pcache["pos"]) == S
    _, jcache = JTF.make_prefill_step(jcfg, max_len=S + 4)(
        jp, jnp.asarray(toks[:, :-1]))
    want, jcache = JTF.make_decode_step(jcfg)(jp, jcache,
                                              jnp.asarray(toks[:, -1:]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name, a in jcache["layers"].items():
        t = pcache["layers"][name]
        assert str(t.dtype) == f"torch.{a.dtype}", name
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(a, np.float32), **TOL)
    full, _, _ = PTF.forward(pp, torch.from_numpy(toks), cfg)
    np.testing.assert_allclose(got.numpy(), full[:, -1].numpy(), **TOL)


def test_patch_embeds_override_the_first_embeddings(dense):
    _, jcfg, cfg, tree = dense
    jp, pp = _carry(tree)
    rng = np.random.default_rng(12)
    toks = rng.integers(0, cfg.vocab_size, (1, 10)).astype(np.int32)
    patches = rng.standard_normal((1, 3, cfg.d_model), dtype=np.float32)
    want, _, _ = JTF.forward(jp, jnp.asarray(toks), jcfg,
                             patch_embeds=jnp.asarray(patches))
    got, _, _ = PTF.forward(pp, torch.from_numpy(toks), cfg,
                            patch_embeds=torch.from_numpy(patches))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dense_init_params_gives_the_reference_tree(dense):
    arch, jcfg, cfg, _ = dense
    want = dict(_leaves(jax.eval_shape(
        lambda: JTF.init_params(jcfg, jax.random.PRNGKey(0)))))
    params = PTF.init_params(cfg, seed=1, device="cpu")
    got = dict(_leaves(params))
    assert got.keys() == want.keys()
    for name, s in want.items():
        assert tuple(got[name].shape) == s.shape, name
        assert str(got[name].dtype) == f"torch.{s.dtype}", name
    cache = PTF.init_cache(cfg, 2, 16, device="cpu")
    jcache = JTF.init_cache(jcfg, 2, 16)
    assert {k: tuple(v.shape) for k, v in cache["layers"].items()} == \
        {k: v.shape for k, v in jcache["layers"].items()}


@pytest.mark.parametrize("arch", DENSE)
def test_dense_counts_match_the_reference(arch):
    for reduce in (False, True):
        cfg, jcfg = get_config(arch), jax_config(arch)
        if reduce:
            cfg, jcfg = cfg.reduced(), jcfg.reduced()
        assert PTF.count_params(cfg) == JTF.count_params(jcfg)
    if arch == "qwen2-7b":
        assert PTF.count_params(get_config(arch)) == 7_615_616_512
