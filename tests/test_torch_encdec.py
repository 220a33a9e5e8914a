"""The port's encoder-decoder (whisper-tiny's backbone) on the CPU against
the JAX package: the parameter tree, ``encode``, ``cross_kv``,
``decoder_forward``, the loss and its gradients, three train steps,
prefill + decode, ``attention_block``'s cross-attention override and the
training launcher.

Parameters come from ``repro.models.encdec.init_params`` on the reduced
config in float32 and cross through ``interop.params_from_numpy``; frames
and tokens are made with numpy from a seed.  The forward is held to 2e-5,
each gradient leaf to 1e-5 of its largest magnitude, losses over steps to
rtol 1e-4: both sides compute in float32 and differ only in summation
order.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import steps as JST  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro.models import encdec as JED  # noqa: E402
from repro.models import frontends as jax_frontends  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro.optim.schedules import cosine_schedule as jax_cosine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMDataset  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import encdec as ED  # noqa: E402
from repro_torch.models import frontends  # noqa: E402
from repro_torch.models import layers as pt_layers  # noqa: E402
from repro_torch.models import transformer as PTF  # noqa: E402
from repro_torch.optim.schedules import cosine_schedule  # noqa: E402
from repro_torch.tree import tree_flatten_with_paths, tree_leaves  # noqa: E402

ARCH = "whisper-tiny"
F32 = dict(compute_dtype="float32", param_dtype="float32")
TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = 1e-5
B, S = 2, 12
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_config(ARCH).reduced(**F32)
    cfg = get_config(ARCH).reduced(**F32)
    jparams = JED.init_params(jcfg, jax.random.PRNGKey(3))
    params = params_from_numpy(jax.device_get(jparams), "cpu")
    return jcfg, cfg, jparams, params


def _inputs(cfg, seed=0, batch=B, seq=S):
    rng = np.random.default_rng(seed)
    frames = 0.02 * rng.standard_normal((batch, cfg.enc_seq, cfg.d_model),
                                        dtype=np.float32)
    tokens = rng.integers(1, cfg.vocab_size, (batch, seq)).astype(np.int32)
    return frames, tokens


def _shapes(tree):
    return {p: tuple(t.shape) for p, t in tree_flatten_with_paths(tree)}


def test_init_params_give_the_references_tree(setup):
    jcfg, cfg, _, _ = setup
    want = jax.eval_shape(lambda: JED.init_params(jcfg,
                                                  jax.random.PRNGKey(0)))
    params = ED.init_params(cfg, 0, "cpu")
    assert _shapes(params) == _shapes(want)
    assert all(t.dtype == torch.float32 for t in tree_leaves(params))
    assert ED.count_params(cfg) == sum(a.size for a in
                                       jax.tree.leaves(want))
    # the full-width config: the reference's count, without drawing it
    full = jax.eval_shape(lambda: JED.init_params(jax_config(ARCH),
                                                  jax.random.PRNGKey(0)))
    assert ED.count_params(get_config(ARCH)) == \
        sum(a.size for a in jax.tree.leaves(full)) == 40_199_040
    # the stand-in frontends: the reference's shapes and dtypes
    full = get_config(ARCH)
    assert frontends.audio_frame_spec(full, 3) == ((3, 1500, 384),
                                                   torch.bfloat16)
    frames = frontends.synth_frames(cfg, 2, device="cpu")
    assert frames.shape == (2, cfg.enc_seq, cfg.d_model)
    assert torch.equal(frames, frontends.synth_frames(cfg, 2, device="cpu"))
    assert 0.015 < float(frames.std()) < 0.025


def test_encode_cross_kv_and_decoder_forward_match(setup):
    jcfg, cfg, jparams, params = setup
    frames, tokens = _inputs(cfg)
    jenc = JED.encode(jparams, jnp.asarray(frames), jcfg)
    enc = ED.encode(params, torch.from_numpy(frames), cfg)
    np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), **TOL)
    jxkv = JED.cross_kv(jparams, jenc, jcfg)
    xkv = ED.cross_kv(params, enc, cfg)
    for k in ("k", "v"):
        assert xkv[k].shape == (cfg.n_layers, B, cfg.enc_seq,
                                cfg.n_kv_heads, cfg.head_dim)
        np.testing.assert_allclose(xkv[k].numpy(), np.asarray(jxkv[k]),
                                   **TOL)
    jlogits, _ = JED.decoder_forward(jparams, jnp.asarray(tokens), jxkv, jcfg)
    logits, cache = ED.decoder_forward(params, torch.from_numpy(tokens), xkv,
                                       cfg)
    assert cache is None and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)


def test_loss_and_gradients_match(setup):
    jcfg, cfg, jparams, params = setup
    frames, tokens = _inputs(cfg, seed=1, seq=S + 1)
    jb = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens),
          "labels": jnp.asarray(tokens)}
    pb = {k: torch.from_numpy(v) for k, v in
          {"frames": frames, "tokens": tokens, "labels": tokens}.items()}
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        JED.make_loss_fn(jcfg), has_aux=True))(jparams, jb)
    for impl in ("kernel", "ref"):
        (loss, m), grads = PTF.value_and_grad(ED.make_loss_fn(
            cfg, impl=impl))(params, pb)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        assert float(m["loss"]) == float(loss) and float(m["aux"]) == 0.0
        want = dict(tree_flatten_with_paths(jax.device_get(jgrads)))
        got = dict(tree_flatten_with_paths(grads))
        assert sorted(got) == sorted(want)
        for path, g in got.items():
            w = np.asarray(want[path])
            if path.endswith("/bk"):
                # without RoPE, q·bk shifts every key's score alike, which
                # the softmax ignores: the key bias's gradient is 0 in
                # exact arithmetic and rounding noise in either package,
                # so both must be that small beside the query bias's
                scale = np.abs(np.asarray(want[path[:-2] + "bq"])).max()
                assert max(np.abs(w).max(), g.abs().max()) \
                    <= GRAD_TOL * scale, (impl, path)
                continue
            err = np.abs(g.numpy() - w).max() / max(np.abs(w).max(), 1e-30)
            assert err <= GRAD_TOL, (impl, path, err)
    assert not any(t.requires_grad for t in tree_leaves(params))


def test_three_train_steps_match(setup):
    """launch/steps.py's train step dispatches to the encoder-decoder's
    loss and, with make_optimizer's AdamW, gives the reference's losses
    over three steps on the same frames and the data pipeline's batches."""
    jcfg, cfg, jparams, _ = setup
    # the step updates in place: a copy of the module's parameters
    params = params_from_numpy(jax.device_get(jparams), "cpu")
    frames, _ = _inputs(cfg, seed=2)
    jopt = JST.make_optimizer(jcfg, lr=jax_cosine(1e-2, 1, 3))
    opt = ST.make_optimizer(cfg, lr=cosine_schedule(1e-2, 1, 3))
    jstep = jax.jit(JST.make_train_step(jcfg, jopt, None))
    step = ST.make_train_step(cfg, opt)
    jstate, state = jopt.init(jparams), opt.init(params)
    jlosses, losses = [], []
    for s in range(3):
        b = SyntheticLMDataset(cfg.vocab_size, S, B, seed=1).batch_at(s)
        b["frames"] = frames
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {k: jnp.asarray(v) for k, v in b.items()})
        params, state, m = step(params, state,
                                {k: torch.from_numpy(v) for k, v in b.items()})
        jlosses.append(float(jm["total_loss"]))
        losses.append(float(m["total_loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[-1] < losses[0]


def test_prefill_and_decode_match_the_reference_and_the_full_pass(setup):
    """tests/test_models.py's check: a prefill of S - 1 tokens, then one
    decode step, meets the full pass's last position; both steps also meet
    the reference's prefill and decode."""
    jcfg, cfg, jparams, params = setup
    frames, tokens = _inputs(cfg, seed=3)
    jf, jt = jnp.asarray(frames), jnp.asarray(tokens)
    pf, pt = torch.from_numpy(frames), torch.from_numpy(tokens)
    jlast, jcache = JED.make_prefill_step(jcfg, max_len=S + 2)(
        jparams, jt[:, :-1], jf)
    jgot, _ = JED.make_decode_step(jcfg)(jparams, jcache, jt[:, -1:])
    last, cache = ED.make_prefill_step(cfg, max_len=S + 2)(
        params, pt[:, :-1], pf)
    assert int(cache["pos"]) == S - 1
    assert cache["layers"]["k"].shape == (cfg.n_layers, B, S + 2,
                                          cfg.n_kv_heads, cfg.head_dim)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(cache["layers"][k].numpy(),
                                   np.asarray(jcache["layers"][k]), **TOL)
        np.testing.assert_allclose(cache["xkv"][k].numpy(),
                                   np.asarray(jcache["xkv"][k]), **TOL)
    got, new = ED.make_decode_step(cfg)(params, cache, pt[:, -1:])
    assert int(new["pos"]) == S and int(cache["pos"]) == S - 1
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), **TOL)
    enc = ED.encode(params, pf, cfg)
    full, _ = ED.decoder_forward(params, pt, ED.cross_kv(params, enc, cfg),
                                 cfg)
    np.testing.assert_allclose(got.numpy(), full[:, -1].numpy(), **TOL)
    # init_cache: the reference's tree
    want = JED.init_cache(jcfg, B, 7)
    assert _shapes(ED.init_cache(cfg, B, 7, device="cpu")) == _shapes(want)


@pytest.mark.parametrize("arch,overrides", [
    ("whisper-tiny", F32),                            # biases, no RoPE
    ("qwen3-14b", {}),                                # qk_norm, RoPE, GQA
])
@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_attention_block_kv_override_matches(arch, overrides, impl):
    """Cross-attention of 5 queries over 9 given keys: no k/v projection,
    k_norm, RoPE or cache; bq and q_norm apply.  A decode step's one query
    at a later position attends over all 9 keys as well."""
    jcfg = jax_config(arch).reduced(**overrides)
    cfg = get_config(arch).reduced(**overrides)
    jp = jax_layers.init_attention(
        jax_layers.Builder(jcfg, jax.random.PRNGKey(4), mode="init"),
        "x", jcfg)
    if "bq" in jp:          # zero-initialised: give the biases values
        jp = dict(jp, bq=jp["bq"] + 0.1, bk=jp["bk"] - 0.2, bv=jp["bv"] + 1)
    p = params_from_numpy(jax.device_get(jp), "cpu")
    rng = np.random.default_rng(5)
    KH, hd = cfg.n_kv_heads, cfg.head_dim
    k, v = (rng.standard_normal((2, 9, KH, hd), dtype=np.float32)
            for _ in range(2))
    for Sq, pos0 in ((5, 0), (1, 6)):
        x = rng.standard_normal((2, Sq, cfg.d_model), dtype=np.float32)
        positions = np.broadcast_to(pos0 + np.arange(Sq), (2, Sq))
        want, wc = jax_layers.attention_block(
            jp, jnp.asarray(x), jcfg, positions=jnp.asarray(positions),
            kv_override=(jnp.asarray(k), jnp.asarray(v)), causal=False)
        got, gc = pt_layers.attention_block(
            p, torch.from_numpy(x), cfg,
            positions=torch.from_numpy(positions.copy()),
            kv_override=(torch.from_numpy(k), torch.from_numpy(v)),
            causal=False, impl=impl)
        assert wc is None and gc is None
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_transformer_refuses_and_serve_still_refuses():
    cfg = get_config(ARCH).reduced()
    with pytest.raises(NotImplementedError, match="models.encdec"):
        PTF.check_supported(cfg)
    with pytest.raises(ValueError, match="not an encoder-decoder"):
        ED.param_specs(get_config("qwen2-7b").reduced())
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="decoder-only archs"):
        serve.main(["--arch", ARCH, "--reduced"] + CPU)


def _same_frames(monkeypatch, cfg, batch):
    """Both launchers' frames: one numpy draw, float32 (the reduced
    config's compute type)."""
    frames = 0.02 * np.random.default_rng(6).standard_normal(
        (batch, cfg.enc_seq, cfg.d_model), dtype=np.float32)
    monkeypatch.setattr(jax_frontends, "synth_frames",
                        lambda cfg, batch, seed=0: jnp.asarray(frames))
    monkeypatch.setattr(frontends, "synth_frames",
                        lambda cfg, batch, seed=0, device=None:
                        torch.as_tensor(frames, device=device))


def test_launcher_trains_whisper_as_the_jax_launcher(monkeypatch):
    """The training launcher on the CPU from the JAX launcher's parameter
    draw and frames: the same losses over 3 steps at rtol 1e-4."""
    argv = ["--arch", ARCH, "--reduced", "--steps", "3", "--batch", "2",
            "--seq", "16", "--log-every", "100"]
    cfg = get_config(ARCH).reduced()
    _same_frames(monkeypatch, cfg, 2)
    want = jax_train.main(argv)
    tree = jax.device_get(JED.init_params(jax_config(ARCH).reduced(),
                                          jax.random.PRNGKey(0)))
    monkeypatch.setattr(ED, "init_params",
                        lambda cfg, seed, device: params_from_numpy(tree,
                                                                    device))
    got = train_mod.main(argv + CPU)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)


def test_launcher_checkpoint_resume_exact(tmp_path):
    """A run resumed from the step-2 checkpoint replays the uninterrupted
    run's losses."""
    base = ["--arch", ARCH, "--reduced", "--batch", "2", "--seq", "16",
            "--ckpt-every", "2", "--log-every", "100"] + CPU
    ck = str(tmp_path / "ck")
    train_mod.main(base + ["--ckpt-dir", ck, "--steps", "3"])
    full = train_mod.main(base + ["--ckpt-dir", str(tmp_path / "ref"),
                                  "--steps", "5"])
    resumed = train_mod.main(base + ["--ckpt-dir", ck, "--steps", "5",
                                     "--resume"])
    assert resumed["start_step"] == 3
    np.testing.assert_allclose(resumed["losses"], full["losses"][3:],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("backend", ["thread", "process"])
def test_launcher_show_graph_executes_on_backend(capsys, backend):
    """The traced step gives the loop's step-0 loss: its frames are drawn
    as the loop draws them and cross to a worker as host tensors."""
    r = train_mod.main(["--arch", ARCH, "--reduced", "--steps", "1",
                        "--batch", "2", "--seq", "16", "--log-every", "100",
                        "--show-graph", "--backend", backend] + CPU)
    out = capsys.readouterr().out
    assert f"[{backend} backend" in out and "executed 4 tasks" in out
    traced = float(out.split("traced-driver step loss:")[1].split()[0])
    assert traced == pytest.approx(r["losses"][0], rel=1e-4)


def test_chip_smoke_phase_14_cells():
    """chip_smoke.py's training cells: the parameter counts it checks are
    the cut configs' (the JAX package's counts too), and a step launches
    flash 12 times for whisper-tiny (no remat) and 8 for llava-next-34b
    (4 layers, forward and recompute), and its backward kernel 12 and 4
    times (one a forward that autograd keeps), all on the wgmma route."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model_module
    from repro_torch.models.config import cut_depth
    counts = {chip_smoke.ENCDEC_ARCH: (12, 12), chip_smoke.VLM_ARCH: (8, 4)}
    for arch, (per_step, backward) in counts.items():
        layers, n_params = chip_smoke.TRAIN_CELLS[arch][:2]
        cfg = cut_depth(get_config(arch), layers)
        M = ED if cfg.is_encoder_decoder else PTF
        assert M.count_params(cfg) == n_params
        assert model_module(cfg) is M
        assert chip_smoke._train_kernels(cfg) == {
            fa.flash_attention: per_step,
            fa.flash_attention_backward: backward}
        assert chip_smoke.expected_route(cfg) == "wgmma"
    jcfg = jax_config(chip_smoke.VLM_ARCH)
    jcfg = dataclasses.replace(jcfg, n_layers=chip_smoke.VLM_LAYERS,
                               layer_plan=jcfg.layer_plan[:4])
    assert JTF.count_params(jcfg) == chip_smoke.VLM_N_PARAMS
