"""The port's VLM backbone (llava-next-34b) on the CPU against the JAX
package: the forward with patch embeddings over the first positions, the
loss and gradients with them, and the training launcher, whose batches now
carry the vision frontend's stand-in patches.

Parameters come from ``repro.models.transformer.init_params`` on the
reduced config (float32) and cross through ``interop.params_from_numpy``;
patches and tokens are made with numpy from a seed.  The forward is held to
2e-5, each gradient leaf to 1e-5 of its largest magnitude, losses over
steps to rtol 1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro.models import frontends as jax_frontends  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import frontends  # noqa: E402
from repro_torch.models import transformer as PTF  # noqa: E402
from repro_torch.tree import tree_flatten_with_paths  # noqa: E402

ARCH = "llava-next-34b"
TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = 1e-5
B, S, P = 2, 12, 4
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_config(ARCH).reduced(n_patches=P)
    cfg = get_config(ARCH).reduced(n_patches=P)
    jparams = JTF.init_params(jcfg, jax.random.PRNGKey(7))
    params = params_from_numpy(jax.device_get(jparams), "cpu")
    rng = np.random.default_rng(0)
    patches = 0.02 * rng.standard_normal((B, P, cfg.d_model),
                                         dtype=np.float32)
    tokens = rng.integers(1, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return jcfg, cfg, jparams, params, patches, tokens


def test_forward_with_patches_matches(setup):
    jcfg, cfg, jparams, params, patches, tokens = setup
    assert cfg.family == "vlm" and PTF.check_supported(cfg) == "attn"
    want, _, _ = JTF.forward(jparams, jnp.asarray(tokens), jcfg,
                             patch_embeds=jnp.asarray(patches))
    got, _, _ = PTF.forward(params, torch.from_numpy(tokens), cfg,
                            patch_embeds=torch.from_numpy(patches))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # tests/test_models.py's check: the patches reach the last position
    moved, _, _ = PTF.forward(params, torch.from_numpy(tokens), cfg,
                              patch_embeds=torch.from_numpy(patches + 1.0))
    assert not torch.allclose(moved[:, -1], got[:, -1])
    # the stand-in frontend: the reference's shapes and dtype
    full = get_config(ARCH)
    assert frontends.vision_patch_spec(full, 2) == ((2, 576, 7168),
                                                    torch.bfloat16)
    drawn = frontends.synth_patches(cfg, B, device="cpu")
    assert drawn.shape == (B, P, cfg.d_model) and drawn.dtype == cfg.cdtype


def test_loss_and_gradients_with_patches_match(setup):
    jcfg, cfg, jparams, params, patches, tokens = setup
    batch = {"tokens": tokens, "labels": tokens, "patch_embeds": patches}
    (jtotal, jm), jgrads = jax.jit(jax.value_and_grad(
        JTF.make_loss_fn(jcfg), has_aux=True))(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    (total, m), grads = PTF.value_and_grad(PTF.make_loss_fn(cfg))(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    want = dict(tree_flatten_with_paths(jax.device_get(jgrads)))
    got = tree_flatten_with_paths(grads)
    assert sorted(p for p, _ in got) == sorted(want)
    for path, g in got:
        w = np.asarray(want[path])
        err = np.abs(g.numpy() - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= GRAD_TOL, (path, err)


def test_launcher_trains_llava_as_the_jax_launcher(monkeypatch):
    """The training launcher on the CPU from the JAX launcher's parameter
    draw and patches: the same losses over 3 steps at rtol 1e-4."""
    argv = ["--arch", ARCH, "--reduced", "--steps", "3", "--batch", "2",
            "--seq", "16", "--log-every", "100"]
    cfg = get_config(ARCH).reduced()
    patches = 0.02 * np.random.default_rng(6).standard_normal(
        (2, cfg.n_patches, cfg.d_model), dtype=np.float32)
    monkeypatch.setattr(jax_frontends, "synth_patches",
                        lambda cfg, batch, seed=0: jnp.asarray(patches))
    monkeypatch.setattr(frontends, "synth_patches",
                        lambda cfg, batch, seed=0, device=None:
                        torch.as_tensor(patches, device=device))
    want = jax_train.main(argv)
    tree = jax.device_get(JTF.init_params(jax_config(ARCH).reduced(),
                                          jax.random.PRNGKey(0)))
    monkeypatch.setattr(PTF, "init_params",
                        lambda cfg, seed, device: params_from_numpy(tree,
                                                                    device))
    got = train_mod.main(argv + CPU)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)


def test_launcher_checkpoint_resume_exact(tmp_path):
    """A run resumed from the step-2 checkpoint replays the uninterrupted
    run's losses: the patches are the same at every step, as the
    reference's launcher draws them."""
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
    """The traced step gives the loop's step-0 loss: its patches are drawn
    as the loop draws them and cross to a worker as host tensors."""
    r = train_mod.main(["--arch", ARCH, "--reduced", "--steps", "1",
                        "--batch", "2", "--seq", "16", "--log-every", "100",
                        "--show-graph", "--backend", backend] + CPU)
    out = capsys.readouterr().out
    assert f"[{backend} backend" in out and "executed 4 tasks" in out
    traced = float(out.split("traced-driver step loss:")[1].split()[0])
    assert traced == pytest.approx(r["losses"][0], rel=1e-4)
